"""Device mesh — the positions a sharded or replicated index spreads over.

The counterpart of the JAX package's `parallel/mesh.py`. There a
`DeviceMesh` wraps a 1-D `jax.sharding.Mesh` and one SPMD program runs over
it; here it is an ordered list of `torch.device`s, one per mesh position,
and the sharded paths (parallel/search.py) launch each position's work on
that position's device and its own CUDA stream, in one process.

A mesh may name one device more than once: `["cpu"] * 8` stands in for
eight devices in the CPU tests, and `["cuda:0"] * 4` puts four shards on
one card, each with its own stream. With no devices, the mesh is every
visible CUDA device; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from cuvs_rag_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """One mesh position's device and its memory (None where the device
    reports none, as the CPU)."""

    index: int
    platform: str
    kind: str
    memory_limit_bytes: Optional[int]
    memory_in_use_bytes: Optional[int]

    @property
    def memory_free_bytes(self) -> Optional[int]:
        if self.memory_limit_bytes is None or self.memory_in_use_bytes is None:
            return None
        return self.memory_limit_bytes - self.memory_in_use_bytes


def _normalize(device) -> torch.device:
    """A CUDA device always carries its index, so two spellings of one card
    compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_info(i: int, dev: torch.device) -> DeviceInfo:
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        return DeviceInfo(index=i, platform="gpu",
                          kind=torch.cuda.get_device_name(dev),
                          memory_limit_bytes=total,
                          memory_in_use_bytes=total - free)
    return DeviceInfo(index=i, platform=dev.type, kind=dev.type,
                      memory_limit_bytes=None, memory_in_use_bytes=None)


class DeviceMesh:
    """A 1-D mesh over the corpus-shard axis: `devices[i]` holds shard i.

    `validate_device_index`, `device_infos`, `memory_info` and
    `split_sizes` follow the JAX package's mesh. `stream(i)` is position
    i's own CUDA stream (None on the CPU): positions that share a card
    launch on separate streams."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "no CUDA device is visible; name the mesh's devices "
                    "(e.g. DeviceMesh(['cpu'] * 8)) to run on the CPU")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices: List[torch.device] = [_normalize(d) for d in devices]
        if not self.devices:
            raise RuntimeError("a device mesh needs at least one device")
        self._streams: Dict[int, torch.cuda.Stream] = {}
        # the daemon's dispatcher threads may make a position's first
        # search at once: one stream a position, made under this lock
        self._streams_lock = threading.Lock()

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device that gathers and merges the shards' candidates."""
        return self.devices[0]

    def validate_device_index(self, index: int) -> bool:
        return 0 <= index < self.num_devices

    def device_infos(self) -> List[DeviceInfo]:
        return [_device_info(i, d) for i, d in enumerate(self.devices)]

    def memory_info(self) -> Dict[int, DeviceInfo]:
        return {i: info for i, info in enumerate(self.device_infos())}

    def stream(self, i: int) -> Optional[torch.cuda.Stream]:
        """Position i's CUDA stream, made at first use; None on the CPU."""
        dev = self.devices[i]
        if dev.type != "cuda":
            return None
        with self._streams_lock:
            if i not in self._streams:
                self._streams[i] = torch.cuda.Stream(device=dev)
            return self._streams[i]

    def fan_out(self, work: Callable[[int], Tuple],
                positions: Iterable[int]) -> List[Tuple]:
        """work(i) -> a tuple of tensors, for each position i, launched on
        position i's device and stream; returns each position's tensors on
        the first device, ready for the current stream there.

        Each side stream first waits for its device's current stream (where
        the inputs were made); the current stream waits for every side
        stream before it reads their outputs, and each output is recorded
        on the stream that reads it, so the caching allocator cannot hand
        its memory out early. On the CPU the positions run in turn. Each
        work(i) is the span `fan_out.position` (position, device), the
        waits and copies to the first device the span `fan_out.join`."""
        cuda = self.first.type == "cuda"
        launched = []
        for i in positions:
            dev = self.devices[i]
            with profiling.span("fan_out.position", position=i,
                                device=dev.index):
                if cuda:
                    side = self.stream(i)
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side):
                        launched.append((i, side, work(i)))
                else:
                    launched.append((i, None, work(i)))
        outs = []
        with profiling.span("fan_out.join"):
            for i, side, out in launched:
                if side is not None:
                    reader = torch.cuda.current_stream(self.devices[i])
                    reader.wait_stream(side)
                    for t in out:
                        t.record_stream(reader)
                outs.append(tuple(t.to(self.first) for t in out))
        return outs

    def split_sizes(self, total: int, strategy: str = "even") -> List[int]:
        """How many rows each position owns. 'even': the remainder goes to
        the first positions. 'memory_based': rows in proportion to each
        position's free device memory (equal where it reports none, and on
        positions that share a device)."""
        s = self.num_devices
        if strategy == "even":
            base, rem = divmod(total, s)
            return [base + (1 if i < rem else 0) for i in range(s)]
        if strategy == "memory_based":
            frees = [(info.memory_free_bytes or 1)
                     for info in self.device_infos()]
            tot = sum(frees)
            sizes = [int(total * f / tot) for f in frees]
            sizes[-1] += total - sum(sizes)
            return sizes
        raise ValueError(f"unknown strategy {strategy!r}")
