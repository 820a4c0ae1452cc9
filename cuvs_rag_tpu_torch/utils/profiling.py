"""Tracing and profiling: wall-clock spans, torch.profiler traces, device
annotations and per-call cost numbers.

The counterpart of the JAX package's `utils/profiling.py`:
  * `drain`: wait for the device work queued before a tensor is read
    (torch.cuda.synchronize on its device; nothing on the CPU)
  * `Timer`: structured wall-clock spans with a registry
  * `trace`: a torch.profiler trace of the CPU and the card, written as a
    Chrome trace (open with Perfetto or chrome://tracing)
  * `annotate`: a named range (torch.profiler.record_function) that shows
    up in the trace's timeline
  * `compiled_stats`: flops, bytes accessed and peak device memory of one
    call
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor in a tensor, a (nested) tuple / list / dict, or an
    index dataclass's fields."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def drain(x) -> None:
    """Wait until the work queued on the device of `x` (a torch.device, a
    tensor, a tuple of them or an index) has finished:
    torch.cuda.synchronize on that device. Host tensors, and values
    holding no tensor, need no wait."""
    dev = x if isinstance(x, torch.device) else getattr(
        _first_tensor(x), "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_seconds(fn, iters: int, warmup: int = 1) -> List[float]:
    """Seconds of each of `iters` calls of fn(), after `warmup` calls.

    Where fn's result lies on a card, each call is timed by CUDA events
    around it on the current stream (the device time from its first
    launch to its last, host gaps between them included); on the CPU,
    where a call returns with its work done, by the host clock. fn must
    return tensors (a search's (distances, ids))."""
    out = None
    for _ in range(warmup):
        out = fn()
    probe = _first_tensor(out if warmup else fn())
    if probe is None or probe.device.type != "cuda":
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return ts
    with torch.cuda.device(probe.device):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda.synchronize()
        for start, stop in events:
            start.record()
            fn()
            stop.record()
        torch.cuda.synchronize()
    return [start.elapsed_time(stop) / 1e3 for start, stop in events]


@dataclasses.dataclass
class Span:
    name: str
    seconds: float
    t_start: float


class Timer:
    """Span registry: `with timer.span('build'): ...`; `timer.summary()`."""

    def __init__(self):
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, block_on=None) -> Iterator[None]:
        """Time the block; `block_on` (tensors) is drained before the span
        ends, so device work launched inside it is counted."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                drain(block_on)
            self.spans.append(Span(name, time.perf_counter() - t0, t0))

    def summary(self) -> Dict[str, Dict[str, float]]:
        groups: Dict[str, List[float]] = defaultdict(list)
        for s in self.spans:
            groups[s.name].append(s.seconds)
        return {
            name: {
                "count": len(v),
                "total_s": sum(v),
                "mean_s": sum(v) / len(v),
                "max_s": max(v),
            }
            for name, v in groups.items()
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block with torch.profiler (the CPU, and the card where
    there is one) and write `{log_dir}/trace.json`, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in the profiler's timeline (little cost outside a
    trace)."""
    return torch.profiler.record_function(name)


def compiled_stats(fn, *args, **kwargs) -> Dict[str, Optional[float]]:
    """Run fn(*args, **kwargs) once and report its cost numbers:

    * flops: the floating-point operations of the PyTorch operators it ran
      (torch.utils.flop_counter.FlopCounterMode). The port's hand kernels
      are launched through ctypes, out of that counter's sight: a call that
      ran only hand kernels (and operators it has no formula for) reports
      None, not 0.
    * bytes_accessed: None (no counter sees the bytes a CUDA kernel moves;
      the smoke computes its bounds from the shapes).
    * peak_memory_bytes: how far torch.cuda.max_memory_allocated rose over
      the call on the device of its first tensor argument; None on the
      CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = _first_tensor([list(args), kwargs])
    on_card = dev is not None and dev.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev.device)
        base = torch.cuda.memory_allocated(dev.device)
        torch.cuda.reset_peak_memory_stats(dev.device)
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    flops = counter.get_total_flops()
    peak = None
    if on_card:
        drain(out)
        peak = torch.cuda.max_memory_allocated(dev.device) - base
    return {
        "flops": float(flops) if flops else None,
        "bytes_accessed": None,
        "peak_memory_bytes": peak,
    }
