"""Failure detection, retries, and elastic recovery of a sharded index.

The counterpart of the JAX package's `parallel/elastic.py`:
  * `with_retries`: a build retried with escalating backoff;
  * `BuildRecord` / `BuildHistory`: every build attempt and a summary;
  * `DeviceHealthMonitor`: probes each mesh position with a tiny
    computation whose result is read back; `fail_device_ids` injects
    failures by POSITION, so on a mesh that repeats a card one position
    can fail alone;
  * `ElasticShardedIndex.heal`: shrink the mesh to the surviving positions
    and rebuild the index from its durability source (a host copy of the
    corpus, or a callable that re-reads it from storage).

A build either completes on every shard or raises, so elasticity works
between builds: detect, shrink, re-shard, rebuild.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence, Set

import numpy as np
import torch

from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

logger = logging.getLogger("cuvs_rag_tpu_torch.elastic")


@dataclasses.dataclass
class BuildRecord:
    """One build attempt."""

    family: str
    num_devices: int
    n_rows: int
    success: bool
    build_time_s: float
    attempt: int
    error: str = ""
    timestamp: float = 0.0


class BuildHistory:
    """Build bookkeeping: the attempts and their success summary."""

    def __init__(self):
        self.records: List[BuildRecord] = []

    def add(self, rec: BuildRecord) -> None:
        rec.timestamp = rec.timestamp or time.time()
        self.records.append(rec)

    def summary(self) -> dict:
        total = len(self.records)
        ok = sum(r.success for r in self.records)
        return {
            "total_builds": total,
            "successful_builds": ok,
            "success_rate": ok / total if total else 0.0,
            "avg_build_time_s": (
                float(np.mean([r.build_time_s for r in self.records
                               if r.success]))
                if ok else 0.0
            ),
        }


def with_retries(fn: Callable, max_retries: int = 2,
                 base_backoff_s: float = 0.5,
                 on_retry: Optional[Callable[[int, Exception], None]] = None):
    """fn(), retried up to `max_retries` times after a failure, sleeping
    base_backoff_s * (attempt + 1) between attempts; the last failure is
    raised."""
    last: Optional[Exception] = None
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — any failure is retried
            last = e
            if attempt < max_retries:
                delay = base_backoff_s * (attempt + 1)
                logger.warning("attempt %d failed (%s); retrying in %.1fs",
                               attempt, e, delay)
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(delay)
    raise last  # type: ignore[misc]


class DeviceHealthMonitor:
    """Probe mesh positions with a tiny computation; report survivors.

    `fail_device_ids` holds mesh POSITIONS reported as failed without a
    probe (the fault-injection seam)."""

    def __init__(self, fail_device_ids: Optional[Set[int]] = None):
        self.fail_device_ids = fail_device_ids or set()

    def probe(self, devices: Sequence[torch.device]) -> List[bool]:
        health = []
        for i, d in enumerate(devices):
            if i in self.fail_device_ids:
                health.append(False)
                continue
            try:
                # read the result back: a launch is acknowledged before it
                # runs, so only the value proves the device computed it
                v = (torch.ones(8, device=d) + 1.0)[0].item()
                if v != 2.0:
                    raise RuntimeError(f"probe returned {v}, expected 2.0")
                health.append(True)
            except Exception as e:  # noqa: BLE001 — a failed probe is data
                logger.error("mesh position %d (%s) failed its probe: %s",
                             i, d, e)
                health.append(False)
        return health

    def surviving_devices(self, devices: Sequence[torch.device]
                          ) -> List[torch.device]:
        return [d for d, ok in zip(devices, self.probe(devices)) if ok]


class ElasticShardedIndex:
    """A sharded index that can rebuild itself on a shrunken mesh.

    The durability source of `heal()` is a host copy of the corpus
    (`corpus_host`) or `corpus_source`, a callable re-read at every
    (re)build (e.g. an np.load(..., mmap_mode="r") of the persisted
    embeddings), so no second copy of the corpus stays in memory."""

    def __init__(self, family: str, params, corpus_host=None,
                 dmesh: Optional[DeviceMesh] = None,
                 monitor: Optional[DeviceHealthMonitor] = None,
                 max_retries: int = 2, corpus_source=None):
        if (corpus_host is None) == (corpus_source is None):
            raise ValueError(
                "pass exactly one of corpus_host (array) or corpus_source "
                "(callable -> array)")
        self.family = family
        self.params = params
        self._corpus_source = corpus_source
        self.corpus_host = corpus_host
        self._n_rows: Optional[int] = (
            len(corpus_host) if corpus_host is not None else None)
        self.monitor = monitor or DeviceHealthMonitor()
        self.history = BuildHistory()
        self.max_retries = max_retries
        self.dmesh = dmesh or DeviceMesh()
        self.index: Optional[psearch.ShardedIndex] = None
        self._build()

    def _corpus(self):
        """The corpus rows of a (re)build, read from corpus_source per call
        when one is given."""
        if self.corpus_host is not None:
            return self.corpus_host
        rows = self._corpus_source()
        self._n_rows = len(rows)
        return rows

    def _build(self) -> None:
        attempt_box = {"n": 0}

        def attempt():
            attempt_box["n"] += 1
            t0 = time.perf_counter()
            try:
                # inside the try: a corpus_source that fails to read is a
                # failed attempt like any other
                ix = psearch.build_sharded(self.family, self.params,
                                           self._corpus(), self.dmesh)
                for dev in set(ix.devices):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                self.history.add(BuildRecord(
                    family=self.family, num_devices=self.dmesh.num_devices,
                    n_rows=self._n_rows or 0, success=True,
                    build_time_s=time.perf_counter() - t0,
                    attempt=attempt_box["n"]))
                return ix
            except Exception as e:
                self.history.add(BuildRecord(
                    family=self.family, num_devices=self.dmesh.num_devices,
                    n_rows=self._n_rows or 0, success=False,
                    build_time_s=time.perf_counter() - t0,
                    attempt=attempt_box["n"],
                    error=f"{type(e).__name__}: {e}"))
                raise

        self.index = with_retries(attempt, max_retries=self.max_retries)

    def heal(self) -> bool:
        """Probe every mesh position; rebuild on the survivors if any
        failed. Returns True when a rebuild happened."""
        survivors = self.monitor.surviving_devices(self.dmesh.devices)
        if len(survivors) == self.dmesh.num_devices:
            return False
        if not survivors:
            raise RuntimeError("no surviving devices")
        logger.warning("device loss: %d -> %d positions; re-sharding and "
                       "rebuilding", self.dmesh.num_devices, len(survivors))
        self.dmesh = DeviceMesh(devices=survivors)
        self._build()
        return True

    def search(self, search_params, queries, k: int):
        if self.index is None:
            raise RuntimeError("the index has no successful build")
        return psearch.search_sharded(search_params, self.index, queries, k,
                                      self.dmesh)
