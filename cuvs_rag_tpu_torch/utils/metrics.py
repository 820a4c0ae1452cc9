"""Lightweight metrics registry: counters, gauges, latency histograms.

The observability layer the reference approximated with scattered prints
and per-GPU logging prefixes (SURVEY.md §5 'Metrics / logging'): structured,
queryable, and exportable. Used by the RAG pipeline to track served
queries/latency and by the elastic layer for build outcomes.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import defaultdict
from typing import Dict, List


@dataclasses.dataclass
class HistogramSnapshot:
    count: int
    mean: float
    p50: float
    p95: float
    p99: float
    max: float


class _Histogram:
    """Fixed-budget reservoir histogram (exact quantiles up to `cap` samples,
    then decimated)."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = max(self.max, v)
        if len(self.values) >= self.cap:
            self.values = self.values[::2]
        self.values.append(v)

    def snapshot(self) -> HistogramSnapshot:
        if not self.values:
            return HistogramSnapshot(0, 0.0, 0.0, 0.0, 0.0, 0.0)
        s = sorted(self.values)

        def q(p):
            return s[min(len(s) - 1, int(p * len(s)))]

        return HistogramSnapshot(
            count=self.count,
            mean=self.total / self.count,
            p50=q(0.50), p95=q(0.95), p99=q(0.99),
            max=self.max,
        )


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = _Histogram()
            self._hists[name].observe(value)

    def time_block(self, name: str):
        registry = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.observe(name, time.perf_counter() - self.t0)

        return _Ctx()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: dataclasses.asdict(h.snapshot())
                    for k, h in self._hists.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# process-global default registry
default_registry = MetricsRegistry()
