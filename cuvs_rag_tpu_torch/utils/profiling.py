"""Tracing and profiling: the process's span recorder, torch.profiler
traces and per-call cost numbers.

The counterpart of the JAX package's `utils/profiling.py`:
  * `drain`: wait for the device work queued before a tensor is read
    (torch.cuda.synchronize on its device; nothing on the CPU)
  * `span`: a named host interval of the program (`with span("search",
    queries=100): ...`), kept by the process's recorder with its parent,
    its request and its thread; `spans`, `clear` and `summary` read it
  * `trace`: a torch.profiler trace of the CPU and the card, written as a
    Chrome trace (open with Perfetto or chrome://tracing), the recorded
    spans beside the kernels
  * `call_seconds`, `compiled_stats`: the cost numbers of one call

The recorder is on while a torch.profiler session runs in the process, and
after `record_spans(True)`. Off, a span site checks two flags and enters a
shared no-op context. Spans are stamped on `time.perf_counter_ns`
(CLOCK_MONOTONIC), never synchronise the device, and past `MAX_SPANS` are
counted in `trace.spans_dropped` instead of kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


MAX_SPANS = 1 << 20  # spans kept in memory; later ones are counted

_record = False
_spans: List[tuple] = []
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans
FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "request", "thread",
          "attrs")
ATTRS = ("family", "placement", "queries", "position", "device", "kernel")


def record_spans(on: bool = True) -> bool:
    """Record spans from now on (or not); returns the previous setting. A
    torch.profiler session turns the recorder on while it runs, whatever
    this says."""
    global _record
    before, _record = _record, bool(on)
    return before


def recording() -> bool:
    """Whether a span opened now is recorded."""
    return _record or _autograd_profiler._is_profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns")

    def __init__(self, name: str, attrs: tuple):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.request = up.request if up is not None else next(_requests)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if len(_spans) < MAX_SPANS:
            _spans.append((self.id, self.name, self.start_ns, end_ns,
                           self.parent, self.request, threading.get_ident(),
                           self.attrs))
        else:
            from cuvs_rag_tpu_torch.utils.metrics import default_registry

            default_registry.inc("trace.spans_dropped")
        return False


def span(name: str, *, family=None, placement=None, queries=None,
         position=None, device=None, kernel=None):
    """A context that records the block as a span `name` with the attrs
    given (ATTRS: small numbers or strings) while the recorder is on, and
    does nothing while it is off. The first span a thread opens starts a
    request; the spans inside it share its request id and name their
    parent. The attrs are named parameters, not **attrs, so that a site
    builds no dict while the recorder is off."""
    if _record or _autograd_profiler._is_profiler_enabled:
        return _Span(name, (family, placement, queries, position, device,
                            kernel))
    return _NO_SPAN


def spans() -> List[dict]:
    """The recorded spans in the order they ended, each a dict of FIELDS
    (times in perf_counter ns; parent None at a request's top; attrs the
    ATTRS given)."""
    out = []
    for s in list(_spans):
        d = dict(zip(FIELDS, s))
        d["attrs"] = {k: v for k, v in zip(ATTRS, s[7]) if v is not None}
        out.append(d)
    return out


def clear() -> None:
    """Forget every recorded span."""
    _spans.clear()


def summary(items: Optional[List[dict]] = None
            ) -> Dict[str, Dict[str, float]]:
    """{name: count, total_s, self_s, mean_s, max_s} over `items` (the
    recorded spans by default). A span's self time is its time less that
    of the spans directly inside it."""
    items = spans() if items is None else items
    inner: Dict[int, int] = defaultdict(int)
    for s in items:
        if s["parent"] is not None:
            inner[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: Dict[str, Dict[str, float]] = {}
    for s in items:
        ns = s["end_ns"] - s["start_ns"]
        g = out.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0, "max_s": 0.0})
        g["count"] += 1
        g["total_s"] += ns / 1e9
        g["self_s"] += (ns - inner.get(s["id"], 0)) / 1e9
        g["max_s"] = max(g["max_s"], ns / 1e9)
    for g in out.values():
        g["mean_s"] = g["total_s"] / g["count"]
    return out


_CLOCK = "profiling.clock"  # markers that tie the two clocks


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block with torch.profiler (the CPU, and the card where
    there is one) and write `{log_dir}/trace.json`, a Chrome trace that
    holds the spans recorded in the block beside the kernels, on a track
    of their own a thread."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(2):  # the second marker, past the first's set-up
            t0 = time.perf_counter_ns()
            with record_function(_CLOCK):
                pass
            t1 = time.perf_counter_ns()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    clock = [e for e in events if e.get("name") == _CLOCK]
    if clock:  # trace us = perf_counter ns / 1e3 + shift, centre on centre
        last = clock[-1]
        shift = float(last["ts"]) + float(last.get("dur", 0)) / 2 \
            - (t0 + t1) / 2e3
        for s in spans():
            if s["start_ns"] >= t0:
                events.append({
                    "ph": "X", "cat": "span", "name": s["name"],
                    "pid": "program spans", "tid": s["thread"],
                    "ts": s["start_ns"] / 1e3 + shift,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": dict(s["attrs"], request=s["request"],
                                 parent=s["parent"], id=s["id"])})
    with open(path, "w") as f:
        json.dump(doc, f)


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
