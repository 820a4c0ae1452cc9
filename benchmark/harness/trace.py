"""What a traced run records: the device's kernels and copies from
torch.profiler, the benchmark's own spans around its calls into the
program, and the program's counters; and the reductions every per-layer
reader shares (busy time as the union of intervals, kernel time by name,
idle gaps by what the host was doing).

Times are nanoseconds on the host's monotonic clock (`time.perf_counter_ns`,
CLOCK_MONOTONIC on Linux, the same in every process). Device events are
moved onto it by one marker kernel launched just after the profiler
starts: its recorded start, less the host time just before its launch.
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[int, int]


class Spans:
    """Named host intervals (ns), kept in memory, written out at the end of
    a traced run."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        self.items.append((name, int(start_ns), int(end_ns)))


class DeviceTrace:
    """torch.profiler over a window, CUDA activity only (kernels, copies,
    sets), on `devices`. Off (`enabled` False) it records nothing and costs
    nothing. After the window, `events` holds dicts name, dev, start, end
    (host ns), and `window` the (start, end) host ns of the traced
    window."""

    def __init__(self, enabled: bool, devices: Sequence[torch.device]):
        self.enabled = enabled
        self.devices = [d for d in devices if d.type == "cuda"]
        self.events: List[dict] = []
        self.window: Optional[Interval] = None
        self._prof = None
        self._marker_host = 0

    def start(self) -> None:
        if not self.enabled or not self.devices:
            self.window = (time.perf_counter_ns(), 0)
            return
        from torch.profiler import ProfilerActivity, profile

        for d in self.devices:
            torch.cuda.synchronize(d)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.cuda.device(self.devices[0]):
            torch.cuda.synchronize()
            self._marker_host = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.window = (time.perf_counter_ns(), 0)

    def stop(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)
        end = time.perf_counter_ns()
        self.window = (self.window[0], end)
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        raw = [e for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        marker = [e for e in raw if "sleep" in e.name() or "spin" in e.name()]
        offset = (marker[0].start_ns() - self._marker_host) if marker else 0
        skip = {id(e) for e in marker}
        w0, w1 = self.window
        for e in raw:
            s = e.start_ns() - offset
            t = s + e.duration_ns()
            if id(e) in skip or t <= w0 or s >= w1:
                continue
            self.events.append({"name": e.name(), "dev": e.device_index(),
                                "start": max(s, w0), "end": min(t, w1)})
        self._prof = None


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(events: Sequence[dict], dev: Optional[int] = None) -> int:
    """Nanoseconds in which at least one operation ran (on `dev`, or on
    any device)."""
    return sum(e - s for s, e in union(
        [(x["start"], x["end"]) for x in events
         if dev is None or x["dev"] == dev]))


def devices_of(events: Sequence[dict]) -> List[int]:
    return sorted({e["dev"] for e in events})


def kernel_time(events: Sequence[dict], names: Sequence[str],
                dev: Optional[int] = None) -> Tuple[float, Dict[str, int]]:
    """(seconds, launches by name) of the events whose name contains one of
    `names` (on `dev`, or on any device)."""
    total = 0
    count: Dict[str, int] = collections.Counter()
    for e in events:
        if dev is not None and e["dev"] != dev:
            continue
        for n in names:
            if n in e["name"]:
                total += e["end"] - e["start"]
                count[n] += 1
                break
    return total / 1e9, dict(count)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:80]


def top_ops(events: Sequence[dict], n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device operations that took most time."""
    tot: Dict[str, int] = collections.Counter()
    for e in events:
        tot[short_name(e["name"])] += e["end"] - e["start"]
    return [[k, v / 1e9] for k, v in tot.most_common(n)]


def _subtract(a: List[Interval], b: List[Interval]
              ) -> Tuple[List[Interval], int]:
    """(a less b, the length of a within b): a and b sorted, disjoint."""
    out, inside, j = [], 0, 0
    for s, e in a:
        t = s
        while j < len(b) and b[j][1] <= t:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            lo, hi = max(b[k][0], t), min(b[k][1], e)
            if lo > t:
                out.append((t, lo))
            if hi > lo:
                inside += hi - lo
            t = max(t, hi)
            k += 1
        if t < e:
            out.append((t, e))
    return out, inside


def idle_gaps(events: Sequence[dict], window: Interval,
              spans: Sequence[Tuple[str, int, int]], n: int = 10,
              dev: Optional[int] = None) -> List[list]:
    """[[what the host was doing, seconds], ...]: the device's idle time in
    the window (on `dev`, or on all devices together), credited to the
    benchmark's span names in the order they first appear in `spans` (a
    gap inside spans of two names goes to the first), "harness" where no
    span covers it."""
    busy = union([(e["start"], e["end"]) for e in events
                  if dev is None or e["dev"] == dev])
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    names: Dict[str, List[Interval]] = {}
    for name, s, e in spans:
        names.setdefault(name, []).append((s, e))
    by: Dict[str, int] = collections.Counter()
    for name, ivs in names.items():
        gaps, inside = _subtract(gaps, union(ivs))
        if inside:
            by[name] += inside
    left = sum(e - s for s, e in gaps)
    if left:
        by["harness"] += left
    return [[k, v / 1e9] for k, v in by.most_common(n)]


def write_record(path: Path, record: dict) -> None:
    """The traced run's spans and summaries, as JSON under the checkout."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record))


def idle_share(rec: dict) -> Optional[float]:
    """1 - busy / window, the mean over the record's cards; None where the
    trace holds no device operation."""
    events, (w0, w1) = rec["events"], rec["window"]
    if not events or w1 <= w0:
        return None
    cards = rec.get("cards") or devices_of(events)
    return sum(1.0 - busy_ns(events, c) / (w1 - w0) for c in cards) \
        / len(cards)
