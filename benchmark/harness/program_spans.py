"""The program's own spans in a traced run's window, and the device's
events pinned to them.

The port records spans (`cuvs_rag_tpu_torch/utils/profiling.span`) while a
torch.profiler session runs in its process, as it does through a traced
run's window (`trace.DeviceTrace`): `search` around a request, `flat.search`
/ `ivf_flat.search`, `ivf_flat.probe`, `fan_out.position` / `fan_out.join`
around the replicas' launches and their gather, and `kernel.launch` around
the ctypes call that launches K1 or K4. The per-layer readers run after the
driver in the same process and read them here; a program without the
recorder gives None, and the readers then report nothing.

Pinning. The trace places device events on the host clock by one marker at
the window's start. A kernel cannot start before the call that launched it
began, so on each card every K1 / K4 record is matched to its
`kernel.launch` span (in order where the counts agree; else each to the
latest launch before it, on the clock the first pairs correct), lag =
kernel start - launch start, and the events are moved by a correction
that runs piecewise linear through each second's least lag, lowered where
a kernel between two knots would start before its launch. What is left is
the card's launch latency, a few microseconds. The raw lags of the
window's first and last seconds are logged, so that the marker's
alignment is measured rather than assumed.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness import trace

LAUNCH = "kernel.launch"
# the kernel a launch span's call starts first, by the span's `kernel`
SCANS = {"K1": ("exact_scan",), "K4": ("ivf_ring_kernel", "ivf_scan_kernel")}
SECOND = 1_000_000_000
SLACK = 100_000  # ns a lag may fall below the running offset when matching

_last: dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def in_window(rec: dict) -> Optional[List[dict]]:
    """The program's recorded spans that lie in the record's window (dicts
    of utils/profiling.FIELDS), or None where the program has no recorder."""
    memo = _memo(rec)
    if "spans" not in memo:
        try:
            from cuvs_rag_tpu_torch.utils import profiling

            recorded = profiling.spans()
        except (ImportError, AttributeError):
            log("program spans: the program records none (no span recorder)")
            recorded = None
        w0, w1 = rec["window"]
        memo["spans"] = None if recorded is None else [
            s for s in recorded if w0 <= s["start_ns"] and s["end_ns"] <= w1]
    return memo["spans"]


def _memo(rec: dict) -> dict:
    """What this module worked out of one record (the readers of a run
    share it)."""
    if _last.get("rec") is not rec:
        _last.clear()
        _last["rec"] = rec
    return _last


def named(rec: dict, name: str, **attrs) -> Optional[List[dict]]:
    """The window's spans called `name` whose attrs hold `attrs`; None
    (logged) where there is none."""
    spans = in_window(rec)
    if spans is None:
        return None
    out = [s for s in spans if s["name"] == name and all(
        s["attrs"].get(k) == v for k, v in attrs.items())]
    if not out:
        log(f"program spans: no {name} {attrs or ''} span in the window")
        return None
    return out


class Correction:
    """c(t): ns to take off a device time t (raw, on the trace's host
    clock). Linear between knots (t, least lag of a second) and on past
    the ends along the first and last stretch (constant with one knot);
    each stretch lowered by `drop` where a pair falls below it."""

    def __init__(self, knots: Sequence[Tuple[int, int]]):
        self.xs = [t for t, _ in knots]
        self.ys = [lag for _, lag in knots]
        self.drop = [0] * (len(knots) + 1)

    def _line(self, t: int, r: int) -> float:
        xs, ys = self.xs, self.ys
        if len(xs) == 1:
            return ys[0]
        a = min(max(r, 1), len(xs) - 1)  # the stretch xs[a - 1] .. xs[a]
        f = (t - xs[a - 1]) / (xs[a] - xs[a - 1])
        return ys[a - 1] + f * (ys[a] - ys[a - 1])

    def lower_to(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Lower each stretch so that no paired kernel starts before its
        launch: c(k) <= k - l for every (l, k)."""
        for l, k in pairs:
            r = bisect.bisect_right(self.xs, k)
            over = self._line(k, r) - (k - l)
            if over > self.drop[r]:
                self.drop[r] = over

    def __call__(self, t: int) -> float:
        r = bisect.bisect_right(self.xs, t)
        return self._line(t, r) - self.drop[r]


def match(launches: Sequence[int], kernels: Sequence[int]
          ) -> Tuple[List[Tuple[int, int]], str]:
    """[(launch start, kernel start)] of one card, both sorted, and how
    they were matched. Equal counts pair in order. Otherwise (the profiler
    dropped kernel records) the first pairs in order give an offset (a
    dropped record only raises an ordered pair's lag), and each kernel
    takes the latest launch not after its start less the offset, which
    follows the least lag of each second as the clocks drift."""
    if len(launches) == len(kernels):
        return list(zip(launches, kernels)), "in order"
    n0 = min(len(launches), len(kernels), 64)
    if not n0:
        return [], "none"
    off = min(k - l for l, k in zip(launches[:n0], kernels[:n0]))
    pairs, i, best, since = [], 0, None, kernels[0]
    for k in kernels:
        j = bisect.bisect_right(launches, k - off + SLACK, i) - 1
        if j < i:
            continue
        lag = k - launches[j]
        pairs.append((launches[j], k))
        i = j + 1
        best = lag if best is None else min(best, lag)
        off = min(off, lag)
        if k - since >= SECOND:
            off, best, since = best, None, k
    return pairs, "by the latest launch before"


def knots(pairs: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """(kernel start, lag) of the least lag in each second of the pairs."""
    out: Dict[int, Tuple[int, int]] = {}
    t0 = pairs[0][1]
    for l, k in pairs:
        sec = (k - t0) // SECOND
        if sec not in out or k - l < out[sec][1]:
            out[sec] = (k, k - l)
    return [out[s] for s in sorted(out)]


def _is_scan(name: str, kernel: str) -> bool:
    return any(n in name for n in SCANS.get(kernel, ()))


def pins(rec: dict) -> Optional[dict]:
    """{card: Correction} for each card whose K1 / K4 records pair with
    launch spans, and {"events": pinned events, "late": kernels that start
    before their launch after pinning}; None where no card pairs. Logs
    each card's raw lag in the first and last second."""
    memo = _memo(rec)
    if "pins" not in memo:
        spans = in_window(rec)
        memo["pins"] = None if spans is None else pin(
            rec, [s for s in spans if s["name"] == LAUNCH])
    return memo["pins"]


def pin(rec: dict, launch_spans: List[dict]) -> Optional[dict]:
    """`pins` of the record's events against `launch_spans`."""
    if not launch_spans:
        log("pinning: no kernel.launch span in the window")
        return None
    events = rec.get("events") or []
    cards = sorted({s["attrs"].get("device") for s in launch_spans
                    if s["attrs"].get("device") is not None})
    fixes, late = {}, 0
    for c in cards:
        mine = [s for s in launch_spans if s["attrs"].get("device") == c]
        kinds = {s["attrs"].get("kernel") for s in mine}
        ls = sorted(s["start_ns"] for s in mine)
        ks = sorted(e["start"] for e in events if e["dev"] == c
                    and any(_is_scan(e["name"], kd) for kd in kinds))
        pairs, how = match(ls, ks)
        if not pairs:
            log(f"pinning card {c}: {len(ls)} launches, {len(ks)} kernel "
                f"records, none paired")
            continue
        fix = Correction(knots(pairs))
        fix.lower_to(pairs)
        fixes[c] = fix
        late += sum(1 for l, k in pairs if k - round(fix(k)) < l)
        lags = [(k, k - l) for l, k in pairs]
        first = [g for k, g in lags if k - lags[0][0] < SECOND]
        last = [g for k, g in lags if lags[-1][0] - k < SECOND]
        log(f"pinning card {c} ({'/'.join(sorted(kinds))}): {len(ls)} "
            f"launches, {len(ks)} kernel records, {len(pairs)} pairs "
            f"{how}; raw lag us first second min {min(first) / 1e3} "
            f"median {statistics.median(first) / 1e3}, last second min "
            f"{min(last) / 1e3} median {statistics.median(last) / 1e3}; "
            f"{len(fix.xs)} knots, correction {fix(lags[0][0]) / 1e3} -> "
            f"{fix(lags[-1][0]) / 1e3} us")
    if not fixes:
        return None
    w0, w1 = rec["window"]
    moved = []
    for e in events:
        fix = fixes.get(e["dev"])
        d = round(fix(e["start"])) if fix is not None else 0
        s, t = max(e["start"] - d, w0), min(e["end"] - d, w1)
        if t > s:
            moved.append(dict(e, start=s, end=t))
    log(f"pinning: {late} paired kernels start before their launch")
    return {"fixes": fixes, "events": moved, "late": late}


def idle_inside(events: Sequence[dict], window: Tuple[int, int],
                spans: Sequence[dict], dev: int) -> int:
    """ns in the window in which card `dev` ran nothing while one of
    `spans` was open on the host."""
    split = trace.idle_gaps(events, window, [
        ("inside", s["start_ns"], s["end_ns"]) for s in spans], dev=dev)
    return round(sum(v for k, v in split if k == "inside") * 1e9)


def depth_order(spans: Sequence[dict]) -> List[str]:
    """The spans' names, the deepest first (a name's depth: its spans'
    most common number of ancestors)."""
    by_id = {s["id"]: s for s in spans}
    depths: Dict[str, List[int]] = {}
    for s in spans:
        d, p = 0, s["parent"]
        while p is not None and p in by_id:
            d, p = d + 1, by_id[p]["parent"]
        depths.setdefault(s["name"], []).append(d)
    return sorted(depths, key=lambda n: -statistics.mode(depths[n]))


def idle_split(rec: dict, dev: int) -> Optional[List[list]]:
    """[[span name, seconds], ...]: card `dev`'s idle time in the window
    after pinning, credited to the innermost program span open on the host
    then, else to the harness's own spans, else "harness"."""
    spans, pinned = in_window(rec), pins(rec)
    if not spans or pinned is None:
        return None
    order = depth_order(spans)
    items = [(s["name"], s["start_ns"], s["end_ns"]) for s in
             sorted(spans, key=lambda s: order.index(s["name"]))]
    items += list(rec.get("spans") or [])
    return trace.idle_gaps(pinned["events"], rec["window"], items, n=20,
                           dev=dev)


def log_idle_split(rec: dict) -> None:
    """Logs each pinned card's idle split (`idle_split`)."""
    pinned = pins(rec)
    for c in sorted(pinned["fixes"]) if pinned else []:
        log(f"idle of card {c} by program span: {idle_split(rec, c)}")
