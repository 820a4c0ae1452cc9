"""replica.fanout_host_us: the mean over search calls, in microseconds, of
the host's time from the first replica's `fan_out.position` span to the end
of the last: the replicas' searches launched one after another from one
process (`harness/program_spans`). Logs each card's idle time by program
span. None where the program records no such span."""

from benchmark.harness import program_spans


def read(rec):
    spans = program_spans.named(rec, "fan_out.position")
    if spans is None:
        return None
    calls = {}
    for s in spans:
        lo, hi = calls.get(s["request"], (s["start_ns"], s["end_ns"]))
        calls[s["request"]] = (min(lo, s["start_ns"]), max(hi, s["end_ns"]))
    program_spans.log_idle_split(rec)
    return sum(hi - lo for lo, hi in calls.values()) / len(calls) / 1e3
