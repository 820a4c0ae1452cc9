"""ivf.launch_idle: the share of the traced window in which the card ran
nothing while the program's IVF `search` span was open on the host: the card
waiting for the host's launches of a batch. The device events are first
pinned to the program's `kernel.launch` spans (`harness/program_spans`);
the mean over the pinned cards. Logs the idle time by program span. None
where the program records no such span or no K4 record pairs with one."""

from benchmark.harness import program_spans


def read(rec):
    spans = program_spans.named(rec, "search", family="ivf_flat")
    pinned = program_spans.pins(rec) if spans else None
    if pinned is None:
        return None
    program_spans.log_idle_split(rec)
    w0, w1 = rec["window"]
    idle = [program_spans.idle_inside(pinned["events"], (w0, w1), spans, c)
            for c in sorted(pinned["fixes"])]
    return sum(idle) / len(idle) / (w1 - w0)
