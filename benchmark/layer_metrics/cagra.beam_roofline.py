"""cagra.beam_roofline: the CAGRA search's share of its roofline, in %,
from the device trace and the program's counters.

The work is the search's nominal work, as the program counts it from the
call's parameters (`index/cagra.search_scores`): `cagra.candidate_rows`
rows scored (queries x iterations x search_width x graph_degree, plus the
entry rows), of which `cagra.entry_rows` entry rows, over `cagra.queries`
queries. A search's least time is max(bytes / HBM bandwidth, operations /
fp32 peak) (`harness/roofline.bound_s`): each scored row read once at its
stored width (the augmented rows [v, hi, lo, 0...]), each expanded parent's
graph row (graph_degree int32 ids) read once, each augmented fp32 query
read once and each (k distance, id) pair written once; 2 x stored width
operations a scored row, in fp32 as the port scores them. The share is
that bound, summed over the window's calls, over the device time of every
kernel in the window (copies and sets not counted). None where the program
counts no CAGRA work or the trace holds no kernel.
"""

from benchmark.harness import roofline

COPIES = ("Memcpy", "Memset")
ID_BYTES = 4  # a graph edge: an int32 row id


def search_bound(candidate_rows: float, entry_rows: float, queries: float,
                 width: int, dtype: str, k: int) -> dict:
    """Bytes, operations and bound seconds of CAGRA searches that scored
    `candidate_rows` rows (`entry_rows` of them entry rows) of `width`
    stored `dtype` lanes for `queries` queries at top-k."""
    graph_rows = candidate_rows - entry_rows  # parents x degree
    n_bytes = candidate_rows * width * roofline.ELEM_BYTES[dtype] \
        + graph_rows * ID_BYTES + queries * (width * 4 + k * 8)
    n_ops = 2.0 * candidate_rows * width
    return {"bytes": n_bytes, "ops": n_ops,
            "bound_s": roofline.bound_s(n_bytes, n_ops, "fp32")}


def read(rec):
    counters = rec.get("counters") or {}
    rows = counters.get("cagra.candidate_rows", 0)
    ix = rec["info"].get("index") or {}
    if not rows or "dim" not in ix:
        return None
    secs = sum(e["end"] - e["start"] for e in rec["events"]
               if not e["name"].startswith(COPIES)) / 1e9
    if secs <= 0:
        return None
    bound = search_bound(rows, counters.get("cagra.entry_rows", 0),
                         counters.get("cagra.queries", 0), ix["dim"],
                         ix["dtype"], rec["info"]["k"])
    return 100.0 * bound["bound_s"] / secs
