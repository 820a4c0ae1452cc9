"""k1_roofline: K1's share of its roofline, in %, from the device trace.

K1 is the exact flat top-k (`csrc/flat_topk.cu`: the scan kernel and the
merge of its partial results). Its bound a call is the flat index's rows
and norms read once, the call's queries and output (harness/roofline.k1_call),
against the device time of K1's kernels a recorded call. None where the
trace holds no K1 kernel or the index is not flat.
"""

from benchmark.harness import roofline, trace

SCAN = "exact_scan"  # one launch a call
NAMES = (SCAN, "merge_partials")


def read(rec):
    info = rec["info"]
    ix = info.get("index") or {}
    if "rows" not in ix:
        return None
    secs, counts = trace.kernel_time(rec["events"], NAMES)
    calls = counts.get(SCAN, 0)
    if not calls or secs <= 0:
        return None
    bound = roofline.k1_call(ix["rows"], ix["dim"], ix["dtype"],
                             ix["queries_per_call"], info["k"])
    return 100.0 * bound["bound_s"] * calls / secs
