"""k4_roofline: K4's share of its roofline, in %, from the device trace.

K4 is the IVF-Flat probed-list scan (`csrc/ivf_scan.cu`: the scan kernel and
the merge of its partial results). Its bound for a batch counts every list
the batch probes once (harness/roofline.k4_call); the lists are found as the
index finds them, the n_probes centroids nearest each query, here in plain
PyTorch from the centroids and list sizes copied off the index. The share is
the mean bound of the window's calls times the recorded launches over the
device time of K4's kernels. None where the trace holds no K4 kernel or the
index is not IVF.
"""

import torch

from benchmark.harness import roofline, trace

SCANS = ("ivf_ring_kernel", "ivf_scan_kernel")  # one launch a call
NAMES = SCANS + ("merge_partials",)


def batch_bounds(pool, calls, batch, ix, k):
    """{pool batch: bound seconds} for the batches `calls` names."""
    cents = ix["centroids"].float()
    counts = ix["list_counts"]
    cn = (cents * cents).sum(1)
    out = {}
    for b in sorted(set(calls)):
        q = pool[b * batch:(b + 1) * batch].float()
        d = cn[None, :] - 2.0 * (q @ cents.T)
        probes = torch.topk(d, ix["n_probes"], dim=1, largest=False).indices
        lists = torch.unique(probes)
        out[b] = roofline.k4_call(
            counts[lists].tolist(), int(counts[probes].sum()),
            ix["dim"], ix["dtype"], q.shape[0], ix["n_probes"],
            k)["bound_s"]
    return out


def read(rec):
    info = rec["info"]
    ix = info.get("index") or {}
    if "list_counts" not in ix or info.get("pool") is None \
            or not info["calls"]:
        return None
    secs, counts = trace.kernel_time(rec["events"], NAMES)
    launches = sum(counts.get(n, 0) for n in SCANS)
    if not launches or secs <= 0:
        return None
    bounds = batch_bounds(info["pool"], info["calls"], info["batch"], ix,
                          info["k"])
    mean = sum(bounds[b] for b in info["calls"]) / len(info["calls"])
    return 100.0 * mean * launches / secs
