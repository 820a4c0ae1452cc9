"""ivf.kernels_per_batch: CUDA kernels the device trace records in the
window, over the batches searched in it (copies and sets not counted). The
host launches each one, so it counts the host's part of a host-bound
search. None where the trace holds no kernel."""

COPIES = ("Memcpy", "Memset")


def read(rec):
    calls = len(rec["info"].get("calls") or [])
    n = sum(1 for e in rec["events"] if not e["name"].startswith(COPIES))
    if not calls or not n:
        return None
    return n / calls
