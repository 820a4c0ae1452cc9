"""device.idle.x4rep: the share of the traced window in which no operation
ran on a card (1 - the union of its kernel and copy intervals / the
window), the mean over the four replicas' cards. None where the trace
holds no device operation."""

from benchmark.harness import trace


def read(rec):
    return trace.idle_share(rec)
