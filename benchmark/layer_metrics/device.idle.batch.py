"""device.idle.batch: the share of the traced window in which no operation
ran on the card (1 - the union of its kernel and copy intervals / the
window), in the flat batch cells on one card. None where the trace holds
no device operation."""

from benchmark.harness import trace


def read(rec):
    return trace.idle_share(rec)
