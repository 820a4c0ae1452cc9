"""cagra.kernels_per_batch: CUDA kernels the device trace records in the
window (copies and sets not counted), over the program's `cagra.search`
spans in it: the launches of one CAGRA search call, each made by the host.
None where the program records no such span or the trace no kernel."""

from benchmark.harness import program_spans

COPIES = ("Memcpy", "Memset")


def read(rec):
    spans = program_spans.named(rec, "cagra.search")
    if spans is None:
        return None
    n = sum(1 for e in rec["events"] if not e["name"].startswith(COPIES))
    if not n:
        return None
    return n / len(spans)
