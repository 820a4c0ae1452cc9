"""cagra.search_host_us: the mean duration, in microseconds, of the
program's `cagra.search` spans in the traced window: the host's path
through one batch's CAGRA search call, its launches included
(`harness/program_spans`). None where the program records no such span."""

from benchmark.harness import program_spans


def read(rec):
    spans = program_spans.named(rec, "cagra.search")
    if spans is None:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans) / 1e3
