"""The CAGRA cell's three readers: cagra.beam_roofline's bound against a
batch worked by hand, the readers on a synthetic record and on one with
nothing of the program's in it, and the counters they read on a small CPU
run of the cell with the program's recorder on.

The CAGRA configuration's size for the CPU runs of the benchmark's tests
(`conftest.SMALL`, which every cell's CPU run reads) is registered here,
beside the tests of its readers: 20,000 x 64 rows, the IVF-bootstrapped
graph at degrees 32 / 64 over 64 lists."""

import time

import pytest
import torch

import conftest
from conftest import ROOT, run_small, small_cell

from benchmark.harness import cell as cell_lib
from benchmark.harness import roofline

conftest.SMALL.setdefault("wikiall-10m-cagra", {
    "data": {"rows": 20000, "dim": 64, "chunks": 4,
             "geometry": {"centres": 32, "rank": 16}},
    "index": {"params": {"intermediate_graph_degree": 64, "graph_degree": 32,
                         "build_algo": "ivf", "build_nlists": 64}}})

CELL = "cagra10m.batch100"
US = 1_000


def reader(name):
    return cell_lib.load_module(
        ROOT / "benchmark" / "layer_metrics" / f"{name}.py", name)


def test_beam_bound_of_the_cells_batch():
    """100 queries at itopk 128 and search width 16: 16 iterations of 16
    parents x 64 neighbours and 128 entry rows each, over rows stored 896
    bf16 lanes wide, k = 10."""
    rows = 100 * (16 * 16 * 64 + 128)
    assert rows == 1_651_200
    b = reader("cagra.beam_roofline").search_bound(
        rows, 100 * 128, 100, 896, "bfloat16", 10)
    assert b["bytes"] == 1_651_200 * 896 * 2 + 1_638_400 * 4 + 100 * (
        896 * 4 + 10 * 8)
    assert b["bytes"] == 2_965_870_400
    assert b["ops"] == 2 * 1_651_200 * 896
    # the bytes bound it: 0.885 ms a batch
    assert b["bound_s"] == pytest.approx(2_965_870_400 / 3.35e12)
    assert b["bound_s"] == roofline.bound_s(b["bytes"], b["ops"], "fp32")


def synthetic(monkeypatch, n_calls=4, per_call=3):
    """A window of `n_calls` CAGRA searches of 1 ms each, every one
    launching `per_call` kernels of 200 us and one copy, with the
    program's counters for 100-query batches."""
    from cuvs_rag_tpu_torch.utils import profiling

    spans, events = [], []
    for c in range(n_calls):
        t = 1_000 * US + 2_000 * US * c
        spans.append({"id": c + 1, "name": "cagra.search", "start_ns": t,
                      "end_ns": t + 1_000 * US, "parent": None,
                      "request": c, "thread": 1, "attrs": {}})
        for j in range(per_call):
            s = t + 100 * US + 250 * US * j
            events.append({"name": f"void kernel_{j}<float>(x)", "dev": 0,
                           "start": s, "end": s + 200 * US})
        events.append({"name": "Memcpy DtoH (Device -> Pageable)", "dev": 0,
                       "start": t + 900 * US, "end": t + 910 * US})
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    rows = n_calls * 100 * (8 * 16 * 64 + 128)
    return {"window": (0, 2_000 * US * (n_calls + 1)), "events": events,
            "cards": [0], "spans": [],
            "counters": {"cagra.queries": n_calls * 100.0,
                         "cagra.iterations": n_calls * 800.0,
                         "cagra.entry_rows": n_calls * 12_800.0,
                         "cagra.candidate_rows": float(rows)},
            "info": {"calls": list(range(n_calls)), "batch": 100, "k": 10,
                     "index": {"dtype": "bfloat16", "dim": 896,
                               "queries_per_call": 100,
                               "rows": 10_000_000}}}


def test_readers_on_a_synthetic_record(monkeypatch):
    rec = synthetic(monkeypatch)
    assert reader("cagra.search_host_us").read(rec) == pytest.approx(1_000)
    assert reader("cagra.kernels_per_batch").read(rec) == 3.0
    # each batch's bound over its 600 us of kernels (the copy not counted)
    bound = reader("cagra.beam_roofline").search_bound(
        832_000, 12_800, 100, 896, "bfloat16", 10)["bound_s"]
    assert reader("cagra.beam_roofline").read(rec) == pytest.approx(
        100 * bound / 600e-6)


def test_readers_read_nothing_without_the_programs_spans_and_counters(
        monkeypatch):
    """A program that records no CAGRA span and counts no CAGRA work (the
    port before them): every reader gives None and none raises."""
    from cuvs_rag_tpu_torch.utils import profiling

    rec = synthetic(monkeypatch)
    counters = rec["counters"]
    monkeypatch.setattr(profiling, "spans", lambda: [])
    rec["counters"] = {}
    for name in ("cagra.search_host_us", "cagra.kernels_per_batch",
                 "cagra.beam_roofline"):
        assert reader(name).read(rec) is None
    # nor without a span recorder at all
    monkeypatch.delattr(profiling, "spans")
    rec = dict(rec)  # a new record: nothing remembered of the last
    assert reader("cagra.search_host_us").read(rec) is None
    assert reader("cagra.kernels_per_batch").read(rec) is None
    # no device event: nothing to share the bound over
    rec["counters"] = counters
    rec["events"] = []
    assert reader("cagra.beam_roofline").read(rec) is None


def test_small_cpu_run_counts_the_nominal_work():
    """The cell at its small size on the CPU with the program's recorder
    on: one `cagra.search` span a call, the counters the call's nominal
    work (itopk 128, search width 16: 16 iterations of 16 parents x graph
    degree 32, 128 entry rows a query); no device, so nothing to read for
    the two device-trace readers."""
    from cuvs_rag_tpu_torch.utils import profiling

    cell = small_cell(CELL)
    profiling.record_spans(True)
    try:
        run = cell_lib.Run(cell=cell, seed=5, seconds=0.3, trace=True,
                           devices=[torch.device("cpu")],
                           t_start=time.perf_counter())
        rec = cell.driver().run(run).record
    finally:
        profiling.record_spans(False)
    calls = len(rec["info"]["calls"])
    q = calls * 100
    assert rec["counters"]["cagra.queries"] == q
    assert rec["counters"]["cagra.iterations"] == 16 * q
    assert rec["counters"]["cagra.entry_rows"] == 128 * q
    assert rec["counters"]["cagra.candidate_rows"] == q * (
        16 * 16 * 32 + 128)
    host_us = reader("cagra.search_host_us").read(rec)
    assert 0 < host_us < (rec["window"][1] - rec["window"][0]) / 1e3
    assert reader("cagra.kernels_per_batch").read(rec) is None
    assert reader("cagra.beam_roofline").read(rec) is None
    profiling.clear()


def test_the_cell_is_correct_at_its_small_size_and_its_control_is_not():
    assert run_small(CELL)["correct"] is True
    line = run_small(CELL, control=True)
    assert line["correct"] is False
    # the control (the reference at int8 rows) fails on its distances
    assert line["checks"]["dist_gap"]["value"] > \
        line["checks"]["dist_gap"]["limit"]
