"""The byte and operation counts of k1_roofline and k4_roofline against
shapes worked by hand, and the readers on hand-made traces."""

import pytest
import torch

from benchmark.harness import roofline, trace
from benchmark.harness.cell import BENCH, load_module


def reader(name):
    return load_module(BENCH / "layer_metrics" / f"{name}.py", name)


def test_k1_call_counts():
    # the flat cell: 6,286,775 x 384 bf16, 100 queries, k = 10
    c = roofline.k1_call(6_286_775, 384, "bfloat16", 100, 10)
    rows = 6_286_775 * 384 * 2 + 6_286_775 * 4
    assert c["bytes"] == rows + 100 * 384 * 4 + 100 * 10 * 8
    assert c["bytes"] == 4_853_551_900
    assert c["ops"] == 2 * 100 * 6_286_775 * 384
    assert c["bound_s"] == pytest.approx(4_853_551_900 / 3.35e12)
    # int8 rows also read their scales; fp32 rows run at the fp32 peak
    assert roofline.k1_call(1000, 8, "int8", 1, 1)["bytes"] == \
        1000 * 8 + 1000 * 8 + 32 + 8
    c = roofline.k1_call(1000, 4096, "float32", 4096, 10)
    assert c["bound_s"] == pytest.approx(2 * 4096 * 1000 * 4096 / 67e12)


def test_k4_call_counts():
    # two distinct lists of 100 and 200 rows, 500 rows over the pairs
    c = roofline.k4_call([100, 200], 500, 8, "int8", 2, 2, 3)
    assert c["bytes"] == 300 * (8 + 8) + 2 * 8 * 4 + 2 * 2 * 12 + 2 * 3 * 8
    assert c["ops"] == 2 * 500 * 8
    assert c["bound_s"] == pytest.approx(4960 / 3.35e12)


def ev(name, dev, start, end):
    return {"name": name, "dev": dev, "start": start, "end": end}


def test_k1_reader_shares_the_bound_over_recorded_calls():
    b = roofline.k1_call(10 ** 7, 8, "bfloat16", 4, 2)["bound_s"]
    t = int(b * 1e9 * 4)  # each call takes 4x its bound
    events = [ev("void exact_scan_kernel<0>(x)", 0, 0, t - 10),
              ev("merge_partials_kernel(x)", 0, t - 10, t),
              ev("void exact_scan_kernel<0>(x)", 0, 2 * t, 3 * t - 10),
              ev("merge_partials_kernel(x)", 0, 3 * t - 10, 3 * t),
              ev("Memcpy DtoH", 0, 3 * t, 3 * t + 5)]
    rec = {"events": events, "window": (0, 4 * t), "cards": [0],
           "info": {"index": {"rows": 10 ** 7, "dim": 8, "dtype": "bfloat16",
                              "queries_per_call": 4},
                    "k": 2, "calls": [0, 1]}}
    assert reader("k1_roofline").read(rec) == pytest.approx(25.0, rel=1e-6)
    assert reader("k1_roofline.x4rep").read(rec) == reader(
        "k1_roofline").read(rec)
    for name in ("device.idle.batch", "device.idle.ivf", "device.idle.x4rep"):
        assert reader(name).read(rec) == pytest.approx(
            1 - (2 * t + 5) / (4 * t))
    assert reader("ivf.kernels_per_batch").read(rec) == 2.0
    rec["events"] = []
    assert reader("k1_roofline").read(rec) is None
    assert reader("device.idle.batch").read(rec) is None


def test_k4_reader_counts_each_probed_list_once():
    cents = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    counts = torch.tensor([10 ** 6, 2 * 10 ** 6, 3 * 10 ** 6])
    pool = torch.tensor([[0.1, 0.0], [9.0, 0.0]])  # both probe lists 0, 1
    ix = {"centroids": cents, "list_counts": counts, "n_probes": 2,
          "dim": 2, "dtype": "int8"}
    bound = roofline.k4_call([10 ** 6, 2 * 10 ** 6], 6 * 10 ** 6, 2, "int8",
                             2, 2, 1)["bound_s"]
    t = int(bound * 1e9 * 2)
    rec = {"events": [ev("ivf_ring_kernel<0>", 0, 0, t)], "window": (0, t),
           "cards": [0], "info": {"index": ix, "pool": pool, "calls": [0],
                                  "batch": 2, "k": 1}}
    assert reader("k4_roofline").read(rec) == pytest.approx(50.0, rel=1e-3)


def test_straggler_reader():
    events = [ev("k", 0, 0, 100), ev("k", 1, 0, 300), ev("Memcpy", 1, 0, 9)]
    rec = {"events": events, "cards": [0, 1]}
    assert reader("replica.straggler").read(rec) == pytest.approx(1.5)
    assert reader("replica.straggler").read({"events": events,
                                             "cards": [0]}) is None


def test_idle_gaps_credit_the_covering_span():
    events = [ev("k", 0, 10, 20), ev("k", 0, 30, 40)]
    spans = [("search call", 0, 25), ("ids to host", 25, 50)]
    gaps = dict(trace.idle_gaps(events, (0, 60), spans, dev=0))
    assert gaps == {"search call": 15e-9, "ids to host": 15e-9,
                    "harness": 10e-9}
