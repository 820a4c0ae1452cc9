"""harness/program_spans and the three readers of the program's spans:
pinning on synthetic device events (a constant offset, a linear drift, a
dropped kernel record), the readers on small CPU runs with the program's
recorder on, and the accepted benchmark files left byte for byte."""

import bisect
import hashlib
import json
import random
import time

import pytest
import torch

from conftest import ROOT, run_small, small_cell
from test_bench_discovery import digest

from benchmark.harness import program_spans

US = 1_000


def synthetic(offset, drop=None, seconds=30.0, period=2_600 * US, seed=7):
    """A card's K4 launches every `period`, each kernel starting 2-3 us
    after its launch, a quarter of them queued 0-400 us more, and a copy
    10 us after each kernel ends; the recorded device times are the true
    ones less offset(true start) (the marker's error), kernel record
    `drop` lost. -> (record, launch spans, true kernel starts, true copy
    starts)."""
    rnd = random.Random(seed)
    w0 = 5_000_000
    launches, events, true_k, true_c = [], [], [], []
    t = w0 + 100 * US
    n = 0
    while t < w0 + seconds * 1e9 - 10_000 * US:
        queue = rnd.uniform(0, 400 * US) if rnd.random() < 0.25 else 0
        k = t + rnd.uniform(2 * US, 3 * US) + queue
        launches.append({"id": n, "name": "kernel.launch", "start_ns": t,
                         "end_ns": t + 4 * US, "parent": None, "request": n,
                         "thread": 1,
                         "attrs": {"kernel": "K4", "device": 0}})
        end = k + 1_800 * US
        if n != drop:
            events.append({"name": "ivf_ring_kernel", "dev": 0,
                           "start": round(k - offset(k)),
                           "end": round(end - offset(k))})
            true_k.append(k)
        events.append({"name": "Memcpy DtoH", "dev": 0,
                       "start": round(end + 10 * US - offset(end)),
                       "end": round(end + 12 * US - offset(end))})
        true_c.append(end + 10 * US)
        t += period
        n += 1
    rec = {"window": (w0, round(w0 + seconds * 1e9)), "events": events,
           "cards": [0]}
    return rec, launches, true_k, true_c


@pytest.mark.parametrize("case", ["constant", "drift", "dropped"])
def test_pinning_recovers_device_times(case):
    offset = {"constant": lambda t: 300 * US,
              "drift": lambda t: 500 * US * (t - 5_000_000) / 30e9,
              "dropped": lambda t: -150 * US}[case]
    rec, launches, true_k, true_c = synthetic(
        offset, drop=2_000 if case == "dropped" else None)
    out = program_spans.pin(rec, launches)
    assert out["late"] == 0
    kernels = sorted(e["start"] for e in out["events"]
                     if e["name"] == "ivf_ring_kernel")
    copies = sorted(e["start"] for e in out["events"]
                    if e["name"].startswith("Memcpy"))
    assert len(kernels) == len(true_k) and len(copies) == len(true_c)
    # within the launch latency left (2-3 us), 5 us at most
    assert max(abs(a - b) for a, b in zip(kernels, true_k)) <= 5 * US
    assert max(abs(a - b) for a, b in zip(copies, true_c)) <= 5 * US
    # each kernel after a launch of its own batch
    starts = sorted(s["start_ns"] for s in launches)
    for k in kernels:
        i = bisect.bisect_right(starts, k) - 1
        assert i >= 0 and k - starts[i] < 500 * US


def test_match_pairs_past_a_dropped_record():
    launches = [i * 1_000 * US for i in range(10)]
    kernels = [l + 5 * US - 200 * US for i, l in enumerate(launches)
               if i != 4]
    pairs, how = program_spans.match(launches, kernels)
    assert how != "in order"
    assert [l for l, _ in pairs] == [l for i, l in enumerate(launches)
                                     if i != 4]


def run_recorded(workload):
    """A small traced CPU run of `workload` with the program's recorder
    on: (result line, the driver's record)."""
    from benchmark.harness import cell as cell_lib
    from cuvs_rag_tpu_torch.utils import profiling

    profiling.record_spans(True)
    try:
        line = run_small(workload, trace=True)
        cell = small_cell(workload)
        run = cell_lib.Run(cell=cell, seed=5, seconds=0.3, trace=True,
                           devices=[torch.device("cpu")] * cell.chips,
                           t_start=time.perf_counter())
        rec = cell.driver().run(run).record
    finally:
        profiling.record_spans(False)
    return line, rec


def read(metric, rec):
    from benchmark.harness import cell as cell_lib

    return cell_lib.load_module(
        ROOT / "benchmark" / "layer_metrics" / f"{metric}.py",
        metric).read(rec)


def test_readers_on_small_cpu_runs():
    from cuvs_rag_tpu_torch.utils import profiling

    line, rec = run_recorded("ivf10m.batch100")
    host_us = line["metrics"]["ivf.search_host_us"]
    assert host_us["unit"] == "us" and host_us["value"] > 0
    # no card: no launch span nor device event to pin
    assert "ivf.launch_idle" not in line["metrics"]
    assert read("replica.fanout_host_us", rec) is None
    assert 0 < read("ivf.search_host_us", rec) < (
        rec["window"][1] - rec["window"][0]) / 1e3

    line, rec = run_recorded("flat6m.x4rep.batch100")
    fan = line["metrics"]["replica.fanout_host_us"]["value"]
    assert fan > 0
    assert read("ivf.search_host_us", rec) is None
    spans = program_spans.in_window(rec)
    searches = [s for s in spans if s["name"] == "search"]
    mean_search = sum(s["end_ns"] - s["start_ns"] for s in searches) \
        / len(searches) / 1e3
    assert read("replica.fanout_host_us", rec) <= mean_search

    _, rec = run_recorded("flat6m.batch100")
    for m in ("ivf.search_host_us", "ivf.launch_idle",
              "replica.fanout_host_us"):
        assert read(m, rec) is None
    profiling.clear()


def test_launch_idle_on_a_synthetic_card(monkeypatch):
    """Two IVF searches of 1 ms, the card idle 300 us after each starts
    (its launches) and 200 us after each ends (the harness's copy): the
    share counts only the first."""
    from cuvs_rag_tpu_torch.utils import profiling

    spans, events = [], []
    for i, t in enumerate((1_000 * US, 3_000 * US)):
        spans.append({"id": 10 * i + 1, "name": "search", "start_ns": t,
                      "end_ns": t + 1_000 * US, "parent": None,
                      "request": i, "thread": 1,
                      "attrs": {"family": "ivf_flat"}})
        spans.append({"id": 10 * i + 2, "name": "kernel.launch",
                      "start_ns": t + 297 * US, "end_ns": t + 310 * US,
                      "parent": 10 * i + 1, "request": i, "thread": 1,
                      "attrs": {"kernel": "K4", "device": 0}})
        # recorded 100 us early (the marker's error)
        events.append({"name": "ivf_ring_kernel", "dev": 0,
                       "start": t + 200 * US, "end": t + 1_700 * US})
    rec = {"window": (1_000 * US, 5_000 * US), "events": events,
           "cards": [0], "spans": []}
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = read("ivf.launch_idle", rec)
    # after pinning each kernel starts at its launch: 297 us idle inside
    # each search span, of a 4 ms window
    assert got == pytest.approx(2 * 297 / 4_000, abs=1e-6)
    assert read("ivf.search_host_us", rec) == pytest.approx(1_000)
    raw_idle = 1 - sum(e["end"] - e["start"] for e in events) / 4_000e3
    assert got <= raw_idle


ACCEPTED = {
    "__init__.py": "e3b0c44298fc1c14",
    "configs/wiki-minilm-6m-flat-x4rep.json": "f5caf0fec483a26e",
    "configs/wiki-minilm-6m-flat.json": "e6b118ead577116a",
    "configs/wikiall-10m-ivf-int8.json": "0067824557068b66",
    "drivers/closed_batches.py": "cb0a2a1449b7f22f",
    "harness/__init__.py": "e3b0c44298fc1c14",
    "harness/cell.py": "10fcad77aea510ff",
    "harness/compare.py": "22f040b9c56c2c6a",
    "harness/gen.py": "1b6c8d937ffd78f4",
    "harness/roofline.py": "8eca1ff25be09100",
    "harness/systems.py": "bff08470af54eb45",
    "harness/trace.py": "79d1658cac919f8e",
    "layer_metrics/device.idle.batch.py": "55c28fe8ffaabe1f",
    "layer_metrics/device.idle.ivf.py": "9b3c038850fbcd90",
    "layer_metrics/device.idle.x4rep.py": "c0442e312ac845a9",
    "layer_metrics/ivf.kernels_per_batch.py": "41fc2211cc3c1d2a",
    "layer_metrics/k1_roofline.py": "89b1aa734ab7e743",
    "layer_metrics/k1_roofline.x4rep.py": "9031bf49e0406b43",
    "layer_metrics/k4_roofline.py": "634e2dc6fb60345e",
    "layer_metrics/replica.straggler.py": "8ee99b0eb9ad4272",
    "reference/__init__.py": "e3b0c44298fc1c14",
    "reference/exact_topk.py": "145d3876d3897bcb",
    "run.py": "b3f5e75e35a33176",
    "tests/conftest.py": "d1094470eb2dfd4a",
    "tests/test_bench_cells.py": "8d2f453f32de1603",
    "tests/test_bench_discovery.py": "13b8df94aec52384",
    "tests/test_bench_faults.py": "439738839d31da3b",
    "tests/test_bench_frozen.py": "fdae3d9cd2c4206c",
    "tests/test_bench_imports.py": "36620bc1652ce0d0",
    "tests/test_bench_reference.py": "d59a1aa0b02d725c",
    "tests/test_bench_roofline.py": "b9a9e705eed9aaa8",
    "tools/readings.py": "23c1e0fd1f738932",
    "tools/sweep_nprobes.py": "f41a1913702731b5",
    "traffic/batch100.json": "67a45b4949d8e6fe",
}
ACCEPTED_SPEC = "a207e01cea2fe6b8"


def test_accepted_benchmark_files_stay_byte_for_byte():
    """The files the accepted benchmark had (PR 17) are unchanged, and its
    BENCHMARK.json entries are there as they were, new ones appended."""
    have = {str(k.relative_to("benchmark")): v[:16]
            for k, v in digest(ROOT).items()}
    assert {k: have.get(k) for k in ACCEPTED} == ACCEPTED
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    old = dict(spec, per_layer=[m for m in spec["per_layer"]
                                if m["source"] != "program_span"])
    assert hashlib.sha256(json.dumps(old, sort_keys=True).encode()
                          ).hexdigest()[:16] == ACCEPTED_SPEC
    assert [m["name"] for m in spec["per_layer"][-3:]] == [
        "ivf.search_host_us", "ivf.launch_idle", "replica.fanout_host_us"]
