"""utils/profiling.py of the port, as the JAX package's
tests/test_profiling.py holds its own: the span recorder (off and on,
parents and requests, threads, its bound, self time), draining, the cost
numbers of one call, and the Chrome trace with the spans in it."""

import json
import os
import threading
import time

import pytest
import torch

from cuvs_rag_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The process's recorder, empty and off before and after the test."""
    profiling.record_spans(False)
    profiling.clear()
    yield profiling
    profiling.record_spans(False)
    profiling.clear()


def test_timer_spans(recorder):
    """The recorder keeps a span's name, its host times on perf_counter_ns
    and its attrs; summary() counts and sums them by name."""
    before = recorder.record_spans(True)
    assert before is False
    t0 = time.perf_counter_ns()
    with recorder.span("a", queries=3):
        time.sleep(0.01)
    with recorder.span("a"):
        pass
    with recorder.span("b", kernel="K1", device=0):
        pass
    t1 = time.perf_counter_ns()
    got = recorder.spans()
    assert [s["name"] for s in got] == ["a", "a", "b"]
    assert all(t0 <= s["start_ns"] <= s["end_ns"] <= t1 for s in got)
    assert got[0]["attrs"] == {"queries": 3} and got[1]["attrs"] == {}
    assert got[2]["attrs"] == {"kernel": "K1", "device": 0}
    assert set(got[0]) == set(profiling.FIELDS)
    s = recorder.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0.01
    assert set(s["a"]) == {"count", "total_s", "self_s", "mean_s", "max_s"}
    recorder.clear()
    assert recorder.spans() == []


def test_timer_block_on_device_work(recorder):
    """A span never waits for the device (no block_on): the work launched
    inside it is only enqueued. drain() is the wait, where one is needed."""
    recorder.record_spans(True)
    x = torch.ones((256, 256))
    with recorder.span("matmul"):
        y = x @ x
    assert recorder.summary()["matmul"]["count"] == 1
    assert "block_on" not in profiling.span.__code__.co_varnames
    # drain takes tensors, tuples of them, indexes and devices; the CPU
    # needs no wait
    profiling.drain((y, [x]))
    profiling.drain(torch.device("cpu"))
    profiling.drain(None)


def test_off_records_nothing(recorder):
    assert not recorder.recording()
    with recorder.span("search", queries=4):
        with recorder.span("kernel.launch", kernel="K1"):
            pass
    assert recorder.spans() == []
    # off, every site shares one no-op context
    assert recorder.span("x") is recorder.span("y", device=1)


def test_on_under_a_profiler_session_and_after_record_spans(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert recorder.recording()
        with recorder.span("traced"):
            pass
    assert not recorder.recording()
    with recorder.span("after"):
        pass
    recorder.record_spans(True)
    with recorder.span("asked"):
        pass
    assert [s["name"] for s in recorder.spans()] == ["traced", "asked"]


def test_parents_and_request_ids_through_nesting(recorder):
    recorder.record_spans(True)
    with recorder.span("search", family="flat", placement="single"):
        with recorder.span("flat.search"):
            with recorder.span("kernel.launch", kernel="K1"):
                pass
        with recorder.span("fan_out.join"):
            pass
    with recorder.span("search"):
        pass
    got = {(s["name"], s["request"]): s for s in recorder.spans()}
    top = [s for s in recorder.spans() if s["parent"] is None]
    assert [s["name"] for s in top] == ["search", "search"]
    r1, r2 = top[0]["request"], top[1]["request"]
    assert r1 != r2
    assert got[("flat.search", r1)]["parent"] == top[0]["id"]
    assert got[("kernel.launch", r1)]["parent"] == \
        got[("flat.search", r1)]["id"]
    assert got[("fan_out.join", r1)]["parent"] == top[0]["id"]
    assert {s["request"] for s in recorder.spans()} == {r1, r2}


def test_four_threads_keep_their_own_parents(recorder):
    recorder.record_spans(True)
    barrier = threading.Barrier(4)

    def work(i):
        with recorder.span("search", position=i):
            barrier.wait(timeout=10)  # all four open at once
            with recorder.span("flat.search", position=i):
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = recorder.spans()
    by_id = {s["id"]: s for s in got}
    inner = [s for s in got if s["name"] == "flat.search"]
    assert len(inner) == 4 and len(got) == 8
    for s in inner:
        up = by_id[s["parent"]]
        assert up["name"] == "search"
        assert up["attrs"] == s["attrs"] and up["thread"] == s["thread"]
        assert up["request"] == s["request"]
    assert len({s["request"] for s in got}) == 4
    assert len({s["thread"] for s in got}) == 4


def test_the_bound_counts_dropped_spans(recorder, monkeypatch):
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    before = default_registry.snapshot()["counters"].get(
        "trace.spans_dropped", 0)
    recorder.record_spans(True)
    for _ in range(5):
        with recorder.span("s"):
            pass
    assert len(recorder.spans()) == 3
    after = default_registry.snapshot()["counters"]["trace.spans_dropped"]
    assert after - before == 2


def test_summary_self_time(recorder):
    """Self time: a span's time less that of the spans directly inside."""
    def item(i, name, s, e, parent=None):
        return {"id": i, "name": name, "start_ns": s, "end_ns": e,
                "parent": parent, "request": 1, "thread": 1, "attrs": {}}

    items = [item(2, "flat.search", 100, 400, 1),
             item(3, "kernel.launch", 150, 200, 2),
             item(4, "fan_out.join", 500, 600, 1),
             item(1, "search", 0, 1000)]
    s = recorder.summary(items)
    assert s["search"]["total_s"] == 1000e-9
    assert s["search"]["self_s"] == 600e-9  # less 300 and 100
    assert s["flat.search"]["self_s"] == 250e-9
    assert s["kernel.launch"]["self_s"] == 50e-9
    # recorded spans: a parent's self time never exceeds its total
    recorder.record_spans(True)
    with recorder.span("outer"):
        with recorder.span("inner"):
            time.sleep(0.002)
    s = recorder.summary()
    assert s["outer"]["self_s"] < s["outer"]["total_s"] - 0.0015
    assert s["inner"]["self_s"] == s["inner"]["total_s"]


def test_annotate_context(recorder, tmp_path):
    """trace() writes the spans recorded in its block into trace.json,
    beside the profiler's own events, on a track a thread, on the trace's
    clock."""
    with recorder.span("before the trace"):
        pass
    with profiling.trace(str(tmp_path)):
        with recorder.span("search", queries=8):
            with recorder.span("flat.search"):
                time.sleep(0.02)
                _ = torch.sum(torch.ones((8, 8)))
                time.sleep(0.02)
    assert not recorder.recording()
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(mine) == {"search", "flat.search"}
    assert mine["search"]["args"]["queries"] == 8
    assert mine["search"]["tid"] == threading.get_ident()
    assert mine["flat.search"]["args"]["parent"] == \
        mine["search"]["args"]["id"]
    # the spans sit on the trace's clock around the operator they hold,
    # 20 ms into the span (within 5 ms)
    op = [e for e in events if e.get("name") == "aten::sum"]
    assert op
    inner = mine["flat.search"]
    assert 15e3 <= float(op[0]["ts"]) - inner["ts"] <= 25e3
    assert float(op[0]["ts"]) <= inner["ts"] + inner["dur"]


def test_compiled_stats():
    stats = profiling.compiled_stats(
        lambda a, b: a @ b, torch.ones((128, 128)), torch.ones((128, 128)))
    assert set(stats) == {"flops", "bytes_accessed", "peak_memory_bytes"}
    assert stats["flops"] >= 2 * 128 ** 3 * 0.9
    assert stats["bytes_accessed"] is None
    assert stats["peak_memory_bytes"] is None  # the CPU reports none
    # operators with no flop formula count nothing: None, not 0
    assert profiling.compiled_stats(torch.sort, torch.ones(16))["flops"] \
        is None


def test_call_seconds_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(2), torch.zeros(2, dtype=torch.int32)

    ts = profiling.call_seconds(fn, iters=3, warmup=2)
    assert len(ts) == 3 and all(t >= 0 for t in ts)
    assert len(calls) == 5
