"""utils/profiling.py of the port, as the JAX package's
tests/test_profiling.py holds its own: spans, draining, annotations, the
cost numbers of one call, and the Chrome trace."""

import json
import os
import time

import torch

from cuvs_rag_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_timer_spans():
    t = profiling.Timer()
    with t.span("a"):
        time.sleep(0.01)
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["total_s"] >= 0.01
    assert set(s["a"]) == {"count", "total_s", "mean_s", "max_s"}
    assert "b" in s


def test_timer_block_on_device_work():
    t = profiling.Timer()
    x = torch.ones((256, 256))
    with t.span("matmul", block_on=x):
        y = x @ x
    assert t.summary()["matmul"]["count"] == 1
    # drain takes tensors, tuples of them, indexes and devices; the CPU
    # needs no wait
    profiling.drain((y, [x]))
    profiling.drain(torch.device("cpu"))
    profiling.drain(None)


def test_annotate_context(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("test-span"):
            _ = torch.sum(torch.ones((8, 8)))
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test-span" for e in events)


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
