"""The plain PyTorch versions of the measurement kernels M1-M4 against numpy
on the CPU: `read_all_plain` against the (8, 128) fold of
scripts/bench_roofline.py:57-63 written out in numpy, `gather_rows_plain`
and `gather_reduce_plain` against numpy indexing (what `vectors[ids]`,
`dynamic_slice` and `.sum(0)` compute in scripts/bench_gather_modes.py).

Maxima and copies are exact; the fp32 sum is held to rtol 1e-5 / atol 1e-4
(numpy adds in another order; unit-variance values, sums of a few hundred).
"""

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch.ops import stream_kernels as sk

torch.set_num_threads(1)


def _bf16(a):
    """A float array rounded to bf16: (tensor, the same values as fp32)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, t.float().numpy()


def _fold_reduce(x):
    """bench_roofline.py:57-60 on one tile that holds every row."""
    return np.max(x.reshape(x.shape[0] // 8, 8, x.shape[1] // 128, 128),
                  axis=(0, 2))


def _fold_touch(x, tile_c):
    """bench_roofline.py:63 folded over the tiles: each tile's corner."""
    acc = np.full((8, 128), -np.inf, np.float32)
    for j in range(x.shape[0] // tile_c):
        acc = np.maximum(acc, x[j * tile_c:(j + 1) * tile_c][:8, :128])
    return acc


@pytest.mark.parametrize("n,d", [(2048, 128), (3072, 384), (1024, 768)])
@pytest.mark.parametrize("full_reduce", [True, False])
def test_read_all_matches_the_roofline_fold(n, d, full_reduce):
    t, x = _bf16(np.random.default_rng(n + d).standard_normal((n, d)))
    got = sk.read_all(t, full_reduce)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    want = _fold_reduce(x) if full_reduce else _fold_touch(x, sk.TILE_ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 8, 1031, 2051])
@pytest.mark.parametrize("full_reduce", [True, False])
def test_read_all_on_ragged_row_counts(n, full_reduce):
    """Any n: rows are of class row mod 8 (reduce) or folded when row mod
    TILE_ROWS < 8 (touch); a class no row falls in stays -inf."""
    t, x = _bf16(np.random.default_rng(n).standard_normal((n, 256)))
    want = np.full((8, 128), -np.inf, np.float32)
    for r in range(n):
        if full_reduce:
            want[r % 8] = np.maximum(want[r % 8],
                                     x[r].reshape(2, 128).max(axis=0))
        elif r % sk.TILE_ROWS < 8:
            want[r % 8] = np.maximum(want[r % 8], x[r, :128])
    np.testing.assert_array_equal(sk.read_all_plain(t, full_reduce).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("span", [1, 32])
def test_gather_rows_matches_numpy(dtype, span):
    rng = np.random.default_rng(span)
    x = (rng.standard_normal((500, 48)) * 40).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    ids = rng.integers(0, 500 - span + 1, 64)
    ids[:20] = ids[20]  # duplicate ids
    got = sk.gather_rows(t, torch.from_numpy(ids), span)
    assert got.dtype == t.dtype and got.shape == (64 * span, 48)
    rows = (ids[:, None] + np.arange(span)).reshape(-1)
    assert torch.equal(got, t[torch.from_numpy(rows)])
    before = sk.gather_rows.launches
    sk.gather_rows(t, torch.from_numpy(ids).to(torch.int32), span)
    assert sk.gather_rows.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_gather_reduce_matches_numpy(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    x = x * 40 if dtype == "int8" else x  # unit variance, or integers
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    ids = rng.integers(0, 300, 1000)
    ids[:500] = 0  # half the ids name row 0
    got = sk.gather_reduce(t, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (64,)
    want = t.float().numpy()[ids].astype(np.float64).sum(0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fn,ids,span", [
    ("gather_rows", [0, 100], 1), ("gather_rows", [-1], 1),
    ("gather_rows", [69], 32), ("gather_reduce", [100], None),
])
def test_ids_out_of_range_raise(fn, ids, span):
    t = torch.zeros((100, 16), dtype=torch.bfloat16)
    args = (t, torch.tensor(ids)) + ((span,) if span else ())
    with pytest.raises(IndexError, match="leave the 100 rows"):
        getattr(sk, fn)(*args)


@pytest.mark.parametrize("bad", ["dtype", "width", "ndim", "float_ids",
                                 "empty_ids", "span"])
def test_shapes_are_validated(bad):
    t = torch.zeros((64, 128), dtype=torch.bfloat16)
    ids = torch.tensor([1, 2])
    with pytest.raises(ValueError):
        if bad == "dtype":
            sk.read_all(t.float(), True)
        elif bad == "width":
            sk.read_all(t[:, :100], True)
        elif bad == "ndim":
            sk.gather_rows(t[0], ids)
        elif bad == "float_ids":
            sk.gather_rows(t, ids.float())
        elif bad == "empty_ids":
            sk.gather_reduce(t, ids[:0])
        elif bad == "span":
            sk.gather_rows(t, ids, 0)


@pytest.mark.parametrize("m,seg_chunks,lanes,blocks", [
    (131_072, 96, 32, 16_384),   # 1,536-byte rows: a warp a row
    (10_240, 48, 16, 640),       # 768-byte rows: half a warp, no idle lane
    (4_096, 3_072, 32, 512),     # 32-row spans
    (777, 1, 4, 13),             # 16-byte rows: the narrowest group
    (1, 96, 32, 1), (1, 1, 4, 1),
    (5, 6, 8, 1),                # 96-byte rows: 8 lanes leave 2 idle, as 4 would
    (10 ** 9, 96, 32, 1 << 20),  # the grid is capped; groups walk on
])
def test_gather_plan(m, seg_chunks, lanes, blocks):
    assert sk.gather_plan(m, seg_chunks) == (lanes, blocks)


@pytest.mark.parametrize("m,seg_chunks", [(0, 4), (4, 0)])
def test_gather_plan_refuses_empty_work(m, seg_chunks):
    with pytest.raises(ValueError):
        sk.gather_plan(m, seg_chunks)


@pytest.mark.parametrize("m,seg_chunks,max_blocks", [
    (1, 96, 1 << 20), (37, 48, 1 << 20), (3, 3_072, 1 << 20), (50, 1, 1 << 20),
    (100, 5, 2), (1_000, 48, 3),  # fewer groups than segments: the stride loop
])
def test_gather_plan_covers_every_chunk_once(m, seg_chunks, max_blocks,
                                             monkeypatch):
    """The kernel's walk, written out: group g of the grid takes segments g,
    g + groups, ...; lane l of it the chunks l, l + lanes, ... Under the
    plan's (lanes, blocks) every chunk of every segment is copied once."""
    monkeypatch.setattr(sk, "_GATHER_MAX_BLOCKS", max_blocks)
    sk.gather_plan.cache_clear()
    lanes, blocks = sk.gather_plan(m, seg_chunks)
    sk.gather_plan.cache_clear()
    groups = blocks * sk._THREADS // lanes
    seen = np.zeros((m, seg_chunks), np.int64)
    for g in range(min(groups, m)):
        for seg in range(g, m, groups):
            for lane in range(lanes):
                seen[seg, lane:seg_chunks:lanes] += 1
    assert (seen == 1).all()


def test_device_ms_retakes_windows_with_dropped_records(monkeypatch):
    """eval/roofline.device_ms on a profiler that drops kernel records: each
    window follows a step the schedule discards; a window that records no
    named kernel, or fewer than `calls` launches of a name some window
    recorded, is taken again; a full window gives the per-call sum of each
    name, 0 for an alternative no window recorded; when every window falls
    short it raises. (The profiler is faked: no card here.)"""
    from torch.autograd import DeviceType

    from cuvs_rag_tpu_torch.eval import roofline

    class Event:
        def __init__(self, key, count, us):
            self.key, self.count = key, count
            self.self_device_time_total = us
            self.device_type = DeviceType.CUDA

    def run(windows, names, calls=20):
        taken = []

        class Profile:
            def __init__(self, activities, schedule):
                self.events = windows[len(taken)]
                self.steps = 0
                taken.append(self)

            def step(self):
                self.steps += 1

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def key_averages(self):
                return [Event(*e) for e in self.events]

        monkeypatch.setattr(torch.profiler, "profile", Profile)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        got = roofline.device_ms(lambda: None, names, calls)
        # a discarded step before each window
        assert all(p.steps == 2 for p in taken)
        return got, len(taken)

    k6 = ("pq_adc_kernel",)
    assert run([[("pq_adc_kernel(a)", 5, 50.0)],
                [("pq_adc_kernel(a)", 20, 200.0)]], k6) == (
        {"pq_adc_kernel": 0.01}, 2)
    # two kernels a call, one name each: the per-call sum of each
    assert run([[("scan_kernel", 20, 400.0), ("merge_kernel", 20, 40.0)]],
               ("scan", "merge")) == ({"scan": 0.02, "merge": 0.002}, 1)
    # alternatives of which a call runs one (K4's scans), and the merge
    k4 = ("ring_kernel", "scan_kernel", "merge_kernel")
    assert run([[("scan_kernel", 20, 400.0), ("merge_kernel", 20, 40.0)]],
               k4) == ({"ring_kernel": 0.0, "scan_kernel": 0.02,
                        "merge_kernel": 0.002}, 1)
    # a merge short in one window, then missing from the next: both taken
    # again, since a call runs it
    assert run([[("ring_kernel", 20, 100.0), ("merge_kernel", 6, 12.0)],
                [("ring_kernel", 20, 100.0)],
                [("ring_kernel", 20, 100.0), ("merge_kernel", 20, 40.0)]],
               k4) == ({"ring_kernel": 0.005, "scan_kernel": 0.0,
                        "merge_kernel": 0.002}, 3)
    for windows in ([[("pq_adc_kernel", 5, 60.0)], [], [("x", 1, 1.0)]],
                    [[], [], [("pq_adc_kernel", 4, 48.0)]], [[], [], []]):
        with pytest.raises(RuntimeError, match="3 windows"):
            run(windows, k6 + ("absent",))
