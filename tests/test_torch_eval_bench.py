"""eval/bench.py of the port, as the JAX package's tests/test_eval_bench.py
holds its own (5 tests): the batch-size sweep, the scaling stress harness
in its plain, chunked and sharded modes with recall against exact ground
truth, its breaking point, and the table."""

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch.eval import bench as bench_lib
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils.config import IVFFlatParams, IVFFlatSearchParams

torch.set_num_threads(1)


def test_batch_size_sweep():
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    rng = np.random.default_rng(42)
    corpus = rng.standard_normal((500, 16)).astype(np.float32)
    queries = rng.standard_normal((50, 16)).astype(np.float32)
    ix = flat.build(FlatParams(tile_n=8), corpus, device="cpu")
    res = bench_lib.batch_size_sweep(
        lambda q, k: flat.search(None, ix, q, k),
        queries, k=5, batch_sizes=(1, 10), iters=2, device="cpu",
    )
    assert len(res) == 2
    assert res[0].batch_size == 1 and res[1].batch_size == 10
    assert all(r.qps > 0 and r.std_s >= 0 for r in res)


@pytest.mark.parametrize("mode", ["plain", "chunked", "sharded"])
def test_scaling_stress_completes(mode):
    rows = bench_lib.scaling_stress(
        "ivf_flat",
        make_params=lambda n: IVFFlatParams(n_lists=8),
        sizes=[256, 512],
        dim=16,
        search_params_fn=lambda n: IVFFlatSearchParams(n_probes=8),
        n_queries=3,
        k=5,
        chunked=mode == "chunked",
        sharded=mode == "sharded",
        dmesh=DeviceMesh(["cpu"] * 2) if mode == "sharded" else None,
        device="cpu",
    )
    assert len(rows) == 2
    assert all(r.ok for r in rows), [r.error for r in rows]
    assert all(r.recall_at_10 == 1.0 for r in rows)  # full probe -> exact
    table = bench_lib.format_table(rows)
    assert "n_vectors" in table and table.count("\n") == 3


def test_device_corpus_is_seeded_per_size():
    a = bench_lib.device_corpus(100, 8, 42, "cpu")
    assert a.dtype == torch.bfloat16 and a.shape == (100, 8)
    assert torch.equal(a, bench_lib.device_corpus(100, 8, 42, "cpu"))
    assert not torch.equal(a[:50], bench_lib.device_corpus(50, 8, 42, "cpu"))
    fn, n_chunks, rows = bench_lib.chunk_maker(600, 8, 42, "cpu")
    assert (n_chunks, rows) == (1, 600)
    assert torch.equal(fn(0), fn(0))
    assert bench_lib.chunk_plan(600_000) == (3, 200_000)


def test_scaling_stress_chunked_rejects_unsupported():
    with pytest.raises(ValueError, match="chunked"):
        bench_lib.scaling_stress(
            "cagra", lambda n: None, sizes=[64], dim=8, chunked=True,
            device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        bench_lib.scaling_stress(
            "ivf_flat", lambda n: None, sizes=[64], dim=8,
            chunked=True, sharded=True, device="cpu")


def test_scaling_stress_breaking_point():
    # a params factory that fails at the second size exercises the
    # breaking-point protocol
    def bad_params(n):
        if n > 300:
            raise MemoryError("synthetic OOM")
        return IVFFlatParams(n_lists=4)

    rows = bench_lib.scaling_stress(
        "ivf_flat", bad_params, sizes=[256, 512, 1024], dim=8,
        search_params_fn=lambda n: IVFFlatSearchParams(n_probes=4),
        n_queries=2, k=3, eval_recall=False, device="cpu",
    )
    assert [r.ok for r in rows] == [True, False]
    assert "MemoryError" in rows[1].error
    assert len(rows) == 2  # stopped at breaking point, 1024 never attempted
    assert bench_lib.format_table([]) == "(no rows)"
