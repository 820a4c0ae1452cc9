"""The port's measurement scripts (cuvs_rag_tpu_torch/scripts/) against the
JAX package's on the CPU: the shared helpers of scripts/common.py (the
streamed exact ground truth against the JAX package's flat search of the
concatenated chunks, the seeded chunks, bench.py's recall), the chunked
builds the north-star and capacity scripts run (recall within 0.02 of the
JAX package's builds on the same chunks, the Port conventions' build
parity), the out-of-core refine's exact distances, and each of the ten
scripts end to end at a few thousand rows with --device cpu.

Tolerance: the exact searches score the same rows with fp32 sums in
another order: distances rtol 1e-5 / atol 1e-3, ids up to swaps among
scores tied with the k-th (utils/compare.compare_topk). Builds draw other
random numbers (torch.Generator vs jax.random): recall within 0.02.
"""

import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.index import ivf_pq as jpq
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.index import ivf_flat as tivf
from cuvs_rag_tpu_torch.index import ivf_pq as tpq
from cuvs_rag_tpu_torch.rag.host_store import materialize_from_chunks
from cuvs_rag_tpu_torch.scripts import bench_pq_capacity, common
from cuvs_rag_tpu_torch.utils import config as tconfig
from torch_parity import compare_topk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the JAX package's bench.py: no jax at import)

TOL = dict(rtol=1e-5, atol=1e-3)
BUILD_TOL = 0.02
CPU = torch.device("cpu")
CHUNKS, ROWS, DIM, LISTS, Q, K = 8, 512, 32, 16, 200, 10


@pytest.fixture(scope="module")
def chunks():
    """8 numpy chunks of 512 rows around 16 centres, and 200 queries (at
    40, two PQ builds' ADC recall spreads past 0.02 on sampling alone)."""
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((LISTS, DIM)).astype(np.float32) * 3
    def draw(m):
        return (centres[rng.integers(0, LISTS, m)]
                + rng.standard_normal((m, DIM))).astype(np.float32)
    return [draw(ROWS) for _ in range(CHUNKS)], draw(Q)


def _recall_of(ids, gt):
    return common.recall(np.asarray(ids), gt, K)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_ground_truth_equals_jax_flat_search(chunks, dtype):
    parts, q = chunks
    if dtype == "bfloat16":
        parts = [torch.from_numpy(p).to(torch.bfloat16) for p in parts]
    d, ids = common.streamed_ground_truth(
        lambda i: parts[i], CHUNKS, ROWS, torch.from_numpy(q), K)
    whole = np.concatenate([np.asarray(torch.as_tensor(p).float())
                            for p in parts])
    jix = jflat.build(jconfig.FlatParams(dtype=dtype), jnp.asarray(whole))
    jd, ji = jflat.search(None, jix, jnp.asarray(q), K)
    compare_topk(-d, ids, -np.asarray(jd), np.asarray(ji), **TOL)


def test_make_chunk_is_the_same_in_any_order():
    geo = common.clustered(3, 8, 16, 0.3, CPU)
    forward = [common.make_chunk(3, i, 100, geo, CPU) for i in range(4)]
    backward = [common.make_chunk(3, i, 100, geo, CPU) for i in (3, 2, 1, 0)]
    for i in range(4):
        assert forward[i].dtype == torch.bfloat16
        assert torch.equal(forward[i], backward[3 - i])
    assert not torch.equal(forward[0], forward[1])
    assert not torch.equal(forward[0], common.make_chunk(4, 0, 100, geo, CPU))
    corpus = common.make_corpus(3, 400, geo, CPU, n_chunks=4)
    assert torch.equal(corpus[100:200], forward[1])


def test_recall_equals_bench_py():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 50, (30, 12))
    gt = rng.integers(0, 50, (30, 12))
    for k in (1, 5, 12):
        assert common.recall(ids, gt, k) == jbench._recall(ids, gt, k)


def _oracle(chunks):
    parts, q = chunks
    whole = np.concatenate(parts)
    jix = jflat.build(jconfig.FlatParams(dtype="float32"), jnp.asarray(whole))
    return np.asarray(jflat.search(None, jix, jnp.asarray(q), K)[1])


def test_int8_ivf_flat_chunked_build_matches_jax(chunks):
    parts, q = chunks
    gt = _oracle(chunks)
    n = CHUNKS * ROWS
    jix = jivf.build_from_chunks(
        jconfig.IVFFlatParams(n_lists=LISTS, dtype="int8"),
        lambda i: jnp.asarray(parts[i]), n, DIM, n_chunks=CHUNKS)
    tix = tivf.build_from_chunks(
        tconfig.IVFFlatParams(n_lists=LISTS, dtype="int8"),
        lambda i: parts[i], n, DIM, n_chunks=CHUNKS, device="cpu")
    assert tix.vectors.dtype == torch.int8
    for probes in (2, 4):
        want = _recall_of(jivf.search(jconfig.IVFFlatSearchParams(
            n_probes=probes), jix, jnp.asarray(q), K)[1], gt)
        got = _recall_of(tivf.search(tconfig.IVFFlatSearchParams(
            n_probes=probes), tix, torch.from_numpy(q), K)[1], gt)
        assert abs(got - want) <= BUILD_TOL, (probes, got, want)


def test_codes_only_ivf_pq_chunked_build_matches_jax(chunks):
    parts, q = chunks
    gt = _oracle(chunks)
    n = CHUNKS * ROWS
    common_kw = dict(n_lists=LISTS, pq_dim=8, store_raw=False)
    jix = jpq.build_from_chunks(
        jconfig.IVFPQParams(**common_kw), lambda i: jnp.asarray(parts[i]),
        n, DIM, n_chunks=CHUNKS)
    tix = tpq.build_from_chunks(
        tconfig.IVFPQParams(**common_kw), lambda i: parts[i], n, DIM,
        n_chunks=CHUNKS, device="cpu")
    assert not tix.has_raw and tix.raw_vectors.numel() == 0
    for probes in (4, 8):
        want = _recall_of(jpq.search(jconfig.IVFPQSearchParams(
            n_probes=probes, refine_ratio=0), jix, jnp.asarray(q), K)[1], gt)
        got = _recall_of(tpq.search(tconfig.IVFPQSearchParams(
            n_probes=probes, refine_ratio=0), tix, torch.from_numpy(q),
            K)[1], gt)
        assert abs(got - want) <= BUILD_TOL, (probes, got, want)


def test_memmap_refined_search_returns_exact_distances(chunks, tmp_path):
    parts, q = chunks
    n = CHUNKS * ROWS
    tix = tpq.build_from_chunks(
        tconfig.IVFPQParams(n_lists=LISTS, pq_dim=8, store_raw=False),
        lambda i: parts[i], n, DIM, n_chunks=CHUNKS, device="cpu")
    bf = [torch.from_numpy(p).to(torch.bfloat16) for p in parts]
    store = materialize_from_chunks(str(tmp_path / "rows.bin"),
                                    lambda i: bf[i], n, DIM, CHUNKS)
    # the store holds the chunks' own bf16 bits
    np.testing.assert_array_equal(
        store.fetch_rows(np.arange(ROWS, 2 * ROWS)), bf[1].float().numpy())
    qt = torch.from_numpy(q)
    d, ids = tpq.search(tconfig.IVFPQSearchParams(n_probes=8, refine_ratio=8),
                        tix, qt, K, fetch_rows=store.fetch_rows,
                        host_rerank=True)
    err, scale = bench_pq_capacity.exact_distance_error(
        qt, d, ids, store.fetch_rows)
    assert (ids >= 0).all() and err <= TOL["atol"] + TOL["rtol"] * scale


A = ["--device", "cpu", "--dim", "32"]
SCRIPTS = {
    "bench_10m": (A + ["--n", "8000", "--chunks", "4", "--n-lists", "16",
                       "--kmeans-sample", "4000"],
                  [r"exact GT \(streamed, bf16\)", r"build \d+s  layout",
                   r"nprobe=10: .* recall@10=", r"nprobe=32: "]),
    "bench_pq_capacity": (A + ["--n", "6000", "--chunk-rows", "2000",
                               "--n-lists", "16", "--probes", "4",
                               "--kmeans-sample", "4000", "--intrinsic-dim",
                               "8", "--opq", "--refine-external", "8"],
                          [r"build \d+s  codes", r"peak device memory",
                           r"nprobe=4 ADC-only: .* recall@10=",
                           r"nprobe=4 refine=8( host-store)?: "]),
    "bench_batch1": (A + ["--n", "2048", "--n-lists", "16"],
                     [r"flat-exact +wall .* device not measured",
                      r"ivf-nprobe10 +wall .* pipelined "]),
    "bench_topk_large": (["100"] + A + ["--n", "2048"],
                         [r"corpus ready; k=100", r"large-k kernel",
                          r"torch exact scan", r"approx=True",
                          r"id agreement@100: 1\.00000"]),
    "bench_int8_flat": (A + ["--n", "2048"],
                        [r"bfloat16: .* ms/q", r"int8: .* GB/s",
                         r"int8 vs bf16 id agreement@5: ", r"speedup"]),
    "bench_ivf_int8": (A + ["--n", "2048", "--n-lists", "16"],
                       [r"bfloat16 nprobe=10: .* recall@10=",
                        r"int8 nprobe=20: .* recall@10="]),
    "bench_ivf_pq": (A + ["--n", "2048", "--n-lists", "16"],
                     [r"pq8 refine=0: .* recall@10=",
                      r"pq4 refine=16: .* recall@10="]),
    "bench_filters": (A + ["--n", "2048", "--n-lists", "16"],
                      [r"flat   search .* filtered", r"ivf    search .* warm"]),
    "bench_tune": (A + ["--n", "2048", "--n-lists", "16", "--families",
                        "ivf_flat", "ivf_pq", "--targets", "0.9"],
                   [r"=== ivf_flat", r"target 0\.9: ", r"\| ivf_pq \| 0\.9 \|"]),
    "bench_family_curves": (["uniform", "1024"] + A,
                            [r"=== uniform corpus, N=1024 ===",
                             r"flat exact floor", r"ivf nprobe=  1:",
                             r"cagra itopk= 32", r"target 0\.95: "]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_runs_on_the_cpu(name, capsys, tmp_path, monkeypatch):
    argv, lines = SCRIPTS[name]
    if name == "bench_pq_capacity":
        argv = argv + ["--memmap-store", str(tmp_path / "rows.bin")]
    mod = importlib.import_module(f"cuvs_rag_tpu_torch.scripts.{name}")
    if name == "bench_family_curves":
        # CAGRA's beam at itopk 128-512 takes minutes on one CPU thread
        monkeypatch.setattr(mod, "CAGRA_POINTS", mod.CAGRA_POINTS[:3])
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu"
    for pattern in lines:
        assert re.search(pattern, out), (pattern, out)


def test_capacity_host_store_holds_the_devices_rows(capsys):
    out = bench_pq_capacity.run(bench_pq_capacity.parse_args(
        SCRIPTS["bench_pq_capacity"][0] + ["--host-store"]))
    assert "host store (" in out["refine_source"]
    refined = [p for p in out["points"] if p["refine_ratio"]]
    assert refined and all(p["host_rerank"] for p in refined)
    assert all(p["distance_error"] <= TOL["atol"] + TOL["rtol"]
               * p["distance_scale"] for p in refined)
    assert "refine=8 host-store" in capsys.readouterr().out
