"""Sharded IVF-Flat search quality at partial probe: the port's sharded
index (per-shard k-means, one common probe window, the fan-out merge)
against its single-device build of the same corpus at an EQUAL TOTAL probe
budget (S shards x p lists each == one index probing S x p of lists of the
same mean size), as the JAX package's tests/test_sharded_quality.py and its
multi-device dry run (__graft_entry__.py, 8,192 rows a shard at D = 256)
hold the JAX package.

Recall is against the exact oracle (the JAX package's
eval/recall.exact_ground_truth). The bounds are the JAX package's: within
0.05 of single at every operating point of the curve, within 0.01 at the
dry run's gate, and >= 0.9 at its end.
"""

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.eval import recall as jrecall
from cuvs_rag_tpu_torch.index import ivf_flat
from cuvs_rag_tpu_torch.parallel import search as tps
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils.config import IVFFlatParams, IVFFlatSearchParams

torch.set_num_threads(1)

S = 8
K = 10


def _clustered(n, d, c, n_q, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    corpus = (centers[rng.integers(0, c, n)]
              + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, c, n_q)]
               + 0.25 * rng.standard_normal((n_q, d))).astype(np.float32)
    return corpus, queries, jrecall.exact_ground_truth(corpus, queries, K,
                                                        "sqeuclidean")


def _recall(ids, gt):
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[r]) & set(gt[r])) / K
                          for r in range(len(gt))]))


@pytest.fixture(scope="module")
def setup():
    c = 64
    corpus, queries, gt = _clustered(16384, 64, c, 64, seed=13)
    dmesh = DeviceMesh(["cpu"] * S)
    single = ivf_flat.build(IVFFlatParams(n_lists=c), corpus, device="cpu")
    sharded = tps.build_sharded("ivf_flat", IVFFlatParams(n_lists=c // S),
                                corpus, dmesh)
    return queries, gt, single, sharded, dmesh, c


def test_partial_probe_recall_parity(setup):
    queries, gt, single, sharded, dmesh, c = setup
    curve = {}
    for p_s in (1, 4, 8):
        _, i_sh = tps.search_sharded(IVFFlatSearchParams(n_probes=p_s),
                                     sharded, queries, K, dmesh)
        _, i_sd = ivf_flat.search(
            IVFFlatSearchParams(n_probes=min(S * p_s, c)), single, queries, K)
        r_sh, r_sd = _recall(i_sh, gt), _recall(i_sd, gt)
        curve[p_s] = r_sh
        assert r_sh >= r_sd - 0.05, (p_s, r_sh, r_sd)
    rs = [curve[p] for p in (1, 4, 8)]
    assert rs[0] <= rs[1] + 0.02 <= rs[2] + 0.04
    assert rs[-1] >= 0.9, rs


def test_a_shards_top_k_is_all_it_adds(setup):
    """A candidate outside shard s's local top-k has >= k better rows in
    shard s alone, so it never enters the global top-k: the merged top-k
    (k a shard) is the head of the merged top-3k (3k a shard)."""
    queries, gt, _, sharded, dmesh, _ = setup
    sp = IVFFlatSearchParams(n_probes=4)
    d, i = tps.search_sharded(sp, sharded, queries, K, dmesh)
    d3, i3 = tps.search_sharded(sp, sharded, queries, 3 * K, dmesh)
    assert torch.equal(i, i3[:, :K])
    torch.testing.assert_close(d, d3[:, :K], rtol=0, atol=0)
    assert _recall(i, gt) >= 0.9


def test_dry_run_gate_8192_rows_a_shard_at_d256():
    """The multi-device dry run's gate: 8,192 clustered rows a shard at
    D = 256, 8 probes a shard against one index probing 8 x 8: sharded
    recall@10 >= single - 0.01 and >= 0.9."""
    c = 16 * S
    corpus, queries, gt = _clustered(8192 * S, 256, c, 32, seed=5)
    dmesh = DeviceMesh(["cpu"] * S)
    single = ivf_flat.build(IVFFlatParams(n_lists=c), corpus, device="cpu")
    sharded = tps.build_sharded("ivf_flat", IVFFlatParams(n_lists=c // S),
                                corpus, dmesh)
    _, i_sh = tps.search_sharded(IVFFlatSearchParams(n_probes=8), sharded,
                                 queries, K, dmesh)
    _, i_sd = ivf_flat.search(IVFFlatSearchParams(n_probes=min(S * 8, c)),
                              single, queries, K)
    r_sh, r_sd = _recall(i_sh, gt), _recall(i_sd, gt)
    assert r_sh >= r_sd - 0.01, (r_sh, r_sd)
    assert r_sh >= 0.9, r_sh
