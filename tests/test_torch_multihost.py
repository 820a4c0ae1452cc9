"""The port's multi-process path on the CPU: two gloo ranks started by
cuvs_rag_tpu_torch/infra/run_multihost.sh (torchrun) run the worker
(cuvs_rag_tpu_torch/infra/multihost_worker.py) and the CLI. Each rank holds
only its own shards, and every rank must print the answer of one process
holding both shards (DeviceMesh(["cpu"] * 2)) and, for flat, of the numpy
oracle. The per-rank checkpoint round-trips, and loads in one process,
exactly on two positions and by a rebuild on one. The counterpart of the
JAX package's tests/test_multihost.py (marked slow there)."""

import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch.index import io
from cuvs_rag_tpu_torch.infra import multihost_worker as worker
from cuvs_rag_tpu_torch import main as tmain
from cuvs_rag_tpu_torch.parallel import distributed
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(REPO, "cuvs_rag_tpu_torch", "infra", "run_multihost.sh")
TIMEOUT_S = 240


def _launch(args, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    proc = subprocess.run(
        [LAUNCH, "--standalone", "--nproc_per_node=2", *args],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _one_process():
    dm = DeviceMesh(["cpu"] * 2)
    return worker.family_sums(
        lambda fam, params, corpus: psearch.build_sharded(fam, params, corpus,
                                                          dm),
        lambda sp, ix, q, k: psearch.search_sharded(sp, ix, q, k, dm))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mh_ckpt")
    out = _launch(["-m", "cuvs_rag_tpu_torch.infra.multihost_worker",
                   "--device", "cpu"],
                  {"CUVS_RAG_TPU_MULTIHOST_CKPT": str(ckpt)})
    return out, str(ckpt)


def test_two_ranks_give_the_one_process_answer(two_ranks):
    out, _ = two_ranks
    oks = re.findall(r"MULTIHOST OK (\d+) rank (\d) of 2", out)
    assert sorted(r for _, r in oks) == ["0", "1"], out
    sums = [json.loads(m) for m in
            re.findall(r"MULTIHOST SUMS (\{[^}]*\})", out)]
    assert len(sums) == 2 and sums[0] == sums[1]
    corpus, queries = worker.corpus_and_queries()
    oracle = int(worker.oracle(corpus, queries).sum())
    assert {int(c) for c, _ in oks} == {oracle}
    one, agree, _ = _one_process()
    assert sums[0] == one  # every family, not only flat
    assert agree["flat"] == 1.0


def test_rank_checkpoint_loads_in_one_process(two_ranks):
    _, ckpt = two_ranks
    prefix = os.path.join(ckpt, "mh_ckpt")
    with open(prefix + ".json") as f:
        meta = json.load(f)
    assert meta["num_shards"] == 2 and meta["family"] == "cagra"
    assert sorted(os.listdir(ckpt)) == ["mh_ckpt.json", "mh_ckpt_part0.npz",
                                        "mh_ckpt_part1.npz"]
    _, _, (index, sp, ids) = _one_process()
    corpus, queries = worker.corpus_and_queries()
    dm2 = DeviceMesh(["cpu"] * 2)
    back = io.load_sharded(prefix, dm2)
    _, got = psearch.search_sharded(sp, back, queries, worker.K, dm2)
    np.testing.assert_array_equal(got.numpy(), ids)
    params = worker.families()[-1][1]
    rebuilt = io.load_sharded(prefix, DeviceMesh(["cpu"]), params=params)
    assert rebuilt.num_shards == 1 and rebuilt.total == worker.N
    _, got = psearch.search_sharded(sp, rebuilt, queries, worker.K)
    assert got.shape == (len(queries), worker.K)


def test_cli_under_the_launcher_matches_one_process():
    """run_multihost.sh sets CUVS_RAG_TPU_MULTIHOST: each rank of the CLI
    joins the group and holds one shard of two; both print the one-process
    result over two positions (recall and purity; times differ)."""
    flags = ["--n", "2048", "--dim", "16", "--n-queries", "10", "--k", "5",
             "--family", "ivf_flat", "--n-lists", "8", "--n-probes", "2",
             "--json"]
    out = _launch(["-m", "cuvs_rag_tpu_torch.main", *flags,
                   "--device", "cpu"])
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("[{")]
    assert len(lines) == 2
    one = json.loads(json.dumps(tmain.main(flags + ["--device", "cpu",
                                                    "--positions", "2"])))
    for res in lines:
        assert [(r["family"], r["recall"], r["topic_purity"]) for r in res] \
            == [(r["family"], r["recall"], r["topic_purity"]) for r in one]


def test_one_process_is_not_a_group():
    assert not distributed.is_initialized()
