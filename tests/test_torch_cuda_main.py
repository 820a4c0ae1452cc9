"""The port's CLI and multi-process worker on the card. CUDA kernels have
no CPU mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest -q tests/test_torch_cuda_main.py

The CLI at 262,144 x 768 on the card against the same CLI on the CPU from
the same seed: the corpus, queries and oracle are the same arrays, flat's
recall must agree to two ids of the 500 (both score bf16 rows with bf16
queries, the sums in another order, so only rows tied at the 10th within
fp32 rounding swap), and the IVF builds draw other random numbers on the
card, so their recall@10 is held within 0.02 (the CPU tests' rule against
the JAX package). CAGRA is left out: its CPU build at this size takes
minutes.
"""

import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--n", "262144", "--dim", "768", "--n-queries", "50", "--json"]
APPROX_TOL = 0.02
# two of the 50 x 10 result ids (recall is a share of them)
FLAT_SWAPS = 2 / 500


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("family,extra", [
    ("flat", []), ("ivf_flat", []),
    # IVF-PQ where its recall is high: at the CLI's refine 2 it reads ~0.35
    # on this corpus, where two builds' recall spreads past 0.02
    ("ivf_pq", ["--refine-ratio", "100"])])
def test_cli_on_the_card_matches_the_cpu(cuda_device, family, extra):
    from cuvs_rag_tpu_torch import main as cli

    card = cli.main(FLAGS + extra + ["--family", family])[0]
    cpu = cli.main(FLAGS + extra + ["--family", family, "--device", "cpu"])[0]
    assert set(card) == set(cpu)
    assert card["topic_purity"] == cpu["topic_purity"]
    if family == "flat":
        # both score bf16 rows with bf16 queries, sums in another order:
        # ids swap only among rows tied at the 10th within fp32 rounding
        for k in card["recall"]:
            assert abs(card["recall"][k] - cpu["recall"][k]) <= FLAT_SWAPS
        assert card["recall"][10] >= 0.95
    else:
        assert abs(card["recall"][10] - cpu["recall"][10]) <= APPROX_TOL, \
            (card, cpu)


def test_cli_tunes_on_the_card(cuda_device):
    from cuvs_rag_tpu_torch import main as cli

    res = cli.main(FLAGS + ["--family", "ivf_flat", "--tune-recall", "0.95",
                            "--positions", "4"])[0]
    assert res["tuned"]["recall"] >= 0.95
    assert res["recall"][10] >= 0.95 - APPROX_TOL


def test_cli_without_flags_runs_on_the_card(cuda_device):
    proc = subprocess.run(
        [sys.executable, "-m", "cuvs_rag_tpu_torch.main", "--n", "20000",
         "--dim", "64", "--family", "all", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["family"] for r in res] == ["flat", "ivf_flat", "ivf_pq",
                                          "cagra"]


def test_two_nccl_ranks_run_the_worker(cuda_device, tmp_path):
    """One rank a card: needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL takes one rank a card: needs two cards")
    from cuvs_rag_tpu_torch.infra import multihost_worker as worker

    env = dict(os.environ, CUVS_RAG_TPU_MULTIHOST_CKPT=str(tmp_path))
    proc = subprocess.run(
        [os.path.join(REPO, "cuvs_rag_tpu_torch", "infra",
                      "run_multihost.sh"), "--standalone",
         "--nproc_per_node=2", "-m",
         "cuvs_rag_tpu_torch.infra.multihost_worker"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    oks = re.findall(r"MULTIHOST OK (\d+) rank (\d) of 2", proc.stdout)
    corpus, queries = worker.corpus_and_queries()
    assert sorted(r for _, r in oks) == ["0", "1"]
    assert {int(c) for c, _ in oks} == {int(worker.oracle(corpus,
                                                          queries).sum())}
