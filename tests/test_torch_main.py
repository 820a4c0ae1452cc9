"""The port's CLI (`python -m cuvs_rag_tpu_torch.main`) against the JAX
package's (`cuvs_rag_tpu.main`) on the same flags: the JAX package on its
eight virtual CPU devices (tests/conftest.py), the port on eight mesh
positions of the CPU (`--device cpu --positions 8`). The corpus, queries
and exact ground truth are the same arrays (rag/datasets is a byte copy),
so the result keys, flat's recall and the topic purity must be equal; the
approximate families' builds draw other random numbers, so their
recall@10 is held within 0.02 of the JAX package's."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cuvs_rag_tpu import main as jmain
from cuvs_rag_tpu_torch import main as tmain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--n", "4096", "--dim", "32", "--n-queries", "20", "--json"]
PORT = ["--device", "cpu", "--positions", "8"]
APPROX_TOL = 0.02


def _compare(tres, jres, tune_target=0.0):
    """Equal keys, flat recall and topic purity; approximate recall@10
    within APPROX_TOL of the JAX package's. A tuned family runs at the
    params each package's tuner chose on its own build (the cheapest that
    reached the target there), so its recall is held to the target, less
    APPROX_TOL for the second build, instead of to the other package's."""
    assert [r["family"] for r in tres] == [r["family"] for r in jres]
    for t, j in zip(tres, jres):
        assert set(t) == set(j), t["family"]
        assert set(t["recall"]) == set(j["recall"])
        assert t["topic_purity"] == j["topic_purity"]
        if t["family"] == "flat":
            assert t["recall"] == j["recall"]
        elif "tuned" in t:
            assert set(t["tuned"]) == set(j["tuned"])
            for r in (t, j):
                assert r["tuned"]["recall"] >= tune_target
                assert r["recall"][10] >= tune_target - APPROX_TOL, r
        else:
            assert abs(t["recall"][10] - j["recall"][10]) <= APPROX_TOL, \
                (t, j)


@pytest.fixture(scope="module")
def all_families():
    argv = COMMON + ["--family", "all"]
    return tmain.main(argv + PORT), jmain.main(argv)


def test_all_families_match_the_jax_package(all_families, capsys):
    tres, jres = all_families
    _compare(tres, jres)
    assert [r["family"] for r in tres] == ["flat", "ivf_flat", "ivf_pq",
                                           "cagra"]
    for r in tres:
        assert r["build_s"] >= 0 and r["search_ms_batch"] > 0
        assert r["search_ms_per_query"] == pytest.approx(
            r["search_ms_batch"] / 20, abs=1e-4)


def test_json_output_is_the_result(capsys):
    res = tmain.main(COMMON + PORT + ["--family", "flat"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(res))


def test_replicate_matches_the_jax_package():
    argv = COMMON + ["--family", "ivf_flat", "--placement", "replicate",
                     "--n-probes", "2"]
    _compare(tmain.main(argv + PORT), jmain.main(argv))


def test_tune_matches_the_jax_package():
    argv = COMMON + ["--family", "ivf_flat", "--placement", "replicate",
                     "--tune-recall", "0.95"]
    tres = tmain.main(argv + PORT)
    jres = jmain.main(argv)
    _compare(tres, jres, tune_target=0.95)
    assert "tuned" in tres[0] and "tuned" in jres[0]
    assert tres[0]["tuned"]["params"].startswith("IVFFlatSearchParams(")


def test_tune_skips_flat_and_tunes_the_graph():
    res = tmain.main(COMMON + PORT + ["--family", "cagra",
                                      "--tune-recall", "0.9"])
    assert res[0]["tuned"]["params"].startswith("CagraSearchParams(")
    assert res[0]["tuned"]["configs_tried"] >= 1
    res = tmain.main(COMMON + PORT + ["--family", "flat",
                                      "--tune-recall", "0.9"])
    assert "tuned" not in res[0]


def test_without_a_card_the_cli_raises():
    """No flag means every visible card; there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh is the card")
    proc = subprocess.run(
        [sys.executable, "-m", "cuvs_rag_tpu_torch.main", "--n", "64",
         "--dim", "8", "--family", "flat"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
