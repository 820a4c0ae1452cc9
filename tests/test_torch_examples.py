"""The port's example scripts (cuvs_rag_tpu_torch/examples/), each run in
this process with `--device cpu` at a small size, as the JAX package's
tests/test_examples.py runs its own. The two real-text demos read the
medical QA fixture that CUVS_RAG_TPU_MEDICAL_QA names; the reference's
file is not in the repository, so they read a synthetic one written
here."""

import os
import runpy
import sys

import pytest
import torch

from cuvs_rag_tpu_torch.rag import datasets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "cuvs_rag_tpu_torch", "examples")


def _run(script, argv, capsys):
    old_argv = sys.argv
    sys.argv = [script] + list(argv)
    try:
        runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    except SystemExit as e:  # argparse demos may sys.exit(0)
        assert not e.code, e.code
    finally:
        sys.argv = old_argv
    return capsys.readouterr().out


@pytest.fixture
def qa_fixture(tmp_path, monkeypatch):
    path = str(tmp_path / "medical_qa.json")
    datasets.save_qa_json(datasets.synthetic_medical_qa(60, seed=3), path)
    monkeypatch.setenv(datasets.MEDICAL_QA_ENV, path)
    monkeypatch.delenv("CUVS_RAG_TPU_ENCODER", raising=False)


@pytest.mark.parametrize("family,placement", [
    ("flat", "single"), ("ivf_pq", "single"), ("ivf_flat", "shard"),
    ("cagra", "replicate")])
def test_demo_rag(family, placement, capsys):
    out = _run("demo_rag.py", ["--device", "cpu", "--n", "120",
                               "--family", family, "--placement", placement],
               capsys)
    assert out.count("\nQ: ") == 3 and "assembled context" in out


def test_demo_elastic(capsys):
    out = _run("demo_elastic.py", ["--device", "cpu"], capsys)
    assert "healed=True, now on 6 positions" in out
    assert "self-retrieval after heal: [3, 2048, 4000]" in out


def test_demo_serving_views(capsys):
    out = _run("demo_serving_views.py", ["--device", "cpu"], capsys)
    assert out.rstrip().endswith("OK")


def test_demo_hybrid(qa_fixture, capsys):
    out = _run("demo_hybrid.py", ["5", "--device", "cpu"], capsys)
    assert "hybrid BM25+dense (rrf): hit@5" in out


def test_demo_sharded_rag(capsys):
    out = _run("demo_sharded_rag.py", ["--device", "cpu", "--positions", "4",
                                       "--n", "200"], capsys)
    assert "sharded end-to-end RAG flow OK" in out


def test_medical_qa_demo(qa_fixture, capsys):
    out = _run("medical_qa_demo.py", ["--device", "cpu"], capsys)
    for family in ("flat", "ivf_flat", "ivf_pq", "cagra"):
        assert f"{family:10s} paired-answer hit-rate@5" in out


@pytest.mark.parametrize("mode", [[], ["--chunked"],
                                  ["--sharded", "--positions", "2"]])
def test_stress_test(mode, capsys):
    out = _run("stress_test.py", ["--device", "cpu", "--sizes", "256", "512",
                                  "--dim", "16", *mode], capsys)
    assert "breaking point: none reached" in out


def test_wikipedia_pipeline(capsys):
    out = _run("wikipedia_pipeline.py", ["--device", "cpu", "--n", "2048",
                                         "--dim", "32", "--positions", "2"],
               capsys)
    assert "placements agree on results" in out
    assert out.count("batch= 50") == 3


def test_a_row_store_corpus_builds_as_in_the_jax_package(tmp_path):
    """Retriever.build reads a MemmapStore corpus whole (np.asarray, as
    the JAX package does), where it used to hand the store to the build."""
    import numpy as np

    from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.host_store import materialize_from_chunks
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever

    texts = [f"passage number {i}" for i in range(40)]
    enc = HashingEncoder(dim=32)
    emb = enc.encode(texts)
    store = materialize_from_chunks(str(tmp_path / "e.bin"),
                                    lambda i: emb[i * 20:(i + 1) * 20],
                                    40, 32, 2, dtype="float32")
    r = Retriever.build(Corpus(passages=texts, embeddings=store), enc,
                        device="cpu")
    assert r.retrieve(texts[7], 1).passages[0].index == 7
    np.testing.assert_array_equal(
        r.index.vectors[:40].numpy(), emb.astype(np.float32))
