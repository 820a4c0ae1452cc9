"""cuvs_rag_tpu_torch.rag.datasets against the JAX package's
rag/datasets.py: the synthetic medical QA records, the JSON files, the
topic corpora and their recall, all equal (the module is a copy). Only the
synthetic and fixture paths run here: allow_download stays False.
"""

import dataclasses
import json

import numpy as np
import pytest

from cuvs_rag_tpu.rag import datasets as jds
from cuvs_rag_tpu_torch.rag import datasets as tds


@pytest.mark.parametrize("n,seed", [(1, 0), (50, 42), (1000, 7)])
def test_synthetic_medical_qa_equals_the_jax_package(n, seed):
    got = [dataclasses.asdict(r) for r in tds.synthetic_medical_qa(n, seed)]
    want = [dataclasses.asdict(r) for r in jds.synthetic_medical_qa(n, seed)]
    assert got == want
    recs, source = tds.load_medical_qa(n, seed, allow_download=False)
    assert source == "synthetic" and [dataclasses.asdict(r)
                                      for r in recs] == want


def test_qa_json_round_trips_both_ways(tmp_path):
    recs = tds.synthetic_medical_qa(120)
    tds.save_qa_json(recs, str(tmp_path / "port.json"), test_size=10)
    jds.save_qa_json(jds.synthetic_medical_qa(120), str(tmp_path / "jax.json"),
                     test_size=10)
    for name in ("port.json", "port_test.json"):
        assert (tmp_path / name).read_text() == \
            (tmp_path / name.replace("port", "jax")).read_text()
    back = tds.load_qa_json(str(tmp_path / "jax.json"))
    assert [dataclasses.asdict(r) for r in back] == \
        [dataclasses.asdict(r) for r in recs]
    assert len(tds.load_qa_json(str(tmp_path / "port_test.json"))) == 10


def test_the_reference_fixture_is_read_from_where_the_caller_says(
        tmp_path, monkeypatch):
    rows = [{"instruction": "i", "input": "a patient question",
             "output": "a doctor answer"}]
    path = tmp_path / "medical_qa_test.json"
    path.write_text(json.dumps(rows))
    got = tds.load_reference_medical_qa(str(path))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in jds.load_reference_medical_qa(
            str(path))]
    monkeypatch.setenv(tds.MEDICAL_QA_ENV, str(path))
    assert tds.load_reference_medical_qa()[0].input == "a patient question"
    monkeypatch.delenv(tds.MEDICAL_QA_ENV)
    with pytest.raises(FileNotFoundError):
        tds.load_reference_medical_qa()


@pytest.mark.parametrize("n,dim,topics", [(500, 16, 5), (2000, 64, 50)])
def test_topic_corpora_equal_the_jax_package(n, dim, topics):
    got = tds.synthetic_topic_corpus(n, dim, n_topics=topics, seed=3)
    want = jds.synthetic_topic_corpus(n, dim, n_topics=topics, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    q, ql = tds.topic_queries(got[2], 40, seed=9)
    jq, jql = jds.topic_queries(want[2], 40, seed=9)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(ql, jql)
    ids = np.random.default_rng(1).integers(-1, n, (40, 5))
    assert tds.topic_recall(ids, got[1], ql) == \
        jds.topic_recall(ids, want[1], jql)
