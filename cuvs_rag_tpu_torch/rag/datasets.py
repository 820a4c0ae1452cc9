"""Dataset preparation — reference component #11 (SURVEY.md §2).

A copy of the JAX package's `rag/datasets.py` (it imports no JAX), except
where the reference's 100-pair fixture is looked for: only where the caller
or CUVS_RAG_TPU_MEDICAL_QA says.

Mirrors `Latest/cuVS-2-gpu/prepare_dataset.py`: load the medical-QA dataset
from HF when available (prepare_dataset.py:30-34), fall back to a synthetic
medical corpus (:55-94), save JSON + a small test set (:112-129). Also the
synthetic topic-template corpora the stress notebooks generate
(cuVS_Scaling_Stress_Test.ipynb#cell6; richer variant
cuvs-2gpu-main.ipynb#cell6) — used here for recall tests with *topic* ground
truth as well as exact ground truth.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np

MEDICAL_TOPICS = [
    "diabetes", "hypertension", "asthma", "arthritis", "migraine",
    "influenza", "pneumonia", "anemia", "eczema", "insomnia",
]

_TEMPLATES = [
    "What are the common symptoms of {t}?",
    "How is {t} diagnosed by physicians?",
    "What treatment options exist for {t}?",
    "Can lifestyle changes help manage {t}?",
    "What are the risk factors associated with {t}?",
    "Is {t} hereditary or environmental?",
    "What complications can arise from untreated {t}?",
    "How does {t} affect daily activities?",
]

_ANSWERS = [
    "Clinical guidance for {t}: early evaluation is recommended, followed by "
    "standard monitoring and an individualized care plan.",
    "Management of {t} typically combines medication with lifestyle "
    "adjustments; follow-up intervals depend on severity.",
    "Patients with {t} should track symptoms and consult a specialist when "
    "symptoms change or worsen.",
]


@dataclasses.dataclass
class QARecord:
    instruction: str
    input: str
    output: str
    topic: str


def synthetic_medical_qa(n: int = 1000, seed: int = 42) -> List[QARecord]:
    """Synthetic medical QA triples (prepare_dataset.py:55-94 fallback)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = MEDICAL_TOPICS[int(rng.integers(len(MEDICAL_TOPICS)))]
        q = _TEMPLATES[int(rng.integers(len(_TEMPLATES)))].format(t=t)
        a = _ANSWERS[int(rng.integers(len(_ANSWERS)))].format(t=t)
        out.append(QARecord(
            instruction="Answer the medical question.", input=q, output=a,
            topic=t,
        ))
    return out


def load_medical_qa(
    n: int = 1000, seed: int = 42, allow_download: bool = False
) -> Tuple[List[QARecord], str]:
    """Load `Malikeh1375/medical-question-answering-datasets`
    (prepare_dataset.py:30-34) or fall back to synthetic. Returns
    (records, source). Zero-egress environments always get the fallback."""
    if allow_download:
        try:
            from datasets import load_dataset  # type: ignore

            ds = load_dataset(
                "Malikeh1375/medical-question-answering-datasets",
                "all-processed", split="train",
            )
            recs = [
                QARecord(
                    instruction=r.get("instruction", ""),
                    input=r.get("input", ""),
                    output=r.get("output", ""),
                    topic="",
                )
                for r in ds.select(range(min(n, len(ds))))
            ]
            return recs, "huggingface"
        except Exception:
            pass
    return synthetic_medical_qa(n, seed), "synthetic"


def save_qa_json(records: List[QARecord], path: str, test_size: int = 100) -> None:
    """Save full JSON + a {path%.json}_test.json sample
    (prepare_dataset.py:112-129)."""
    rows = [dataclasses.asdict(r) for r in records]
    with open(path, "w") as f:
        json.dump(rows, f)
    stem, ext = os.path.splitext(path)
    with open(f"{stem}_test{ext}", "w") as f:
        json.dump(rows[:test_size], f)


def load_qa_json(path: str) -> List[QARecord]:
    with open(path) as f:
        return [QARecord(**r) for r in json.load(f)]


# The reference ships 100 REAL medical QA pairs as data
# (Latest/cuVS-2-gpu/medical_qa_data/medical_qa_test.json — the
# prepare_dataset.py:112-129 test split of the HF medical-QA dataset).
# Read-only data fixture, not code; used for the real-text end-to-end demo.
# It is not in this repository: CUVS_RAG_TPU_MEDICAL_QA names its path.
MEDICAL_QA_ENV = "CUVS_RAG_TPU_MEDICAL_QA"


def load_reference_medical_qa(path: str | None = None) -> List[QARecord]:
    """Load the reference's real 100-pair medical QA fixture.

    Records are {instruction, input (patient question), output (doctor
    answer)}; topic is unknown ("") for real data. Raises FileNotFoundError
    when the fixture isn't present (callers/tests skip then).
    """
    path = path or os.environ.get(MEDICAL_QA_ENV)
    if not path:
        raise FileNotFoundError(
            f"no medical QA fixture: pass its path or set {MEDICAL_QA_ENV}")
    with open(path) as f:
        rows = json.load(f)
    return [
        QARecord(
            instruction=r.get("instruction", ""),
            input=r.get("input", ""),
            output=r.get("output", ""),
            topic=r.get("topic", ""),
        )
        for r in rows
    ]


def synthetic_topic_corpus(
    n: int, dim: int, n_topics: int = 50, spread: float = 0.5, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic embedding corpus with topic structure
    (stress-notebook generators, cuVS_Scaling_Stress_Test.ipynb#cell6).

    Returns (embeddings (n, dim) fp32, topic_labels (n,), topic_centers).
    """
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((n_topics, dim)) * 3).astype(np.float32)
    labels = rng.integers(0, n_topics, n)
    emb = centers[labels] + spread * rng.standard_normal((n, dim)).astype(np.float32)
    return emb.astype(np.float32), labels, centers


def topic_queries(
    centers: np.ndarray, n_queries: int, spread: float = 0.5, seed: int = 7
) -> Tuple[np.ndarray, np.ndarray]:
    """Queries drawn near topic centers + their topic labels (the reference's
    topic-based ground-truth protocol, cuvs-2gpu-main.ipynb#cell6,#cell14)."""
    rng = np.random.default_rng(seed)
    n_topics, dim = centers.shape
    qlabels = rng.integers(0, n_topics, n_queries)
    q = centers[qlabels] + spread * rng.standard_normal((n_queries, dim)).astype(np.float32)
    return q.astype(np.float32), qlabels


def topic_recall(
    retrieved_ids: np.ndarray, corpus_labels: np.ndarray, query_labels: np.ndarray
) -> float:
    """Fraction of retrieved passages sharing the query's topic — the
    reference's recall metric done *right* (its version compared ids against
    random GT and scored ~0, SURVEY.md §6)."""
    hits, total = 0, 0
    for row, ql in zip(retrieved_ids, query_labels):
        for rid in row:
            if rid >= 0:
                total += 1
                hits += int(corpus_labels[rid] == ql)
    return hits / max(total, 1)
