"""Real-data RAG end-to-end: the reference's 100 real medical QA pairs.

The counterpart of the JAX package's `examples/medical_qa_demo.py`. The
reference ran on real text (medical-QA corpus, prepare_dataset.py:30-34;
retrieval printout VectorSearch_QuestionRetrieval.ipynb#cell6). This demo
drives the same flow on the reference's real fixture
(medical_qa_data/medical_qa_test.json, whose path `CUVS_RAG_TPU_MEDICAL_QA`
names): doctor answers are the passage corpus, patient questions are the
queries, and every index family retrieves passages that answer them.
Ground truth is the known question->answer pairing (each query has exactly
one paired answer in the corpus), so the hit-rate is real.

Encoder: an HF checkpoint when one is cached (CUVS_RAG_TPU_ENCODER, e.g.
sentence-transformers/all-MiniLM-L6-v2), else the dependency-free hashed
TF-IDF encoder (lexical, not semantic: a question and its answer share
enough vocabulary that the pairing is recoverable).

Usage:  python cuvs_rag_tpu_torch/examples/medical_qa_demo.py [k] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def paired_answer_hit_rate(retriever, questions, k):
    """Fraction of patient questions whose own doctor answer is retrieved
    in the top-k (query i's paired answer is corpus row i)."""
    results = retriever.retrieve_batch(questions, k)
    hits = sum(
        any(p.index == i for p in res.passages)
        for i, res in enumerate(results)
    )
    return hits / len(questions), results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("k", type=int, nargs="?", default=5)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    k = args.k

    from cuvs_rag_tpu_torch.models.encoder import make_encoder
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.datasets import load_reference_medical_qa
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, IVFFlatParams, IVFPQParams, IVFPQSearchParams,
    )

    records = load_reference_medical_qa()
    # the real fixture has 2 empty answers (rows 30, 92) — drop those pairs
    records = [r for r in records if len(r.output.strip()) >= 5]
    print(f"loaded {len(records)} medical QA pairs (empty answers dropped)")
    answers = [r.output for r in records]
    questions = [r.input for r in records]

    enc_name = os.environ.get("CUVS_RAG_TPU_ENCODER", "tfidf")
    try:
        encoder = make_encoder(enc_name, device=args.device)
    except OSError as e:  # no cached checkpoint offline
        print(f"encoder {enc_name!r} unavailable ({e}); using tfidf")
        encoder = make_encoder("tfidf")
    if hasattr(encoder, "fit"):
        encoder.fit(answers)

    corpus = Corpus(passages=answers)
    # small-N friendly family configs (100 passages)
    family_params = {
        "flat": None,
        "ivf_flat": IVFFlatParams(n_lists=8),
        "ivf_pq": IVFPQParams(n_lists=8, pq_dim=48),
        "cagra": CagraParams(graph_degree=16, intermediate_graph_degree=32),
    }
    family_sp = {
        "ivf_flat": None,  # default n_probes covers all 8 lists
        "ivf_pq": IVFPQSearchParams(n_probes=8, refine_ratio=8),
    }

    shown = False
    for family, params in family_params.items():
        r = Retriever.build(
            corpus, encoder, family=family, params=params,
            search_params=family_sp.get(family), device=args.device,
        )
        rate, results = paired_answer_hit_rate(r, questions, k)
        print(f"{family:10s} paired-answer hit-rate@{k}: {rate:.2f}")
        if not shown:
            shown = True
            q = questions[0]
            print("\n--- sample retrieval ---")
            print(f"QUESTION: {q[:200]}...")
            for p in results[0].passages[:2]:
                print(f"  [{p.index}] d={p.distance:.3f}  {p.text[:160]}...")
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
