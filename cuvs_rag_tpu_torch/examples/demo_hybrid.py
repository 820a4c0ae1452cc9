"""Hybrid retrieval demo: fuse a lexical and a second engine's rankings.

The counterpart of the JAX package's `examples/demo_hybrid.py`. Runs on
the reference's 100 real medical QA pairs (the fixture that
`CUVS_RAG_TPU_MEDICAL_QA` names, as examples/medical_qa_demo.py does):
doctor answers are the corpus, patient questions the queries, ground truth
the known 1:1 pairing. The engines retrieve independently — BM25
(rag/lexical.py), hashed TF-IDF and character n-gram hashing (the
dependency-free stand-in for a semantic encoder; set CUVS_RAG_TPU_ENCODER
to a cached HF checkpoint to use a real one) — and
`rag/fusion.HybridRetriever` fuses their rankings per query.

The dense engines are built with metric='inner_product': hashed sparse
encoders can emit zero-norm rows, which under L2 sit at distance ||q||^2
— above every real match (see rag/fusion.py module docstring).

Usage:  python cuvs_rag_tpu_torch/examples/demo_hybrid.py [k] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np


def hit_rate(results, k):
    return float(np.mean([
        int(any(p.index == qi for p in res.passages[:k]))
        for qi, res in enumerate(results)
    ]))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("k", type=int, nargs="?", default=5)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    k = args.k

    from cuvs_rag_tpu_torch.models.encoder import (
        HashingEncoder, TfidfHashingEncoder, make_encoder,
    )
    from cuvs_rag_tpu_torch.rag import datasets
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.fusion import HybridRetriever
    from cuvs_rag_tpu_torch.rag.lexical import LexicalRetriever
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    records = datasets.load_reference_medical_qa()
    answers = [r.output for r in records]
    questions = [r.input for r in records]
    print(f"corpus: {len(answers)} doctor answers; "
          f"queries: {len(questions)} patient questions")

    name = os.environ.get("CUVS_RAG_TPU_ENCODER", "")
    dense_enc = make_encoder(name, device=args.device) if name \
        else HashingEncoder()
    dense_label = name or "char n-gram hashing (stand-in)"

    params = FlatParams(dtype="float32", metric="inner_product")
    r_lex = Retriever.build(
        Corpus(passages=answers), TfidfHashingEncoder().fit(answers),
        family="flat", params=params, device=args.device,
    )
    r_dense = Retriever.build(
        Corpus(passages=answers), dense_enc, family="flat", params=params,
        device=args.device,
    )
    # the inverted-index BM25 (rag/lexical.py) is the production lexical
    # leg; hashed TF-IDF is kept for comparison
    r_bm25 = LexicalRetriever(Corpus(passages=answers))

    lex = hit_rate(r_lex.retrieve_batch(questions, k), k)
    bm25 = hit_rate(r_bm25.retrieve_batch(questions, k), k)
    dense = hit_rate(r_dense.retrieve_batch(questions, k), k)
    print(f"hashed TF-IDF alone:        hit@{k} = {lex:.2f}")
    print(f"BM25 inverted index alone:  hit@{k} = {bm25:.2f}")
    print(f"{dense_label} alone: hit@{k} = {dense:.2f}")

    for method in ("zscore", "rrf"):
        h = HybridRetriever([r_bm25, r_dense], method=method, fetch_k=50)
        fused = hit_rate(h.retrieve_batch(questions, k), k)
        print(f"hybrid BM25+dense ({method}): hit@{k} = {fused:.2f}")
    h3 = HybridRetriever([r_bm25, r_lex, r_dense], fetch_k=50)
    print(f"hybrid BM25+TFIDF+dense (zscore): hit@{k} = "
          f"{hit_rate(h3.retrieve_batch(questions, k), k):.2f}")
    print("(n=100 pairs — small-sample noise ~±0.05; the decisive hybrid "
          "evidence is tests/test_hybrid_quality.py at n=1000, where "
          "engines are complementary by construction)")

    h = HybridRetriever([r_lex, r_dense], fetch_k=50)
    res = h.retrieve(questions[0], k)
    print("\nsample fused retrieval:")
    print("QUESTION:", questions[0][:140], "...")
    for p_ in res.passages[:2]:
        print(f"  [{p_.index}] rank={int(p_.distance)}  {p_.text[:90]}...")


if __name__ == "__main__":
    main()
