"""RAG retrieval demo — the reference's notebook flow as a script.

The counterpart of the JAX package's `examples/demo_rag.py`
(VectorSearch_QuestionRetrieval.ipynb: encode corpus -> build index ->
query -> print passages; demo_index_building_coordinator.py: driving the
managers across the index types, SURVEY.md §2 #18).

    python cuvs_rag_tpu_torch/examples/demo_rag.py     # the card
    python cuvs_rag_tpu_torch/examples/demo_rag.py --family ivf_pq
    python cuvs_rag_tpu_torch/examples/demo_rag.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.rag import datasets
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.pipeline import Retriever
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="flat",
                   choices=["flat", "ivf_flat", "ivf_pq", "cagra"])
    p.add_argument("--placement", default="single",
                   choices=["single", "shard", "replicate"])
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--n", type=int, default=400, help="QA passages")
    p.add_argument("--device", default=None,
                   help="default: the card (every visible card for shard / "
                        "replicate; two mesh positions of a named device)")
    args = p.parse_args(argv)

    qa, source = datasets.load_medical_qa(args.n)
    print(f"corpus: {len(qa)} medical QA passages ({source})")
    corpus = Corpus(
        passages=[f"{r.input} {r.output}" for r in qa],
        titles=[r.topic for r in qa],
    )
    dmesh = None
    if args.placement != "single" and args.device is not None:
        dmesh = DeviceMesh([args.device] * 2)
    retriever = Retriever.build(
        corpus,
        HashingEncoder(dim=384),
        family=args.family,
        placement=args.placement,
        dmesh=dmesh,
        params=FlatParams(metric=Metric.COSINE) if args.family == "flat" else None,
        device=args.device if args.placement == "single" else None,
    )

    for q in [
        "what are the symptoms of diabetes?",
        "how do doctors diagnose asthma?",
        "treatment options for migraine headaches",
    ]:
        res = retriever.retrieve(q, k=args.k)
        print(f"\nQ: {q}  ({res.query_time_s*1e3:.1f} ms)")
        for p_ in res.passages:
            print(f"  [{p_.title:12s} d={p_.distance:.3f}] {p_.text[:90]}...")

    ctx = retriever.assemble_context("hypertension risk factors", k=2)
    print(f"\nassembled context ({len(ctx)} chars):\n{ctx[:200]}...")


if __name__ == "__main__":
    main()
