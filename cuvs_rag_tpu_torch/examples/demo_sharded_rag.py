"""One sharded end-to-end RAG story.

The counterpart of the JAX package's `examples/demo_sharded_rag.py`.
Ingest -> data-parallel corpus encode over the device mesh -> sharded index
build -> fan-out retrieval (each shard on its own stream, the candidates
merged on the first device) -> passage assembly, as ONE flow through the
public API. The reference ran the same story hand-rolled across 2 GPUs
with threads (/root/reference/Latest/improved_multi_gpu_rag.py:399-506).

    python cuvs_rag_tpu_torch/examples/demo_sharded_rag.py     # every visible card
    python cuvs_rag_tpu_torch/examples/demo_sharded_rag.py --positions 4   # 4 shards, the card
    python cuvs_rag_tpu_torch/examples/demo_sharded_rag.py --device cpu --positions 8

The encoder is a BERT with weights drawn from a seed (no checkpoint in the
repository; `make_encoder("<hf-name>")` takes a real one). The encode step
splits the token batches over the mesh (rag/pipeline.encode_sharded).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="default: every visible card, one position each")
    p.add_argument("--positions", type=int, default=None,
                   help="mesh positions on --device (default 1)")
    p.add_argument("--n", type=int, default=2000, help="QA passages")
    args = p.parse_args(argv)

    import torch

    from cuvs_rag_tpu_torch.models.bert_encoder import (
        BertConfig, BertEncoderModel, TorchSentenceEncoder)
    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.datasets import load_medical_qa
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import (
        IVFFlatParams, IVFFlatSearchParams)

    if args.device is None and args.positions is None:
        dmesh = DeviceMesh()
    else:
        dmesh = DeviceMesh([args.device or "cuda:0"] * (args.positions or 1))
    print(f"mesh: {dmesh.num_devices} position(s) — {dmesh.first}")

    # 1) ingest: the medical QA corpus the reference prepared
    #    (Latest/cuVS-2-gpu/prepare_dataset.py)
    qa, _ = load_medical_qa(args.n)
    corpus = Corpus(
        passages=[f"{r.input} {r.output}" for r in qa],
        titles=[r.topic for r in qa],
    )
    print(f"ingested {len(corpus.passages)} passages")

    # 2+3) data-parallel encode over the mesh + sharded build, in one
    #      Retriever.build call (placement='shard' routes the corpus
    #      encode through rag/pipeline.encode_sharded)
    cfg = BertConfig(
        vocab_size=30_000, hidden_size=256, num_layers=4, num_heads=4,
        intermediate_size=1024, max_position=128,
    )
    model = BertEncoderModel(cfg).init_random_(
        torch.Generator().manual_seed(0))
    encoder = TorchSentenceEncoder(cfg, model, HashTokenizer(29_000),
                                   max_length=128, device=dmesh.first)
    t0 = time.time()
    retriever = Retriever.build(
        corpus, encoder, family="ivf_flat",
        params=IVFFlatParams(n_lists=32), placement="shard", dmesh=dmesh,
        search_params=IVFFlatSearchParams(n_probes=8),
        encode_batch_size=64 * dmesh.num_devices,
    )
    dt = time.time() - t0
    print(f"sharded encode + build: {dt:.1f}s "
          f"({len(corpus.passages) / dt:.0f} docs/s end-to-end)")

    # 4) fan-out retrieval + passage assembly. With seeded encoder
    #    weights, semantic neighbours are not meaningful — but identical
    #    text maps to the identical embedding, so the top hit is the probe's
    #    own text at distance ~0 (the synthetic corpus repeats passages:
    #    which copy comes first among exact ties is not fixed).
    probe = corpus.passages[17]
    res = retriever.retrieve(probe, k=3)
    top = res.passages[0]
    print(f"query: {probe[:60]!r}...")
    print(f"top-1: id={top.index} title={top.title!r} "
          f"dist={top.distance:.4f} ({res.query_time_s * 1e3:.1f} ms)")
    assert corpus.passages[top.index] == probe and top.distance < 1e-3, \
        "sharded self-retrieval must be exact"

    context = retriever.assemble_context(probe, k=2)
    print(f"assembled context: {len(context)} chars")
    print("sharded end-to-end RAG flow OK")


if __name__ == "__main__":
    main()
