"""Embedding front ends — pluggable text encoders.

Reference parity: sentence-transformer models (`nq-distilbert-base-v1`
768-d, `all-MiniLM-L6-v2` 384-d) and the Qwen3-Embedding pipeline
(last-token pooling, instruct formatting, L2-normalize).

Encoders:
  * HashingEncoder / TfidfHashingEncoder — dependency-free deterministic
    feature hashing; the test/demo encoders (no model download).
  * TransformersEncoder — any HF checkpoint via transformers, on a given
    torch device, mean / last-token / cls pooling, L2-normalize.
  * models.bert_encoder.TorchSentenceEncoder — the BERT family as this
    package's own nn.Module, with a device-resident encode for the
    retrieval pipeline.
  * models.qwen_encoder.QwenEmbeddingEncoder — the Qwen3 decoder family
    (last-token pooling), likewise, with flash attention as a CUDA kernel.
  * The protocol is duck-typed: anything with .encode(texts)->np.ndarray
    and .dim works as an encoder for the RAG pipeline.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

# The shared word-token convention: rag/lexical.py's BM25 tokenizer and
# TfidfHashingEncoder MUST agree (hybrid fusion compares their rankings
# over the same text), so the pattern lives in exactly one place.
WORD_RE = re.compile(r"[a-z0-9']+")


class HashingEncoder:
    """Deterministic bag-of-character-n-grams feature hashing + L2 norm.

    Not a semantic model — a fast, dependency-free stand-in with the right
    *shape* of behavior (similar strings → similar vectors) for tests, demos
    and benchmarks, mirroring how the reference notebooks fall back to
    synthetic corpora (cuVS_Scaling_Stress_Test.ipynb#cell6).
    """

    def __init__(self, dim: int = 384, ngram: int = 3):
        self.dim = dim
        self.ngram = ngram

    def encode(self, texts: Sequence[str], batch_size: int = 0) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            t = t.lower()
            for j in range(max(1, len(t) - self.ngram + 1)):
                g = t[j : j + self.ngram].encode()
                h = int.from_bytes(hashlib.blake2b(g, digest_size=8).digest(), "little")
                sign = 1.0 if (h >> 63) & 1 else -1.0
                out[i, h % self.dim] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


class TfidfHashingEncoder:
    """Word uni+bigram feature hashing with corpus-fit IDF weights.

    The strongest dependency-free lexical encoder here (classic hashed
    TF-IDF): on the reference's real 100-pair medical QA fixture it recovers
    the paired doctor answer at 0.64 hit@5 vs 0.47 for character n-grams
    (chance 0.05). Call `fit(corpus_texts)` before encoding (encode works
    unfit too, with uniform weights).
    """

    def __init__(self, dim: int = 1024):
        self.dim = dim
        self.idf: dict = {}

    @staticmethod
    def _grams(text: str):
        toks = WORD_RE.findall(text.lower())
        return toks + [" ".join(p) for p in zip(toks, toks[1:])]

    def fit(self, texts: Sequence[str]) -> "TfidfHashingEncoder":
        import math

        df: dict = {}
        for t in texts:
            for g in set(self._grams(t)):
                df[g] = df.get(g, 0) + 1
        n = max(len(texts), 1)
        self.idf = {g: math.log(n / c) for g, c in df.items()}
        return self

    def encode(self, texts: Sequence[str], batch_size: int = 0) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for g in self._grams(t):
                h = int.from_bytes(
                    hashlib.blake2b(g.encode(), digest_size=8).digest(),
                    "little",
                )
                sign = 1.0 if (h >> 63) & 1 else -1.0
                out[i, h % self.dim] += sign * self.idf.get(g, 1.0)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


class HashTokenizer:
    """Dependency-free word-hash tokenizer with the HF-tokenizer call
    contract the sentence encoders expect (`tok(texts, max_length=L, ...) ->
    {"input_ids", "attention_mask"}`): each whitespace token maps to
    `hash(word) % vocab_mod + 1` (0 = pad), right-padded to max_length.

    Not a linguistic tokenizer — the deterministic stand-in used by the
    bench/demo/gate paths when no checkpointed vocab is available
    (identical text -> identical ids, which is all self-retrieval
    exactness checks and throughput benches need). Replaces four
    previously-diverging inline copies (bench.py, __graft_entry__.py,
    scripts/bench_e2e_text.py, examples/demo_sharded_rag.py).
    """

    def __init__(self, vocab_mod: int = 29_000):
        self.vocab_mod = vocab_mod

    def __call__(self, texts: Sequence[str], **kw):
        L = kw.get("max_length", 64)
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            toks = [hash(w) % self.vocab_mod + 1 for w in t.split()][:L]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def get_detailed_instruct(task_description: str, query: str) -> str:
    """Instruct formatting for instruction-tuned embedders
    (generate_embeddings.py:23-27)."""
    return f"Instruct: {task_description}\nQuery: {query}"


class TransformersEncoder:
    """HF transformers encoder on a torch device, mean / last-token / cls
    pooling."""

    def __init__(
        self,
        model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
        pooling: str = "mean",  # mean | last_token | cls
        max_length: int = 512,
        normalize: bool = True,
        device="cpu",
    ):
        if pooling not in ("mean", "last_token", "cls"):
            raise ValueError(f"unknown pooling {pooling!r}")
        import torch
        from transformers import AutoModel, AutoTokenizer

        self._torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name).to(device).eval()
        self.pooling = pooling
        self.max_length = max_length
        self.normalize = normalize
        self.device = torch.device(device)
        self.dim = int(self.model.config.hidden_size)

    def _pool(self, hidden, attention_mask):
        torch = self._torch
        if self.pooling == "cls":
            return hidden[:, 0]
        if self.pooling == "mean":
            mask = attention_mask.unsqueeze(-1).to(hidden.dtype)
            return (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        # last_token pooling, handling left/right padding
        # (reference last_token_pool, generate_embeddings.py:11-21)
        left_padding = attention_mask[:, -1].sum() == attention_mask.shape[0]
        if left_padding:
            return hidden[:, -1]
        lengths = attention_mask.sum(dim=1) - 1
        return hidden[torch.arange(hidden.shape[0]), lengths]

    def encode(self, texts: Sequence[str], batch_size: int = 32) -> np.ndarray:
        torch = self._torch
        outs = []
        with torch.no_grad():
            for i in range(0, len(texts), batch_size):
                batch = list(texts[i : i + batch_size])
                enc = self.tokenizer(
                    batch,
                    padding=True,
                    truncation=True,
                    max_length=self.max_length,
                    return_tensors="pt",
                ).to(self.device)
                hidden = self.model(**enc).last_hidden_state
                emb = self._pool(hidden, enc["attention_mask"])
                if self.normalize:
                    emb = torch.nn.functional.normalize(emb, p=2, dim=1)
                outs.append(emb.cpu().numpy().astype(np.float32))
        return np.concatenate(outs, axis=0)


def make_encoder(name: str = "hashing", *, device=None, **kwargs):
    """Factory: 'hashing', 'tfidf' or an HF model name.

    A checkpoint runs as this package's own nn.Module, picked by its
    model_type: a BERT-family checkpoint (MiniLM/DistilBERT-class) as
    models.bert_encoder.TorchSentenceEncoder, a Qwen3-family one (the
    Qwen3-Embedding pipeline) as models.qwen_encoder.QwenEmbeddingEncoder.
    It runs on the card unless the caller names a `device` (there is no
    fallback to the CPU: device="cpu" asks for it). Their encode_device
    keeps embeddings on the device for the index. The transformers-backed
    encoder is not picked here: construct TransformersEncoder by name.
    """
    if name == "hashing":
        return HashingEncoder(**kwargs)
    if name == "tfidf":
        return TfidfHashingEncoder(**kwargs)
    from transformers import AutoConfig

    model_type = getattr(AutoConfig.from_pretrained(name), "model_type", "")
    if model_type.startswith("qwen"):
        from cuvs_rag_tpu_torch.models.qwen_encoder import QwenEmbeddingEncoder

        return QwenEmbeddingEncoder.from_pretrained(name, device=device,
                                                    **kwargs)
    from cuvs_rag_tpu_torch.models.bert_encoder import TorchSentenceEncoder

    return TorchSentenceEncoder.from_pretrained(name, device=device, **kwargs)
