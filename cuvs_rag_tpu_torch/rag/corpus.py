"""Corpus store + embedding persistence.

Reference parity: passage corpora loaded from compressed archives
(simplewiki jsonl.gz, VectorSearch_QuestionRetrieval.ipynb#cell4; medical-QA
JSON, prepare_dataset.py:112-129) and embedding persistence as whole or
per-shard files (`.pt` / `_part{i}.pt`, cuVS-2GPU.ipynb#cell10-12) — here
`.npy` / `_part{i}.npy` with a JSON sidecar, reloadable onto any mesh size
(the reference's more-parts-than-GPUs handling becomes plain re-sharding).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Text passages + optional precomputed embeddings, row-aligned."""

    passages: List[str]
    embeddings: Optional[np.ndarray] = None
    titles: Optional[List[str]] = None

    def __post_init__(self):
        if self.embeddings is not None and len(self.passages) != len(self.embeddings):
            raise ValueError(
                f"passages ({len(self.passages)}) and embeddings "
                f"({len(self.embeddings)}) must be row-aligned"
            )
        if self.titles is not None and len(self.titles) != len(self.passages):
            raise ValueError("titles must align with passages")

    def __len__(self):
        return len(self.passages)


def load_jsonl(path: str, text_key: str = "text", title_key: str = "title",
               max_rows: Optional[int] = None) -> Corpus:
    """Load a (optionally gzipped) JSONL passage file
    (simplewiki-style, VectorSearch_QuestionRetrieval.ipynb#cell4)."""
    opener = gzip.open if path.endswith(".gz") else open
    passages, titles = [], []
    with opener(path, "rt", encoding="utf8") as f:
        for line in f:
            if max_rows is not None and len(passages) >= max_rows:
                break
            row = json.loads(line)
            text = row[text_key]
            if isinstance(text, list):  # simplewiki: list of paragraph strings
                for p in text:
                    passages.append(p)
                    titles.append(row.get(title_key, ""))
                continue
            passages.append(text)
            titles.append(row.get(title_key, ""))
    return Corpus(passages=passages, titles=titles)


def save_embeddings(prefix: str, embeddings: np.ndarray, num_parts: int = 1) -> List[str]:
    """Persist embeddings whole (num_parts=1) or as contiguous parts.

    Mirrors the reference's whole-vs-`_part{i}` save (cuVS-2GPU.ipynb#cell10).
    Returns the file paths written; a `{prefix}.meta.json` records the split.
    """
    n = len(embeddings)
    paths = []
    if num_parts <= 1:
        p = f"{prefix}.npy"
        np.save(p, embeddings)
        paths.append(p)
        bounds = [[0, n]]
    else:
        splits = np.array_split(np.arange(n), num_parts)
        bounds = []
        for i, idx in enumerate(splits):
            p = f"{prefix}_part{i}.npy"
            np.save(p, embeddings[idx])
            paths.append(p)
            bounds.append([int(idx[0]), int(idx[-1]) + 1])
    with open(f"{prefix}.meta.json", "w") as f:
        json.dump({"n": n, "dim": int(embeddings.shape[1]),
                   "parts": len(paths), "bounds": bounds}, f)
    return paths


def _load_pt(path: str) -> np.ndarray:
    """Load one torch-saved embedding tensor as (N, D) float32 numpy.

    The reference persists corpora as torch `.pt` files
    (`torch.save(embeddings, 'embeddings.pt')`, cuVS-2GPU.ipynb#cell10);
    a switching user's existing artifacts load directly. CPU-mapped so
    CUDA-saved tensors load on any host.
    """
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(t, dict):  # tolerate {'embeddings': tensor} wrappers
        for key in ("embeddings", "emb", "vectors"):
            if key in t:
                t = t[key]
                break
        else:
            raise ValueError(
                f"{path}: dict checkpoint without an embeddings entry "
                f"(keys: {list(t)[:8]})"
            )
    arr = t.float().numpy() if hasattr(t, "float") else np.asarray(t)
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a 2D tensor, got {arr.shape}")
    return np.ascontiguousarray(arr, np.float32)


def load_embeddings(prefix: str) -> np.ndarray:
    """Reload embeddings saved by save_embeddings, any part count
    (reference reload/re-chunk: cuVS-2GPU.ipynb#cell12) — or the
    reference's own torch `.pt` artifacts, whole (`{prefix}.pt`) or
    per-shard parts (`{prefix}_part{i}.pt`, cuVS-2GPU.ipynb#cell12)."""
    meta_path = f"{prefix}.meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["parts"] == 1:
            return np.load(f"{prefix}.npy")
        return np.concatenate(
            [np.load(f"{prefix}_part{i}.npy") for i in range(meta["parts"])]
        )
    if os.path.exists(f"{prefix}.npy"):
        return np.load(f"{prefix}.npy")
    if prefix.endswith(".pt") and os.path.exists(prefix):
        return _load_pt(prefix)
    if os.path.exists(f"{prefix}.pt"):
        return _load_pt(f"{prefix}.pt")
    if os.path.exists(f"{prefix}_part0.pt"):
        parts = []
        while os.path.exists(f"{prefix}_part{len(parts)}.pt"):
            parts.append(_load_pt(f"{prefix}_part{len(parts)}.pt"))
        return np.concatenate(parts)
    raise FileNotFoundError(
        f"no embeddings at {prefix}(.npy/.meta.json/.pt/_part0.pt)"
    )
