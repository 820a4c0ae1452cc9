"""Helpers for the tests that hold cuvs_rag_tpu_torch against cuvs_rag_tpu:
moving arrays between the two packages through numpy, and comparing top-k
results (utils.compare.compare_topk, the same rule chip_smoke.py holds the
kernels to on the card). Not a test module."""

import numpy as np
import torch

from cuvs_rag_tpu_torch.utils.compare import compare_topk  # noqa: F401


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array -> CPU tensor, bf16 preserved."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t) -> np.ndarray:
    """A tensor or JAX array -> numpy, bf16 as float32 (exact)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.detach().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
