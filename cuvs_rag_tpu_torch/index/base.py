"""Common index machinery.

Indexes are frozen dataclasses whose array state (vectors, sqnorms, ...)
are torch tensors on one device; hyperparameters (metric, tile sizes) are
plain fields. Every index family module exposes the cuVS two-call surface:

    index = <family>.build(params, dataset)
    distances, indices = <family>.search(search_params, index, queries, k)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def register_index(cls):
    """Record a frozen dataclass index's tensor fields (annotation contains
    'Tensor') as `cls._tensor_fields`; index/io.py serializes those."""
    cls._tensor_fields = tuple(
        f.name for f in dataclasses.fields(cls) if "Tensor" in str(f.type)
    )
    return cls


def resolve_device(device=None, like=None) -> torch.device:
    """Where an entry point puts its state: an explicit `device` wins; a
    tensor input (`like`) keeps its own device; anything else (numpy, a
    file) goes to the card. There is no fallback to the CPU: without a card
    the first allocation fails with CUDA's own error, and a caller that
    wants the CPU says device="cpu"."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cuda")


def as_tensor(x, device=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on `resolve_device(device, x)`."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            resolve_device(device))
    return x if device is None else x.to(device)


def validate_dataset(dataset) -> None:
    """Build-time input validation: 2-D, non-empty."""
    if dataset.ndim != 2:
        raise ValueError(f"dataset must be 2-D (N, D), got shape {tuple(dataset.shape)}")
    if dataset.shape[0] == 0 or dataset.shape[1] == 0:
        raise ValueError(f"dataset must be non-empty, got shape {tuple(dataset.shape)}")


def validate_queries(queries: torch.Tensor, dim: int) -> torch.Tensor:
    """Search-time query validation + 1-D promotion."""
    if queries.ndim == 1:
        queries = queries[None, :]
    if queries.ndim != 2:
        raise ValueError(f"queries must be 1-D or 2-D, got shape {tuple(queries.shape)}")
    if queries.shape[-1] != dim:
        raise ValueError(
            f"query dim {queries.shape[-1]} does not match index dim {dim}"
        )
    if queries.shape[0] == 0:
        raise ValueError("queries must be non-empty")
    return queries


def storage_dtype(name: str, data_dtype=None) -> torch.dtype:
    """Resolve a storage-dtype config string.

    "auto" keeps a float dataset's own dtype (fp32 stays exact, bf16 takes
    the halved-read path); non-float inputs store fp32. Callers that pass
    "auto" must supply data_dtype.
    """
    if name == "auto":
        if data_dtype is None:
            raise ValueError("storage_dtype('auto') needs the data dtype")
        if data_dtype in (torch.float32, torch.bfloat16):
            return data_dtype
        return torch.float32
    if name in ("float32", "fp32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name == "int8":
        return torch.int8
    raise ValueError(f"unsupported storage dtype {name!r}")
