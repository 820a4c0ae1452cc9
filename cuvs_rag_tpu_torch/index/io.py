"""Index checkpoint/restore in the JAX package's npz format (format 3).

One .npz file per index: each tensor field as an array (bf16 stored as its
uint16 bit pattern, listed under "bf16"), `n_valid` as a 0-d int32 array,
and a `__meta__` JSON record {"__class__", "static", "bf16", "format"}. A
file saved by either package loads in the other. FlatIndex and
IVFFlatIndex are ported so far; the other families arrive with their slices
(see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

_BF16 = "bf16"


def _registry():
    from cuvs_rag_tpu_torch.index.flat import FlatIndex
    from cuvs_rag_tpu_torch.index.ivf_flat import IVFFlatIndex

    return {"FlatIndex": FlatIndex, "IVFFlatIndex": IVFFlatIndex}


def save_index(path: str, index: Any) -> None:
    """Serialize an index dataclass to one .npz file."""
    cls = type(index).__name__
    if cls not in _registry():
        raise ValueError(f"unknown index type {cls}; known: {list(_registry())}")
    arrays, meta = {}, {"__class__": cls, "static": {}, _BF16: [], "format": 3}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if f.name in type(index)._tensor_fields:
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                meta[_BF16].append(f.name)
                a = t.view(torch.int16).numpy().view(np.uint16)
            else:
                a = t.numpy()
            arrays[f.name] = a
        elif f.name == "n_valid":  # an array leaf in the format
            arrays[f.name] = np.asarray(v, np.int32)
        else:
            meta["static"][f.name] = v
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_index(path: str, device=None) -> Any:
    """Restore an index saved by either package's save_index, onto `device`
    (the CPU when None)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        name = meta["__class__"]
        if name not in _registry():
            raise NotImplementedError(
                f"{name} files load once that family is ported (ROADMAP.md)"
            )
        cls = _registry()[name]
        kwargs = dict(meta["static"])
        kwargs["n_valid"] = int(z["n_valid"])
        for field in cls._tensor_fields:
            a = z[field]
            if field in meta[_BF16]:
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            kwargs[field] = t.to(device or "cpu")
    return cls(**kwargs)
