"""cuvs_rag_tpu_torch — the retrieval engine on PyTorch and CUDA.

The PyTorch counterpart of `cuvs_rag_tpu`, module for module: plain tensor
code is PyTorch, and every fused search kernel is CUDA C++ written for
Hopper (`csrc/`, built at first use by `kernels/build.py`). The package
never imports JAX.

Layering mirrors the JAX package:
  ops/      — score algebra, top-k helpers and the CUDA kernel wrappers
  index/    — index families as dataclasses of tensors, filtered views
  eval/     — recall against the exact oracle
  models/   — text encoders (BERT family as an nn.Module)
  rag/      — retrieval pipeline, corpus store, disk-backed embedding store
  utils/    — typed configs, metrics
"""

__version__ = "0.1.0"

from cuvs_rag_tpu_torch.index.flat import FlatIndex  # noqa: F401
from cuvs_rag_tpu_torch.utils.config import SearchConfig  # noqa: F401
