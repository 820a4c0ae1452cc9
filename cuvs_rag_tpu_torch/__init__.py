"""cuvs_rag_tpu_torch — the retrieval engine on PyTorch and CUDA.

The PyTorch counterpart of `cuvs_rag_tpu`, module for module: plain tensor
code is PyTorch, and every kernel the JAX package wrote for the TPU (the
fused search kernels, the encoder's flash attention, the measurement
kernels) is CUDA C++ written for Hopper (`csrc/`, built at first use by
`kernels/build.py`). The package never imports JAX.

Layering mirrors the JAX package:
  ops/      — score algebra, top-k helpers and the CUDA kernel wrappers:
              flat_kernels (K1-K3), ivf_kernels (K4-K5), pq_kernels (K6),
              attention_kernels (K7 flash attention), stream_kernels
              (M1-M4 streaming read and scattered gathers)
  index/    — index families as dataclasses of tensors, filtered views
  eval/     — recall against the exact oracle; roofline, the card's
              measured read and gather rates
  models/   — text encoders as nn.Modules: bert_encoder (BERT family),
              qwen_encoder (Qwen3 family, last-token pooling)
  rag/      — retrieval pipeline, corpus store, disk-backed embedding store
  utils/    — typed configs, metrics
"""

__version__ = "0.1.0"

from cuvs_rag_tpu_torch.index.flat import FlatIndex  # noqa: F401
from cuvs_rag_tpu_torch.utils.config import SearchConfig  # noqa: F401
