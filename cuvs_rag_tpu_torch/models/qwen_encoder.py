"""Qwen3-family decoder encoder as a PyTorch nn.Module — instruct embeddings
on the device.

The counterpart of the JAX package's `models/flax_qwen.py`: the Qwen3
decoder stack (RMSNorm, GQA with per-head q/k RMSNorm, RoPE, SwiGLU), last-
token pooling and L2 normalization, the Qwen3-Embedding pipeline. Parameters
load from a HF Qwen3 state_dict (`convert_hf_state_dict`) or from the JAX
package's flax params (`from_flax_params`), so both packages can run the
same weights. Attention is `ops/attention_kernels.flash_attention` (K7):
the hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor; the q/k/v/o and MLP projections are plain matrix products.

Inference only; matrices in `dtype` (bf16 by default), norm weights fp32.

Deliberate differences from the JAX package:
- no `use_flash` switch and no rule that max_length be a multiple of 512:
  one attention entry point takes any sequence length;
- no GQA repeat and no (B, H, S, hd) transposes: the kernel reads kv head
  h // (nh // nkv) from the projections' own (B, S, heads, hd) layout;
- a batch is padded to its longest sequence as the tokenizer returns it; the
  length buckets of `_bucket_len` bounded jit compiles and Mosaic block
  sizes, and eager PyTorch has neither;
- pad query rows attend pad keys (the TPU flash kernel's segment rule) on
  every path, where the JAX dense branch masks keys only. Pad rows are read
  by nothing downstream: hidden states agree at non-pad positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from cuvs_rag_tpu_torch.index.base import resolve_device
from cuvs_rag_tpu_torch.ops.attention_kernels import flash_attention


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    """Defaults are the published Qwen3-Embedding-0.6B widths."""

    vocab_size: int = 151_936
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6

    @classmethod
    def from_hf(cls, hf_config) -> "QwenConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=getattr(
                hf_config, "head_dim",
                hf_config.hidden_size // hf_config.num_attention_heads,
            ),
            intermediate_size=hf_config.intermediate_size,
            rope_theta=getattr(hf_config, "rope_theta", 1_000_000.0),
            rms_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        )


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 with one downcast: the fp32 norm weight must not
    promote the activations (and every matmul after them) to fp32."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """HF-style rotary embedding on (B, S, H, hd): half-split rotation."""
    hd = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=x.device) / hd))
    freqs = positions.float()[..., None] * inv_freq  # (B, S, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (B, S, hd)
    cos = torch.cos(emb)[..., None, :]  # (B, S, 1, hd)
    sin = torch.sin(emb)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class _QwenBlock(nn.Module):
    """Pre-norm decoder block; attribute names match the JAX module's."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.input_ln = nn.Parameter(torch.ones(h))
        self.q_proj = nn.Linear(h, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_kv_heads * hd, bias=False)
        # Qwen3: per-head RMSNorm on q/k before RoPE
        self.q_norm = nn.Parameter(torch.ones(hd))
        self.k_norm = nn.Parameter(torch.ones(hd))
        self.o_proj = nn.Linear(cfg.num_heads * hd, h, bias=False)
        self.post_ln = nn.Parameter(torch.ones(h))
        self.gate_proj = nn.Linear(h, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(h, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, h, bias=False)

    def forward(self, x, mask, positions):
        c = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        y = _rms_norm(x, self.input_ln, c.rms_eps)
        q = self.q_proj(y).view(b, s, nh, hd)
        k = self.k_proj(y).view(b, s, nkv, hd)
        v = self.v_proj(y).view(b, s, nkv, hd)
        q = _rope(_rms_norm(q, self.q_norm, c.rms_eps), positions, c.rope_theta)
        k = _rope(_rms_norm(k, self.k_norm, c.rms_eps), positions, c.rope_theta)
        ctx = flash_attention(q, k, v, mask, 1.0 / math.sqrt(hd))
        x = x + self.o_proj(ctx.reshape(b, s, nh * hd))
        y = _rms_norm(x, self.post_ln, c.rms_eps)
        mlp = self.down_proj(nn.functional.silu(self.gate_proj(y))
                             * self.up_proj(y))
        return x + mlp


class QwenModel(nn.Module):
    """(input_ids, attention_mask) -> (B, S, H) final-norm hidden states."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(_QwenBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.hidden_size))

    def forward(self, input_ids, attention_mask):
        x = self.embed(input_ids)
        positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1,
                                min=0)
        for layer in self.layers:
            x = layer(x, attention_mask, positions)
        return _rms_norm(x, self.final_ln, self.cfg.rms_eps)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        """N(0, std) projections and embeddings drawn from `generator` (on
        the parameters' device), unit norm weights."""
        for p in self.parameters():
            if p.ndim >= 2:
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0)
        return self


def last_token_pool(hidden: torch.Tensor, attention_mask: torch.Tensor):
    """The hidden state of each sequence's last non-pad token: the largest
    position whose mask is set — right padding, left padding and
    left-then-right mixed layouts alike."""
    iota = torch.arange(hidden.shape[1], device=hidden.device)
    last = torch.amax(iota[None, :] * (attention_mask > 0), dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


# --- weight conversion ------------------------------------------------------

_NORMS = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
          "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm"}
_PROJS = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
          "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
          "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
          "down_proj": "mlp.down_proj"}


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(t, np.float32).copy())


def convert_hf_state_dict(state_dict: Dict[str, Any], cfg: QwenConfig):
    """Map a HF `Qwen3Model` state_dict to QwenModel's state_dict."""
    out = {"embed.weight": _tensor(state_dict["embed_tokens.weight"]),
           "final_ln": _tensor(state_dict["norm.weight"])}
    for li in range(cfg.num_layers):
        for ours, theirs in {**_NORMS, **_PROJS}.items():
            suffix = ".weight" if ours in _PROJS else ""
            out[f"layers.{li}.{ours}{suffix}"] = _tensor(
                state_dict[f"layers.{li}.{theirs}.weight"])
    return out


def from_flax_params(params_np, cfg: QwenConfig):
    """Map the JAX package's flax params ({"params": {...}} of numpy arrays)
    to QwenModel's state_dict. flax Dense kernels are (in, out) and are
    transposed to torch's (out, in)."""
    p = params_np["params"]
    out = {"embed.weight": _tensor(p["embed"]["embedding"]),
           "final_ln": _tensor(p["final_ln"])}
    for li in range(cfg.num_layers):
        layer = p[f"layer_{li}"]
        for name in _NORMS:
            out[f"layers.{li}.{name}"] = _tensor(layer[name])
        for name in _PROJS:
            out[f"layers.{li}.{name}.weight"] = \
                _tensor(layer[name]["kernel"]).T.contiguous()
    return out


class QwenEmbeddingEncoder:
    """Qwen3-Embedding-style encoder: tokenize -> decoder stack -> last-token
    pool -> L2 normalize, on one device.

        enc = QwenEmbeddingEncoder.from_pretrained(path, device="cuda")
        q = enc.encode_device([get_detailed_instruct(task, query)])

    Instruct formatting is `models.encoder.get_detailed_instruct`.
    """

    def __init__(self, cfg: QwenConfig, model: QwenModel, tokenizer, *,
                 max_length: int = 8192, dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        # the card unless the caller names a device; a model the caller
        # already moved to an accelerator stays there
        param = next(model.parameters())
        self.device = resolve_device(device,
                                     param if param.device.type != "cpu"
                                     else None)
        self.model = model.to(self.device).eval()
        for p in self.model.parameters():
            p.requires_grad_(False)
            # matrices in `dtype`, norm weights in fp32
            p.data = p.data.to(dtype if p.ndim >= 2 else torch.float32)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.dim = cfg.hidden_size

    @classmethod
    def from_pretrained(cls, name_or_path: str, *, device=None,
                        **kwargs) -> "QwenEmbeddingEncoder":
        """Load config, weights and tokenizer from a HF Qwen3 checkpoint."""
        from transformers import AutoConfig, AutoModel, AutoTokenizer

        cfg = QwenConfig.from_hf(AutoConfig.from_pretrained(name_or_path))
        model = QwenModel(cfg)
        model.load_state_dict(convert_hf_state_dict(
            AutoModel.from_pretrained(name_or_path).state_dict(), cfg))
        tok = AutoTokenizer.from_pretrained(name_or_path)
        return cls(cfg, model, tok, device=device, **kwargs)

    @torch.no_grad()
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        hidden = self.model(ids, mask)
        emb = last_token_pool(hidden, mask).float()
        return emb / torch.clamp(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)

    def encode_device(self, texts, batch_size: int = 16) -> torch.Tensor:
        """(N, D) fp32 embeddings as a tensor on the encoder's device — the
        retrieval pipeline hands it straight to the index search. Each batch
        runs at the length the tokenizer pads it to (its longest text)."""
        outs = []
        for i in range(0, len(texts), batch_size):
            enc = self.tokenizer(
                list(texts[i:i + batch_size]), padding="longest",
                truncation=True, max_length=self.max_length,
                return_tensors="np",
            )
            ids = torch.as_tensor(np.asarray(enc["input_ids"]),
                                  dtype=torch.long, device=self.device)
            mask = torch.as_tensor(np.asarray(enc["attention_mask"]),
                                   dtype=torch.long, device=self.device)
            outs.append(self._forward(ids, mask))
        if not outs:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        return torch.cat(outs, dim=0)

    def encode(self, texts, batch_size: int = 16) -> np.ndarray:
        return self.encode_device(texts, batch_size).cpu().numpy()

    def encode_sharded(self, texts, dmesh, batch_size: int = 64) -> np.ndarray:
        raise NotImplementedError(
            "data-parallel encode is not ported yet: it arrives with ROADMAP "
            "slice 6 (multi-GPU)")
