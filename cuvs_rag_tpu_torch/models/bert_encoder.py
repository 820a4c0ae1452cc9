"""BERT-family text encoder as a PyTorch nn.Module — the device-resident
embedding front end.

The counterpart of the JAX package's `models/flax_encoder.py`: post-LN BERT
blocks, learned positions, exact GELU, mean/CLS pooling, L2 normalization
(covers MiniLM and nq-distilbert-class checkpoints). Parameters load from a
HF BERT or DistilBERT state_dict (`convert_hf_state_dict`,
`convert_distilbert_state_dict`) or from the JAX package's flax params
(`from_flax_params`), so both packages can run the same weights.

Inference only, fp32. Attention is plain matmul + softmax in fp32 over
sequences of at most 512 tokens; a key-pad mask of -1e9 matches the
reference. TF32 must stay off (torch's default for matmuls) for the
parity the tests hold it to.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from cuvs_rag_tpu_torch.index.base import resolve_device
from cuvs_rag_tpu_torch.models.encoder import encode_over_mesh, model_on


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384  # MiniLM-L6
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls()

    @classmethod
    def from_hf(cls, hf_config) -> "BertConfig":
        if getattr(hf_config, "model_type", "") == "distilbert":
            # DistilBERT: same block structure, different config names, and
            # NO token-type embeddings (type_vocab_size=0 disables them).
            return cls(
                vocab_size=hf_config.vocab_size,
                hidden_size=hf_config.dim,
                num_layers=hf_config.n_layers,
                num_heads=hf_config.n_heads,
                intermediate_size=hf_config.hidden_dim,
                max_position=hf_config.max_position_embeddings,
                type_vocab_size=0,
                layer_norm_eps=getattr(hf_config, "layer_norm_eps", 1e-12),
            )
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position=hf_config.max_position_embeddings,
            type_vocab_size=getattr(hf_config, "type_vocab_size", 2),
            layer_norm_eps=hf_config.layer_norm_eps,
        )


class _Block(nn.Module):
    """Post-LN transformer block; attribute names match the JAX module's."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.ln_attn = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.ff_in = nn.Linear(h, cfg.intermediate_size)
        self.ff_out = nn.Linear(cfg.intermediate_size, h)
        self.ln_ff = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        hd = h // self.num_heads

        def split(t):
            return t.view(b, s, self.num_heads, hd).transpose(1, 2)

        logits = split(self.q(x)) @ split(self.k(x)).transpose(-1, -2)
        logits = logits / math.sqrt(hd)
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits, dim=-1)
        ctx = (attn @ split(self.v(x))).transpose(1, 2).reshape(b, s, h)
        x = self.ln_attn(x + self.attn_out(ctx))
        y = self.ff_out(nn.functional.gelu(self.ff_in(x), approximate="none"))
        return self.ln_ff(x + y)


class BertEncoderModel(nn.Module):
    """(input_ids, attention_mask[, token_type_ids]) -> (B, S, H) hidden."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos = nn.Embedding(cfg.max_position, cfg.hidden_size)
        # DistilBERT has no segment embeddings
        self.typ = (nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
                    if cfg.type_vocab_size > 0 else None)
        self.ln_emb = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).expand(b, s)
        x = self.tok(input_ids) + self.pos(pos)
        if self.typ is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.typ(token_type_ids)
        x = self.ln_emb(x)
        mask = attention_mask.bool()
        for layer in self.layers:
            x = layer(x, mask)
        return x

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        """BERT's initialization drawn from `generator`: N(0, std) weights
        and embeddings, zero biases, unit LayerNorm scales."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self


# --- weight conversion ------------------------------------------------------

_LAYER_KEYS_BERT = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "ln_attn": "attention.output.LayerNorm",
    "ff_in": "intermediate.dense",
    "ff_out": "output.dense",
    "ln_ff": "output.LayerNorm",
}
_LAYER_KEYS_DISTILBERT = {
    "q": "attention.q_lin",
    "k": "attention.k_lin",
    "v": "attention.v_lin",
    "attn_out": "attention.out_lin",
    "ln_attn": "sa_layer_norm",
    "ff_in": "ffn.lin1",
    "ff_out": "ffn.lin2",
    "ln_ff": "output_layer_norm",
}


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(t, np.float32).copy())


def _convert(state_dict, cfg, layer_prefix, layer_keys, segment: bool):
    g = {k: _tensor(v) for k, v in state_dict.items()}
    out = {
        "tok.weight": g["embeddings.word_embeddings.weight"],
        "pos.weight": g["embeddings.position_embeddings.weight"],
        "ln_emb.weight": g["embeddings.LayerNorm.weight"],
        "ln_emb.bias": g["embeddings.LayerNorm.bias"],
    }
    if segment:
        out["typ.weight"] = g["embeddings.token_type_embeddings.weight"]
    for li in range(cfg.num_layers):
        for ours, theirs in layer_keys.items():
            for p in ("weight", "bias"):
                out[f"layers.{li}.{ours}.{p}"] = g[f"{layer_prefix}.{li}.{theirs}.{p}"]
    return out


def convert_hf_state_dict(state_dict: Dict[str, Any], cfg: BertConfig):
    """Map a HF `BertModel` state_dict to BertEncoderModel's state_dict."""
    return _convert(state_dict, cfg, "encoder.layer", _LAYER_KEYS_BERT,
                    segment=True)


def convert_distilbert_state_dict(state_dict: Dict[str, Any], cfg: BertConfig):
    """Map a HF `DistilBertModel` state_dict (q_lin/k_lin/v_lin/out_lin,
    sa_layer_norm, ffn.lin1/lin2, output_layer_norm; no token types) to
    BertEncoderModel's state_dict."""
    return _convert(state_dict, cfg, "transformer.layer",
                    _LAYER_KEYS_DISTILBERT, segment=False)


def from_flax_params(params_np, cfg: BertConfig):
    """Map the JAX package's flax params ({"params": {...}} of numpy arrays)
    to BertEncoderModel's state_dict. flax Dense kernels are (in, out) and
    are transposed to torch's (out, in); LayerNorm "scale" is "weight"."""
    p = params_np["params"]
    out = {
        "tok.weight": _tensor(p["tok"]["embedding"]),
        "pos.weight": _tensor(p["pos"]["embedding"]),
        "ln_emb.weight": _tensor(p["ln_emb"]["scale"]),
        "ln_emb.bias": _tensor(p["ln_emb"]["bias"]),
    }
    if cfg.type_vocab_size > 0:
        out["typ.weight"] = _tensor(p["typ"]["embedding"])
    for li in range(cfg.num_layers):
        layer = p[f"layer_{li}"]
        for name in _LAYER_KEYS_BERT:
            if name.startswith("ln_"):
                out[f"layers.{li}.{name}.weight"] = _tensor(layer[name]["scale"])
            else:
                out[f"layers.{li}.{name}.weight"] = _tensor(layer[name]["kernel"]).T.contiguous()
            out[f"layers.{li}.{name}.bias"] = _tensor(layer[name]["bias"])
    return out


# DPR-style sentence-transformers checkpoints known to use CLS pooling (their
# 1_Pooling config sets pooling_mode_cls_token); used when the config file
# is neither in the checkpoint directory nor in the local hub cache.
_ST_CLS_CHECKPOINTS = {
    "nq-distilbert-base-v1",
    "facebook-dpr-question_encoder-single-nq-base",
    "facebook-dpr-ctx_encoder-single-nq-base",
    "facebook-dpr-question_encoder-multiset-base",
    "facebook-dpr-ctx_encoder-multiset-base",
}


def st_pooling_mode(name_or_path) -> "str | None":
    """Pooling mode declared by a sentence-transformers checkpoint: its
    `1_Pooling/config.json` from the checkpoint directory or the local hub
    cache (never the network), else the known-checkpoints table, else None."""
    cfg_path = os.path.join(str(name_or_path), "1_Pooling", "config.json")
    if not os.path.isfile(cfg_path):
        try:
            from huggingface_hub import try_to_load_from_cache

            cached = try_to_load_from_cache(str(name_or_path),
                                            "1_Pooling/config.json")
            cfg_path = cached if isinstance(cached, str) else None
        except ImportError:
            cfg_path = None
    if cfg_path is not None:
        with open(cfg_path) as f:
            cfg = json.load(f)
        if cfg.get("pooling_mode_cls_token"):
            return "cls"
        if cfg.get("pooling_mode_mean_tokens"):
            return "mean"
        return None
    base = str(name_or_path).rstrip("/").split("/")[-1]
    return "cls" if base in _ST_CLS_CHECKPOINTS else None


class TorchSentenceEncoder:
    """Sentence encoder: a tokenizer + BertEncoderModel on one device.

        enc = TorchSentenceEncoder.from_pretrained(path, device="cuda")
        q = enc.encode_device(texts)   # (N, D) fp32 tensor on the device
    """

    def __init__(self, cfg: BertConfig, model: BertEncoderModel, tokenizer, *,
                 pooling: str = "mean", normalize: bool = True,
                 max_length: int = 256, device=None):
        if pooling not in ("mean", "cls"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.cfg = cfg
        # the card unless the caller names a device; a model the caller
        # already moved to an accelerator stays there
        param = next(model.parameters())
        self.device = resolve_device(device,
                                     param if param.device.type != "cpu"
                                     else None)
        self.model = model.to(self.device).eval()
        self._replicas = {}  # the weights on other devices (encode_sharded)
        self.tokenizer = tokenizer
        self.pooling = pooling
        self.normalize = normalize
        self.max_length = max_length
        self.dim = cfg.hidden_size

    @classmethod
    def from_pretrained(cls, name_or_path: str, *, device=None,
                        **kwargs) -> "TorchSentenceEncoder":
        from transformers import AutoConfig, AutoModel, AutoTokenizer

        if "pooling" not in kwargs:
            # honor the checkpoint's own sentence-transformers pooling
            # config (nq-distilbert-base-v1 is CLS, not mean)
            declared = st_pooling_mode(name_or_path)
            if declared is not None:
                kwargs["pooling"] = declared
        hf_cfg = AutoConfig.from_pretrained(name_or_path)
        cfg = BertConfig.from_hf(hf_cfg)
        convert = (
            convert_distilbert_state_dict
            if getattr(hf_cfg, "model_type", "") == "distilbert"
            else convert_hf_state_dict
        )
        model = BertEncoderModel(cfg)
        model.load_state_dict(
            convert(AutoModel.from_pretrained(name_or_path).state_dict(), cfg)
        )
        tok = AutoTokenizer.from_pretrained(name_or_path)
        return cls(cfg, model, tok, device=device, **kwargs)

    @torch.no_grad()
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor,
                 model=None) -> torch.Tensor:
        hidden = (model or self.model)(ids, mask)
        if self.pooling == "cls":
            emb = hidden[:, 0]
        else:
            m = mask[:, :, None].to(hidden.dtype)
            emb = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
        if self.normalize:
            emb = emb / torch.clamp(
                torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12
            )
        return emb

    def encode_device(self, texts, batch_size: int = 64) -> torch.Tensor:
        """(N, D) fp32 embeddings as a tensor on the encoder's device — the
        retrieval pipeline hands it straight to the index search, with no
        device -> host -> device round trip. Every batch is padded to
        max_length (one shape for every call)."""
        outs = []
        for i in range(0, len(texts), batch_size):
            enc = self.tokenizer(
                list(texts[i : i + batch_size]), padding="max_length",
                truncation=True, max_length=self.max_length,
                return_tensors="np",
            )
            ids = torch.as_tensor(np.asarray(enc["input_ids"]),
                                  dtype=torch.long, device=self.device)
            mask = torch.as_tensor(np.asarray(enc["attention_mask"]),
                                   dtype=torch.long, device=self.device)
            outs.append(self._forward(ids, mask).float())
        return torch.cat(outs, dim=0)

    def encode(self, texts, batch_size: int = 64) -> np.ndarray:
        return self.encode_device(texts, batch_size).cpu().numpy()

    def _tokenize(self, texts):
        enc = self.tokenizer(list(texts), padding="max_length",
                             truncation=True, max_length=self.max_length,
                             return_tensors="np")
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    def encode_sharded(self, texts, dmesh, batch_size: int = 256
                       ) -> np.ndarray:
        """Data-parallel encode over a parallel/mesh.DeviceMesh: each batch
        is split over the mesh's positions, each part on its position's
        device and stream, the weights copied once per distinct device
        (models/encoder.encode_over_mesh). Returns host fp32, as corpus
        embeddings are stored; query-time work uses encode_device."""
        return encode_over_mesh(
            texts, dmesh, batch_size, self._tokenize,
            lambda dev: functools.partial(
                self._forward, model=model_on(self._replicas, self.model,
                                       dev)),
            self.dim)
