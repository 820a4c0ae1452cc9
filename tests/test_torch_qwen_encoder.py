"""The port's Qwen3 encoder against the JAX package's flax Qwen3 (same
weights via from_flax_params), against the vendored tiny_qwen checkpoint's
golden embeddings, and its parts against their JAX functions.

Tolerances: hidden states atol 2e-4 / rtol 2e-3 at non-pad positions (what
tests/test_flax_qwen.py holds the JAX model to against HF); whole encoders
atol 1e-5 in fp32 (unit-norm embeddings, two layers summed in another
order); fixture goldens 2e-3, as tests/test_encoder_fixtures.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.models import flax_qwen as fq
from cuvs_rag_tpu_torch.models import qwen_encoder as tq

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_qwen")
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96,
            rope_theta=10_000.0)


class StubTok:
    """Whitespace tokenizer with the HF call signature; pads to the longest
    text of the batch, on the left when asked."""

    def __init__(self, left=False):
        self.left = left

    def __call__(self, texts, padding=None, truncation=None, max_length=16,
                 return_tensors=None):
        toks = [[hash(w) % 127 + 1 for w in t.split()][:max_length]
                for t in texts]
        width = max(len(t) for t in toks)
        ids = np.zeros((len(texts), width), np.int64)
        mask = np.zeros((len(texts), width), np.int64)
        for i, t in enumerate(toks):
            sl = slice(width - len(t), width) if self.left else slice(len(t))
            ids[i, sl] = t
            mask[i, sl] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def pair():
    """A flax-initialised tiny QwenModel and the port's model holding the
    same weights (norm weights perturbed away from their initial ones)."""
    fcfg = fq.QwenConfig(**TINY)
    fmodel = fq.QwenModel(fcfg)
    params = fmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.ndim(a) >= 2 else
        (1.0 + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        params)
    tcfg = tq.QwenConfig(**TINY)
    tmodel = tq.QwenModel(tcfg)
    tmodel.load_state_dict(tq.from_flax_params(params, tcfg))
    return fcfg, fmodel, params, tcfg, tmodel.eval()


def _masks(kind, b=3, s=12):
    mask = np.ones((b, s), np.int32)
    if kind in ("right", "mixed"):
        mask[1, 7:] = 0
        mask[2, 5:] = 0
    if kind in ("left", "mixed"):
        mask[0, :4] = 0
        mask[2, :2] = 0
    return mask


@pytest.mark.parametrize("padding", ["none", "right", "left", "mixed"])
def test_from_flax_params_hidden_states(pair, padding):
    _, fmodel, params, _, tmodel = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (3, 12)).astype(np.int32)
    mask = _masks(padding)
    ids[mask == 0] = 0
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long()).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    # pad positions are unused downstream (and masked differently there)
    sel = mask.astype(bool)
    np.testing.assert_allclose(got[sel], want[sel], atol=2e-4, rtol=2e-3)


def test_state_dict_names_and_shapes(pair):
    _, _, params, tcfg, tmodel = pair
    sd = tq.from_flax_params(params, tcfg)
    assert sd.keys() == tmodel.state_dict().keys()
    assert sd["layers.1.k_proj.weight"].shape == (2 * 16, 64)  # (out, in)
    assert sd["layers.0.q_norm"].shape == (16,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_and_keeps_dtype(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq._rms_norm(tx, torch.from_numpy(w), 1e-6)
    assert got.dtype == tx.dtype  # the fp32 weight must not promote
    want = fq._rms_norm(jnp.asarray(tx.float().numpy()).astype(dtype),
                        jnp.asarray(w), 1e-6)
    assert want.dtype == jnp.dtype(dtype)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" \
        else dict(atol=1.6e-2, rtol=1.6e-2)  # one bf16 rounding apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.maximum(np.arange(9) - 3, 0)])
    got = tq._rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(fq._rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_last_token_pool_matches():
    hidden = np.arange(3 * 4 * 3, dtype=np.float32).reshape(3, 4, 3)
    mask = np.asarray([[1, 1, 1, 0], [0, 0, 1, 1], [0, 1, 1, 0]], np.int32)
    got = tq.last_token_pool(torch.from_numpy(hidden),
                             torch.from_numpy(mask)).numpy()
    want = np.asarray(fq.last_token_pool(jnp.asarray(hidden),
                                         jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    # right, left and mixed padding: the largest set position
    np.testing.assert_array_equal(got, hidden[[0, 1, 2], [2, 3, 2]])


TEXTS = ["hello world", "marsupials of australia are many and varied",
         "hello world", "a b c d e f g h i j k l m n o p q r s t"]


@pytest.mark.parametrize("left", [False, True])
def test_encoder_matches_jax_encoder(pair, left):
    """The whole encode (tokenize, stack, pool, normalize) in both packages
    with one stub tokenizer, right- and left-padding."""
    fcfg, _, params, tcfg, tmodel = pair
    tok = StubTok(left)
    fenc = fq.QwenEmbeddingEncoder(fcfg, params, tok, max_length=16,
                                   dtype=jnp.float32, use_flash=False)
    tenc = tq.QwenEmbeddingEncoder(tcfg, tmodel, tok, max_length=16,
                                   dtype=torch.float32, device="cpu")
    want = fenc.encode(TEXTS, batch_size=2)
    dev = tenc.encode_device(TEXTS, batch_size=2)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    got = tenc.encode(TEXTS, batch_size=2)
    assert got.shape == (4, 64) and tenc.dim == 64
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got[0], got[2])  # deterministic
    assert tenc.encode_device([]).shape == (0, 64)


@pytest.mark.parametrize("left", [False, True])
def test_batch_composition_invariance(pair, left):
    """A text encoded alone and inside a batch with longer texts embeds the
    same: the pad mask reaches the attention."""
    _, _, _, tcfg, tmodel = pair
    tenc = tq.QwenEmbeddingEncoder(tcfg, tmodel, StubTok(left), max_length=32,
                                   dtype=torch.float32, device="cpu")
    alone = tenc.encode(TEXTS[:1])
    together = tenc.encode(TEXTS, batch_size=4)
    np.testing.assert_allclose(together[:1], alone, atol=1e-6)


def test_encoder_dtypes_and_device(pair):
    """Matrices in `dtype` (bf16 by default), norm weights fp32, fp32 out."""
    _, _, params, tcfg, _ = pair
    model = tq.QwenModel(tcfg)
    model.load_state_dict(tq.from_flax_params(params, tcfg))
    enc = tq.QwenEmbeddingEncoder(tcfg, model, StubTok(), max_length=16,
                                  device="cpu")
    assert enc.device == torch.device("cpu")
    sd = enc.model.state_dict()
    assert sd["embed.weight"].dtype == torch.bfloat16
    assert sd["layers.0.up_proj.weight"].dtype == torch.bfloat16
    assert sd["layers.0.q_norm"].dtype == torch.float32
    assert sd["final_ln"].dtype == torch.float32
    emb = enc.encode(TEXTS)
    assert emb.dtype == np.float32 and np.isfinite(emb).all()
    ref = tq.QwenEmbeddingEncoder(tcfg, pair[4], StubTok(), max_length=16,
                                  dtype=torch.float32, device="cpu")
    # bf16 weights and activations against fp32 ones: cosine, not equality
    assert (emb * ref.encode(TEXTS)).sum(1).min() > 0.99


def _fixture_cfg():
    with open(os.path.join(FIXDIR, "config.json")) as f:
        raw = json.load(f)
    return tq.QwenConfig(
        vocab_size=raw["vocab_size"], hidden_size=raw["hidden_size"],
        intermediate_size=raw["intermediate_size"],
        num_layers=raw["num_hidden_layers"],
        num_heads=raw["num_attention_heads"],
        num_kv_heads=raw["num_key_value_heads"], head_dim=raw["head_dim"],
        rope_theta=raw["rope_theta"], rms_eps=raw["rms_norm_eps"])


def test_checkpoint_fixture_matches_golden():
    """state_dict.pt through convert_hf_state_dict reproduces the golden
    embeddings the HF reference pipeline gave."""
    g = np.load(os.path.join(FIXDIR, "golden.npz"), allow_pickle=False)
    cfg = _fixture_cfg()
    sd = torch.load(os.path.join(FIXDIR, "state_dict.pt"), map_location="cpu",
                    weights_only=True)
    model = tq.QwenModel(cfg)
    model.load_state_dict(tq.convert_hf_state_dict(sd, cfg))
    ids = torch.from_numpy(g["input_ids"]).long()
    mask = torch.from_numpy(g["attention_mask"]).long()
    with torch.no_grad():
        emb = tq.last_token_pool(model.eval()(ids, mask), mask)
    emb = torch.nn.functional.normalize(emb, dim=1).numpy()
    np.testing.assert_allclose(emb, g["embeddings"], atol=2e-3, rtol=2e-3)


def test_hf_state_dict_conversion_matches_flax():
    """convert_hf_state_dict (torch layout) and the JAX package's converter
    followed by from_flax_params describe the same model."""
    cfg = _fixture_cfg()
    sd = torch.load(os.path.join(FIXDIR, "state_dict.pt"), map_location="cpu",
                    weights_only=True)
    direct = tq.convert_hf_state_dict(sd, cfg)
    fparams = fq.convert_hf_state_dict(sd, fq.QwenConfig(**vars(cfg)))
    via_flax = tq.from_flax_params(fparams, cfg)
    assert direct.keys() == via_flax.keys()
    for key in direct:
        torch.testing.assert_close(direct[key], via_flax[key], rtol=0, atol=0)


def test_config_defaults_and_from_hf():
    """The defaults are the Qwen3-Embedding-0.6B widths, as the JAX
    package's; from_hf reads a HF config object."""
    assert vars(tq.QwenConfig()) == vars(fq.QwenConfig())

    class HF:
        vocab_size, hidden_size, num_hidden_layers = 50, 32, 3
        num_attention_heads, num_key_value_heads = 4, 2
        intermediate_size, rope_theta, rms_norm_eps = 48, 5e5, 1e-5

    got = tq.QwenConfig.from_hf(HF)
    assert vars(got) == vars(fq.QwenConfig.from_hf(HF))
    assert got.head_dim == 8  # hidden / heads when the config names none


def test_random_init_is_seeded():
    cfg = tq.QwenConfig(**TINY)
    a = tq.QwenModel(cfg).init_random_(torch.Generator().manual_seed(3))
    b = tq.QwenModel(cfg).init_random_(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.all(a.layers[0].q_norm == 1)
    assert 0.015 < float(a.embed.weight.detach().std()) < 0.025


def test_encode_sharded_waits_for_the_multi_gpu_slice(pair):
    _, _, _, tcfg, tmodel = pair
    enc = tq.QwenEmbeddingEncoder(tcfg, tmodel, StubTok(), device="cpu",
                                  dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="slice 6"):
        enc.encode_sharded(TEXTS, None)


def test_make_encoder_dispatches_qwen_checkpoints(tmp_path, monkeypatch):
    """make_encoder(name, device=...) sends model_type qwen* to
    QwenEmbeddingEncoder.from_pretrained."""
    transformers = pytest.importorskip("transformers")
    from cuvs_rag_tpu_torch.models import encoder as tenc

    class Cfg:
        model_type = "qwen3"

    seen = {}
    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained",
                        staticmethod(lambda name: Cfg()))
    monkeypatch.setattr(
        tq.QwenEmbeddingEncoder, "from_pretrained",
        classmethod(lambda cls, name, **kw: seen.update(name=name, **kw)
                    or "encoder"))
    assert tenc.make_encoder("some/qwen", device="cpu",
                             max_length=64) == "encoder"
    assert seen == {"name": "some/qwen", "device": "cpu", "max_length": 64}


@pytest.mark.parametrize("model_type", ["qwen3", "bert"])
def test_make_encoder_without_a_device_means_the_card(monkeypatch, model_type):
    """make_encoder(name) with no device goes to the package's own module
    with device=None, which resolve_device turns into the card; it never
    picks the transformers-backed CPU encoder."""
    transformers = pytest.importorskip("transformers")
    from cuvs_rag_tpu_torch.index.base import resolve_device
    from cuvs_rag_tpu_torch.models import bert_encoder
    from cuvs_rag_tpu_torch.models import encoder as tenc

    class Cfg:
        pass

    Cfg.model_type = model_type
    seen = {}
    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained",
                        staticmethod(lambda name: Cfg()))

    def refuse(self, *args, **kwargs):
        raise AssertionError("make_encoder picked TransformersEncoder")

    monkeypatch.setattr(tenc.TransformersEncoder, "__init__", refuse)
    for cls in (tq.QwenEmbeddingEncoder, bert_encoder.TorchSentenceEncoder):
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda cls, name, **kw: seen.update(cls=cls.__name__, **kw)))
    tenc.make_encoder("some/checkpoint")
    want = ("QwenEmbeddingEncoder" if model_type == "qwen3"
            else "TorchSentenceEncoder")
    assert seen == {"cls": want, "device": None}
    assert resolve_device(seen["device"]) == torch.device("cuda")
