"""The port's BERT-family encoder against the JAX package's flax encoder
(same weights via from_flax_params), against the vendored HF checkpoints'
golden embeddings, and the copied numpy encoders against their originals.

Tolerances: flax vs torch hidden states and pooled embeddings rtol/atol
1e-4 in fp32 (matmul, softmax, erf-GELU and LayerNorm summed in another
order through 2 layers); fixture goldens 2e-3, as
tests/test_encoder_fixtures.py holds the JAX package to.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.models import encoder as jenc
from cuvs_rag_tpu.models import flax_encoder as fe
from cuvs_rag_tpu_torch.models import bert_encoder as be
from cuvs_rag_tpu_torch.models import encoder as tenc

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(type_vocab_size):
    """A random flax BERT and the port's model holding the same weights."""
    fcfg = fe.BertConfig(vocab_size=100, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64, max_position=64,
                         type_vocab_size=type_vocab_size)
    fmodel = fe.BertEncoderModel(fcfg)
    params = fmodel.init(jax.random.PRNGKey(type_vocab_size),
                         jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = be.BertConfig(**vars(fcfg))
    tmodel = be.BertEncoderModel(tcfg)
    tmodel.load_state_dict(be.from_flax_params(params, tcfg))
    return fcfg, fmodel, params, tcfg, tmodel.eval()


@pytest.mark.parametrize("type_vocab_size", [2, 0])  # BERT, DistilBERT-style
def test_from_flax_params_hidden_states(type_vocab_size):
    fcfg, fmodel, params, _, tmodel = _pair(type_vocab_size)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 100, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0  # padded row
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_sentence_encoder_matches_flax(pooling):
    fcfg, _, params, tcfg, tmodel = _pair(2)
    tok = jenc.HashTokenizer(fcfg.vocab_size - 1)
    texts = ["hello world", "foo bar baz qux", "hello world", "a b c d e f g"]
    fenc = fe.FlaxSentenceEncoder(fcfg, params, tok, pooling=pooling,
                                  max_length=16)
    tenc_ = be.TorchSentenceEncoder(tcfg, tmodel, tok, pooling=pooling,
                                    max_length=16, device="cpu")
    want = fenc.encode(texts, batch_size=3)
    got_dev = tenc_.encode_device(texts, batch_size=3)
    assert isinstance(got_dev, torch.Tensor) and got_dev.dtype == torch.float32
    got = tenc_.encode(texts, batch_size=3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(got[0], got[2])  # deterministic


@pytest.mark.parametrize("name,pooling", [
    ("tiny_bert", "mean"), ("tiny_distilbert", "cls"),
])
def test_checkpoint_fixture_matches_golden(name, pooling):
    """from_pretrained: HF load -> convert_*_state_dict -> tokenize -> pool
    (honoring 1_Pooling/config.json) -> normalize reproduces the goldens."""
    pytest.importorskip("transformers")
    g = np.load(os.path.join(FIXDIR, name, "golden.npz"), allow_pickle=False)
    enc = be.TorchSentenceEncoder.from_pretrained(
        os.path.join(FIXDIR, name), max_length=int(g["max_length"]),
        device="cpu",
    )
    assert enc.pooling == pooling
    got = enc.encode([str(t) for t in g["texts"]])
    np.testing.assert_allclose(got, g["embeddings"], atol=2e-3, rtol=2e-3)


def test_hf_state_dict_conversion_matches_flax():
    """convert_hf_state_dict (torch layout) and the JAX package's converter
    (flax layout) describe the same model."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32,
    )
    torch.manual_seed(0)
    sd = transformers.BertModel(hf_cfg).state_dict()
    fcfg = fe.BertConfig.from_hf(hf_cfg)
    fparams = jax.tree_util.tree_map(np.asarray, fe.convert_hf_state_dict(sd, fcfg))
    tcfg = be.BertConfig.from_hf(hf_cfg)
    direct = be.convert_hf_state_dict(sd, tcfg)
    via_flax = be.from_flax_params(fparams, tcfg)
    assert direct.keys() == via_flax.keys()
    for key in direct:
        torch.testing.assert_close(direct[key], via_flax[key], rtol=0, atol=0)


def test_random_init_is_seeded():
    cfg = be.BertConfig(vocab_size=50, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32, max_position=32)
    a = be.BertEncoderModel(cfg).init_random_(torch.Generator().manual_seed(3))
    b = be.BertEncoderModel(cfg).init_random_(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.all(a.layers[0].ln_ff.weight == 1)


def test_numpy_encoders_match_originals():
    texts = ["The cat sat on the mat.", "a quick brown fox", "the cat"]
    np.testing.assert_array_equal(tenc.HashingEncoder(64).encode(texts),
                                  jenc.HashingEncoder(64).encode(texts))
    t, j = tenc.TfidfHashingEncoder(128).fit(texts), \
        jenc.TfidfHashingEncoder(128).fit(texts)
    np.testing.assert_array_equal(t.encode(texts), j.encode(texts))
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(
            tenc.HashTokenizer(1000)(texts, max_length=8)[key],
            jenc.HashTokenizer(1000)(texts, max_length=8)[key])
