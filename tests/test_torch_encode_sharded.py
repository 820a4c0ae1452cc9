"""Data-parallel corpus encode (rag/pipeline.encode_sharded and the
encoders' own encode_sharded) against serial encode and the JAX package's
encode_sharded: host encoders get ordered threads (exactly equal), the
port's model encoders split each batch over the mesh's positions (max abs
< 1e-4: the same forward over other batch groupings)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.models import encoder as jenc
from cuvs_rag_tpu.models import flax_encoder as fe
from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
from cuvs_rag_tpu.rag import pipeline as jpl
from cuvs_rag_tpu_torch.models import bert_encoder as be
from cuvs_rag_tpu_torch.models import qwen_encoder as tq
from cuvs_rag_tpu_torch.models.encoder import (HashingEncoder,
                                               TfidfHashingEncoder)
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.rag import pipeline as pl

torch.set_num_threads(1)

TEXTS = ["doc %d about %s" % (i, "abcdef"[i % 6]) for i in range(37)]


def _mesh(s=8):
    return DeviceMesh(["cpu"] * s)


def test_host_encoder_threaded_parity():
    enc = HashingEncoder(dim=64)
    got = pl.encode_sharded(enc, TEXTS, _mesh(), batch_size=4)
    np.testing.assert_array_equal(got, enc.encode(TEXTS))
    np.testing.assert_array_equal(
        got, jpl.encode_sharded(jenc.HashingEncoder(dim=64), TEXTS, JMesh(),
                                batch_size=4))


def test_host_encoder_explicit_workers():
    enc = TfidfHashingEncoder(dim=128).fit(TEXTS)
    got = pl.encode_sharded(enc, TEXTS, None, batch_size=4, workers=3)
    np.testing.assert_array_equal(got, np.asarray(enc.encode(TEXTS),
                                                  np.float32))


def test_small_input_stays_serial():
    enc = HashingEncoder(dim=32)
    got = pl.encode_sharded(enc, TEXTS[:3], _mesh(), batch_size=256)
    np.testing.assert_array_equal(got, enc.encode(TEXTS[:3]))


def test_device_encoder_delegates_to_its_own():
    calls = {}

    class _Own:
        dim = 8

        def encode_sharded(self, texts, dmesh, batch_size):
            calls["args"] = (len(texts), dmesh, batch_size)
            return np.ones((len(texts), 8), np.float32)

        def encode(self, texts, batch_size=0):
            raise AssertionError("delegation skipped")

    dm = _mesh()
    out = pl.encode_sharded(_Own(), TEXTS, dm, batch_size=16)
    assert out.shape == (len(TEXTS), 8)
    assert calls["args"] == (len(TEXTS), dm, 16)


def test_retriever_build_shard_uses_threaded_host_encode():
    """Retriever.build(placement="shard") encodes with the same embeddings
    as a serial host encode (order kept across chunks)."""
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    enc = HashingEncoder(dim=64)
    r = pl.Retriever.build(Corpus(passages=list(TEXTS)), enc, family="flat",
                           params=FlatParams(tile_n=8), placement="shard",
                           dmesh=_mesh())
    np.testing.assert_array_equal(np.asarray(r.corpus.embeddings),
                                  enc.encode(TEXTS))
    assert r.retrieve(TEXTS[9], k=1).passages[0].index == 9


@pytest.mark.parametrize("s,batch", [(8, 8), (3, 7), (4, 256)])
def test_sentence_encoder_encode_sharded(s, batch):
    """TorchSentenceEncoder.encode_sharded over s positions: its own encode
    and the JAX package's encode_sharded on the same weights, within 1e-4,
    rows in order, the last batch padded with its last text."""
    fcfg = fe.BertConfig(vocab_size=100, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64, max_position=64)
    params = jax.tree_util.tree_map(np.asarray, fe.BertEncoderModel(
        fcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                   jnp.ones((1, 8), jnp.int32)))
    tcfg = be.BertConfig(**vars(fcfg))
    model = be.BertEncoderModel(tcfg)
    model.load_state_dict(be.from_flax_params(params, tcfg))
    tok = jenc.HashTokenizer(fcfg.vocab_size - 1)
    enc = be.TorchSentenceEncoder(tcfg, model.eval(), tok, max_length=16,
                                  device="cpu")
    got = enc.encode_sharded(TEXTS, _mesh(s), batch_size=batch)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 32)
    assert float(np.abs(got - enc.encode(TEXTS)).max()) < 1e-4
    want = fe.FlaxSentenceEncoder(fcfg, params, tok, max_length=16
                                  ).encode_sharded(TEXTS, JMesh(
                                      jax.devices()[:s]), batch_size=batch)
    assert float(np.abs(got - want).max()) < 1e-4
    assert enc.encode_sharded([], _mesh(s)).shape == (0, 32)


def test_qwen_encoder_encode_sharded():
    cfg = tq.QwenConfig(vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=16,
                        intermediate_size=96)
    model = tq.QwenModel(cfg).init_random_(torch.Generator().manual_seed(2))
    enc = tq.QwenEmbeddingEncoder(cfg, model, jenc.HashTokenizer(127),
                                  max_length=16, device="cpu",
                                  dtype=torch.float32)
    got = enc.encode_sharded(TEXTS, _mesh(4), batch_size=8)
    assert float(np.abs(got - enc.encode(TEXTS)).max()) < 1e-4
