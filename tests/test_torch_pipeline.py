"""The port's Retriever against the JAX package's on the same Corpus and the
same encoder weights: same passages at k = 5 and k = 40, through delete,
extend and save/load (including a directory saved by the JAX package).

Tolerance: the two encoders agree to ~1e-6 (test_torch_encoder.py), so
distances are held to rtol/atol 1e-4 and ids agree up to swaps among
distances tied within it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.models import encoder as jenc
from cuvs_rag_tpu.models import flax_encoder as fe
from cuvs_rag_tpu.models import flax_qwen as fq
from cuvs_rag_tpu.rag.corpus import Corpus as JCorpus
from cuvs_rag_tpu.rag.pipeline import Retriever as JRetriever
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.models import bert_encoder as be
from cuvs_rag_tpu_torch.models import qwen_encoder as tq
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.pipeline import Retriever
from cuvs_rag_tpu_torch.utils import config as tconfig
from torch_parity import compare_topk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def encoders():
    cfg = fe.BertConfig(vocab_size=200, hidden_size=32, num_layers=2,
                        num_heads=4, intermediate_size=64, max_position=64)
    params = fe.BertEncoderModel(cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tok = jenc.HashTokenizer(cfg.vocab_size - 1)
    tcfg = be.BertConfig(**vars(cfg))
    model = be.BertEncoderModel(tcfg)
    model.load_state_dict(be.from_flax_params(params, tcfg))
    return (fe.FlaxSentenceEncoder(cfg, params, tok, max_length=32),
            be.TorchSentenceEncoder(tcfg, model, tok, max_length=32,
                                    device="cpu"))


def _passages(n=240):
    rng = np.random.default_rng(5)
    words = [f"t{i}" for i in range(150)]
    return [f"doc {i} " + " ".join(rng.choice(words, int(rng.integers(3, 20))))
            for i in range(n)]


@pytest.fixture
def pair(encoders):
    jencoder, tencoder = encoders
    passages = _passages()
    titles = [f"title {i}" for i in range(len(passages))]
    return (
        JRetriever.build(JCorpus(passages=list(passages), titles=list(titles)),
                         jencoder),
        Retriever.build(Corpus(passages=list(passages), titles=list(titles)),
                        tencoder),
        passages,
    )


def _queries(passages):
    return passages[:6] + ["t1 t2 t3", "doc t9 t40 t77", "nothing like it"]


def _assert_same(tr, jr, queries, k):
    d, i = tr.retrieve_ids(queries, k)
    rd, ri = jr.retrieve_ids(queries, k)
    assert i.shape == (len(queries), k)
    compare_topk(-d, i, -rd, ri, **TOL)  # sqeuclidean: smaller is better


@pytest.mark.parametrize("k", [5, 40])
def test_same_passages_as_jax_retriever(pair, k):
    jr, tr, passages = pair
    _assert_same(tr, jr, _queries(passages), k)
    res = tr.retrieve_batch(passages[:3], k)
    assert [r.passages[0].index for r in res] == [0, 1, 2]
    assert res[1].passages[0].text == passages[1]
    assert res[1].passages[0].title == "title 1"
    assert tr.assemble_context(passages[2], 2).startswith(passages[2])


def test_delete_and_extend_match_jax(pair):
    jr, tr, passages = pair
    for r in (jr, tr):
        r.delete([0, 3, 10])
    new = ["a brand new passage t5 t6", "another fresh doc t7"]
    assert list(jr.extend(new)) == list(tr.extend(new)) == [240, 241]
    assert tr.corpus.embeddings.shape == (242, 32)
    queries = _queries(passages) + new
    _assert_same(tr, jr, queries, 5)
    ids = tr.retrieve_ids(passages[:4] + new, 5)[1]
    assert not np.isin(ids, [0, 3, 10]).any()
    assert ids[-2:, 0].tolist() == [240, 241]


def test_save_load_round_trip_and_cross_load(pair, encoders, tmp_path):
    jr, tr, passages = pair
    tr.delete([4])
    jr.delete([4])
    tr.save(str(tmp_path / "torch"))
    jr.save(str(tmp_path / "jax"))
    _, tencoder = encoders
    queries = _queries(passages)
    want = tr.retrieve_ids(queries, 8)
    for d in ("torch", "jax"):
        loaded = Retriever.load(str(tmp_path / d), tencoder)
        assert loaded.corpus.titles[2] == "title 2"
        got = loaded.retrieve_ids(queries, 8)
        compare_topk(-got[0], got[1], -want[0], want[1], **TOL)
    # and the JAX package loads the port's directory
    jloaded = JRetriever.load(str(tmp_path / "torch"), encoders[0])
    _assert_same(tr, jloaded, queries, 8)


@pytest.mark.parametrize("k", [5, 40])
def test_jax_ivf_flat_retriever_loads_in_the_port(encoders, tmp_path, k):
    """A JAX Retriever(family="ivf_flat") saved to disk and loaded by the
    port returns the same passages (k = 5 runs K4's path, k = 40 K5's)."""
    jencoder, tencoder = encoders
    passages = _passages()
    jr = JRetriever.build(
        JCorpus(passages=list(passages)), jencoder, family="ivf_flat",
        params=jconfig.IVFFlatParams(n_lists=8),
        search_params=jconfig.IVFFlatSearchParams(n_probes=3))
    jr.delete([1, 6])
    jr.save(str(tmp_path / "jax_ivf"))
    tr = Retriever.load(str(tmp_path / "jax_ivf"), tencoder)
    assert tr.family == "ivf_flat" and tr.index.n_lists == 8
    assert tr.search_params == tconfig.IVFFlatSearchParams(n_probes=3)
    queries = _queries(passages)
    _assert_same(tr, jr, queries, k)
    ids = tr.retrieve_ids(queries, k)[1]
    assert not np.isin(ids, [1, 6]).any()
    # the port's own ivf_flat Retriever extends and saves for the JAX one
    assert list(tr.extend(["fresh text t3 t4"])) == [240]
    tr.save(str(tmp_path / "torch_ivf"))
    back = JRetriever.load(str(tmp_path / "torch_ivf"), jencoder)
    _assert_same(tr, back, queries + ["fresh text t3 t4"], k)


_PARAMS = {"flat": "FlatParams", "ivf_flat": "IVFFlatParams"}


@pytest.mark.parametrize("family", ["flat", "ivf_flat"])
def test_allow_filtered_retrieval_matches_jax(encoders, family):
    """retrieve/retrieve_ids/retrieve_batch with allow= keep to the mask and
    return the JAX Retriever's passages."""
    jencoder, tencoder = encoders
    passages = _passages()
    kw = {} if family == "flat" else dict(n_lists=8)
    jr = JRetriever.build(JCorpus(passages=list(passages)), jencoder,
                          family=family,
                          params=getattr(jconfig, _PARAMS[family])(**kw))
    tr = Retriever.build(Corpus(passages=list(passages)), tencoder,
                         family=family,
                         params=getattr(tconfig, _PARAMS[family])(**kw))
    allow = np.arange(len(passages)) % 2 == 1
    queries = _queries(passages)
    d, i = tr.retrieve_ids(queries, 8, allow=allow)
    rd, ri = jr.retrieve_ids(queries, 8, allow=allow)
    compare_topk(-d, i, -rd, ri, **TOL)
    assert allow[i[i >= 0]].all()
    res = tr.retrieve(passages[3], 4, allow=allow)
    assert res.passages[0].index == 3
    assert all(p.index % 2 == 1 for p in res.passages)
    batch = tr.retrieve_batch(passages[:2], 4, allow=torch.from_numpy(allow))
    assert 0 not in [p.index for p in batch[0].passages]
    assert batch[1].passages[0].index == 1


def test_unported_families_and_placements_raise(encoders, monkeypatch):
    """The shard and replicate placements (once refused as unported) give
    the JAX Retriever's passages on 4-position meshes, through delete and
    extend; a mesh left to its default means every visible card, never the
    CPU; unknown families and placements raise."""
    from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    jencoder, tencoder = encoders
    passages = _passages()
    queries = _queries(passages)
    for family, placement, kw, sp in (
            ("flat", "shard", dict(tile_n=64), None),
            ("ivf_flat", "replicate", dict(n_lists=8), "IVFFlatSearchParams")):
        name = _PARAMS[family]
        jr = JRetriever.build(
            JCorpus(passages=list(passages)), jencoder, family=family,
            params=getattr(jconfig, name)(**kw), placement=placement,
            dmesh=JMesh(jax.devices()[:4]),
            search_params=sp and getattr(jconfig, sp)(n_probes=8))
        tr = Retriever.build(
            Corpus(passages=list(passages)), tencoder, family=family,
            params=getattr(tconfig, name)(**kw), placement=placement,
            dmesh=DeviceMesh(["cpu"] * 4),
            search_params=sp and getattr(tconfig, sp)(n_probes=8))
        for r in (jr, tr):
            r.delete([3, 200])
            r.extend(["fresh text t3 t4"])
        _assert_same(tr, jr, queries + ["fresh text t3 t4"], 8)
    corpus = Corpus(passages=["a", "b"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Retriever.build(corpus, tencoder, placement="shard")
    with pytest.raises(ValueError, match="unknown placement"):
        Retriever.build(corpus, tencoder, placement="spread")
    with pytest.raises(ValueError, match="unknown family"):
        Retriever.build(corpus, tencoder, family="hnsw")


def test_index_device_is_never_chosen_silently(tmp_path):
    """A numpy or text corpus with an encoder that has no device goes to the
    card, as every entry point's device=None does; it never carries on on
    the CPU unasked. An explicit device wins, a tensor keeps its own, an
    encoder's device is taken; device="cpu" builds, saves, loads and
    answers."""
    from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
    from cuvs_rag_tpu_torch.rag import pipeline

    encoder = HashingEncoder(dim=16)
    passages = ["alpha beta", "gamma delta", "epsilon zeta"]
    cpu, card = torch.device("cpu"), torch.device("cuda")
    emb = encoder.encode(passages)

    class OnCpu:
        device = "cpu"

    assert pipeline._index_device(None, encoder) == card
    assert pipeline._index_device(None, encoder, emb) == card
    assert pipeline._index_device(None, encoder, torch.from_numpy(emb)) == cpu
    assert pipeline._index_device(None, OnCpu(), emb) == cpu
    assert pipeline._index_device("cpu", encoder, emb) == cpu
    assert pipeline._index_device("cuda", OnCpu(), torch.from_numpy(emb)) == card

    def build(dev):
        return Retriever.build(Corpus(passages=list(passages)), encoder,
                               device=dev)

    r = build("cpu")
    assert r.index.device == cpu
    assert r.retrieve_ids(passages, 1)[1][:, 0].tolist() == [0, 1, 2]
    r.save(str(tmp_path / "r"))

    def load(dev):
        return Retriever.load(str(tmp_path / "r"), encoder, device=dev)

    loaded = load("cpu")
    assert loaded.index.device == cpu
    assert loaded.retrieve_ids(passages, 1)[1][:, 0].tolist() == [0, 1, 2]
    for make in (build, load):
        if torch.cuda.is_available():
            assert make(None).index.device.type == "cuda"
        else:  # CUDA's own error, no CPU index
            with pytest.raises((RuntimeError, AssertionError)):
                make(None)


def test_import_leaves_jax_out():
    """The port never imports JAX, flax or the JAX package."""
    code = (
        "import sys, cuvs_rag_tpu_torch\n"
        "from cuvs_rag_tpu_torch.rag import pipeline\n"
        "from cuvs_rag_tpu_torch.models import bert_encoder, encoder\n"
        "from cuvs_rag_tpu_torch.models import qwen_encoder\n"
        "from cuvs_rag_tpu_torch.ops import attention_kernels, stream_kernels\n"
        "from cuvs_rag_tpu_torch.eval import roofline\n"
        "from cuvs_rag_tpu_torch.kernels import build\n"
        "from cuvs_rag_tpu_torch.index import io, filters, ivf_flat\n"
        "from cuvs_rag_tpu_torch.index import ivf_pq, refine\n"
        "from cuvs_rag_tpu_torch.ops import pq, pq_kernels\n"
        "from cuvs_rag_tpu_torch.rag import host_store\n"
        "from cuvs_rag_tpu_torch.eval import recall\n"
        "from cuvs_rag_tpu_torch import native\n"
        "from cuvs_rag_tpu_torch.rag import datasets, fusion, lexical, server\n"
        "from cuvs_rag_tpu_torch.index import faiss_io\n"
        "from cuvs_rag_tpu_torch.parallel import aggregator, elastic, mesh\n"
        "from cuvs_rag_tpu_torch.parallel import search, shard\n"
        "from cuvs_rag_tpu_torch.parallel import distributed\n"
        "from cuvs_rag_tpu_torch.utils import memory, profiling\n"
        "from cuvs_rag_tpu_torch.eval import bench, benchlog, plots\n"
        "from cuvs_rag_tpu_torch.eval import sweeps, topic_recall, tune\n"
        "from cuvs_rag_tpu_torch import main\n"
        "from cuvs_rag_tpu_torch.infra import multihost_worker\n"
        "from cuvs_rag_tpu_torch import bench\n"
        "from cuvs_rag_tpu_torch.scripts import common, bench_10m\n"
        "from cuvs_rag_tpu_torch.scripts import bench_pq_capacity\n"
        "from cuvs_rag_tpu_torch.scripts import bench_batch1, bench_filters\n"
        "from cuvs_rag_tpu_torch.scripts import bench_family_curves\n"
        "from cuvs_rag_tpu_torch.scripts import bench_int8_flat\n"
        "from cuvs_rag_tpu_torch.scripts import bench_ivf_int8, bench_ivf_pq\n"
        "from cuvs_rag_tpu_torch.scripts import bench_topk_large, bench_tune\n"
        "import runpy, os\n"
        "ex = os.path.join('cuvs_rag_tpu_torch', 'examples')\n"
        "for f in sorted(os.listdir(ex)):\n"
        "    if f.endswith('.py') and f != '__init__.py':\n"
        "        runpy.run_path(os.path.join(ex, f), run_name='import')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cuvs_rag_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _pq_pair(encoders, tmp_path, **params):
    """A JAX Retriever(family="ivf_pq") and the port's load of its save
    (builds differ by RNG, so the index is shared through the file)."""
    jencoder, tencoder = encoders
    passages = _passages()
    jr = JRetriever.build(
        JCorpus(passages=list(passages)), jencoder, family="ivf_pq",
        params=jconfig.IVFPQParams(n_lists=8, pq_dim=8, **params))
    jr.delete([1, 6])
    jr.save(str(tmp_path / "jax_pq"))
    tr = Retriever.load(str(tmp_path / "jax_pq"), tencoder)
    assert tr.family == "ivf_pq" and tr.search_params is None
    return jr, tr, passages


@pytest.mark.parametrize("store_raw", [True, False])
def test_jax_ivf_pq_retriever_loads_in_the_port(encoders, tmp_path,
                                                store_raw):
    """In core (the index's raw store) and out of core (store_raw=False:
    the refine fetches rows from the corpus' host embeddings), with the
    default search params resolved before the refine gate on both sides."""
    jr, tr, passages = _pq_pair(encoders, tmp_path, store_raw=store_raw)
    assert tr.index.has_raw == store_raw
    queries = _queries(passages)
    _assert_same(tr, jr, queries, 5)
    allow = np.arange(len(passages)) % 2 == 1
    d, i = tr.retrieve_ids(queries, 8, allow=allow)
    rd, ri = jr.retrieve_ids(queries, 8, allow=allow)
    compare_topk(-d, i, -rd, ri, **TOL)
    assert allow[i[i >= 0]].all() and not np.isin(i, [1, 6]).any()
    res = tr.retrieve(passages[3], 4, allow=allow)
    assert res.passages[0].index == 3 and res.passages[0].distance < 1e-3
    # both extend; the port's save loads in the JAX package
    new = ["fresh text t3 t4"]
    assert list(tr.extend(new)) == list(jr.extend(new)) == [240]
    _assert_same(tr, jr, queries + new, 5)
    tr.save(str(tmp_path / "torch_pq"))
    back = JRetriever.load(str(tmp_path / "torch_pq"), encoders[0])
    _assert_same(tr, back, queries + new, 5)


def test_own_ivf_pq_retriever_finds_its_passages(encoders):
    _, tencoder = encoders
    passages = _passages()
    tr = Retriever.build(
        Corpus(passages=list(passages)), tencoder, family="ivf_pq",
        params=tconfig.IVFPQParams(n_lists=8, pq_dim=8),
        search_params=tconfig.IVFPQSearchParams(n_probes=8, refine_ratio=8))
    assert tr.index.device == torch.device("cpu") and tr.index.levels == 2
    ids = tr.retrieve_ids(passages[:20], 3)[1]
    assert ids[:, 0].tolist() == list(range(20))
    tr.delete([2])
    assert 2 not in tr.retrieve_ids(passages[2:3], 5)[1]


def test_memmap_backed_retriever_saves_and_loads(encoders, tmp_path):
    """The out-of-core deployment: codes on the device, embeddings in a
    MemmapStore. Retrieval re-ranks on the host from the store, save
    records the store by path, load reopens it (in either package), and
    extend refuses the read-only store."""
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.rag.host_store import MemmapStore

    jencoder, tencoder = encoders
    passages = _passages()
    emb = tencoder.encode(passages)
    store = MemmapStore.create(str(tmp_path / "emb.bin"), *emb.shape,
                               dtype="float32")
    store.append_chunk(emb)
    store.finalize()
    store = MemmapStore.open(store.path)
    params = tconfig.IVFPQParams(n_lists=8, pq_dim=8, store_raw=False)
    index = ivf_pq.build_from_chunks(
        params, lambda i: store.chunk(i, 60), len(passages), emb.shape[1],
        n_chunks=4, device="cpu")
    sp = tconfig.IVFPQSearchParams(n_probes=8, refine_ratio=8)
    tr = Retriever(tencoder, index, Corpus(passages=list(passages),
                                           embeddings=store),
                   family="ivf_pq", search_params=sp, params=params)
    queries = _queries(passages)
    d, i = tr.retrieve_ids(queries, 5)
    assert i[:6, 0].tolist() == list(range(6)) and (d[:6, 0] < 1e-3).all()
    # the same index with the rows in host RAM re-ranks on the device
    ram = Retriever(tencoder, index, Corpus(passages=list(passages),
                                            embeddings=emb),
                    family="ivf_pq", search_params=sp, params=params)
    rd, ri = ram.retrieve_ids(queries, 5)
    compare_topk(-d, i, -rd, ri, **TOL)
    with pytest.raises(ValueError, match="read-only host store"):
        tr.extend(["one more"])
    assert len(tr.corpus.passages) == len(passages)
    tr.save(str(tmp_path / "saved"))
    assert not os.path.exists(str(tmp_path / "saved" / "embeddings.npy"))
    loaded = Retriever.load(str(tmp_path / "saved"), tencoder)
    assert isinstance(loaded.corpus.embeddings, MemmapStore)
    ld, li = loaded.retrieve_ids(queries, 5)
    np.testing.assert_array_equal(li, i)
    np.testing.assert_allclose(ld, d, **TOL)
    jloaded = JRetriever.load(str(tmp_path / "saved"), jencoder)
    _assert_same(tr, jloaded, queries, 5)


# --- the Qwen3 slice as a whole: text -> Qwen3 encoder -> flat -> passages ---


@pytest.fixture(scope="module")
def qwen_encoders():
    """The tiny Qwen3 encoder in both packages from the same weights, fp32,
    one HashTokenizer (every batch padded to max_length 32)."""
    tiny = dict(vocab_size=200, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=16, intermediate_size=96,
                rope_theta=10_000.0)
    fcfg = fq.QwenConfig(**tiny)
    params = fq.QwenModel(fcfg).init(
        jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tok = jenc.HashTokenizer(fcfg.vocab_size - 1)
    tcfg = tq.QwenConfig(**tiny)
    model = tq.QwenModel(tcfg)
    model.load_state_dict(tq.from_flax_params(params, tcfg))
    return (fq.QwenEmbeddingEncoder(fcfg, params, tok, max_length=32,
                                    dtype=jnp.float32, use_flash=False),
            tq.QwenEmbeddingEncoder(tcfg, model, tok, max_length=32,
                                    dtype=torch.float32, device="cpu"))


@pytest.fixture
def qwen_pair(qwen_encoders):
    jencoder, tencoder = qwen_encoders
    passages = [jenc.get_detailed_instruct("find the passage", p)
                for p in _passages(120)]
    return (JRetriever.build(JCorpus(passages=list(passages)), jencoder),
            Retriever.build(Corpus(passages=list(passages)), tencoder,
                            device="cpu"),
            passages)


@pytest.mark.parametrize("k", [5, 40])
def test_qwen_retriever_returns_the_jax_retrievers_passages(qwen_pair, k):
    """The same instruct-formatted texts through both packages' Qwen3
    encoders and flat indexes: the same passages (ids as sets up to ties),
    distances within rtol / atol 1e-4."""
    jr, tr, passages = qwen_pair
    assert tr.index.device == torch.device("cpu") and tr.index.dim == 64
    queries = passages[:6] + [
        jenc.get_detailed_instruct("find the passage", "t1 t2 t3"),
        "doc t9 t40 t77"]
    _assert_same(tr, jr, queries, k)
    res = tr.retrieve_batch(passages[:3], k)
    assert [r.passages[0].index for r in res] == [0, 1, 2]
    assert res[0].passages[0].distance < 1e-5


def test_qwen_retriever_delete_extend_and_filter_match_jax(qwen_pair):
    jr, tr, passages = qwen_pair
    for r in (jr, tr):
        r.delete([0, 7])
    new = [jenc.get_detailed_instruct("find the passage", "brand new t5 t6")]
    assert list(jr.extend(new)) == list(tr.extend(new)) == [120]
    queries = passages[:5] + new
    _assert_same(tr, jr, queries, 5)
    ids = tr.retrieve_ids(queries, 5)[1]
    assert not np.isin(ids, [0, 7]).any() and ids[-1, 0] == 120
    allow = np.arange(121) % 2 == 1
    d, i = tr.retrieve_ids(queries, 6, allow=allow)
    rd, ri = jr.retrieve_ids(queries, 6, allow=allow)
    compare_topk(-d, i, -rd, ri, **TOL)
    assert allow[i[i >= 0]].all()


def test_qwen_retriever_saves_and_loads(qwen_pair, qwen_encoders, tmp_path):
    _, tr, passages = qwen_pair
    tr.save(str(tmp_path / "qwen"))
    want = tr.retrieve_ids(passages[:8], 5)
    loaded = Retriever.load(str(tmp_path / "qwen"), qwen_encoders[1])
    got = loaded.retrieve_ids(passages[:8], 5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    jloaded = JRetriever.load(str(tmp_path / "qwen"), qwen_encoders[0])
    _assert_same(tr, jloaded, passages[:8], 5)
