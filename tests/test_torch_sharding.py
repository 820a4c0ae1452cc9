"""The port's mesh and corpus sharding (parallel/mesh.py, parallel/shard.py)
against the JAX package's, on a mesh of ["cpu"] * 8 beside the JAX
package's 8 virtual CPU devices (tests/conftest.py).

Layouts (sizes, offsets, valid rows) must be equal; blocks are the same
rows, so they are held bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from cuvs_rag_tpu.parallel import shard as jshard
from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
from cuvs_rag_tpu_torch.parallel import shard as tshard
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

torch.set_num_threads(1)

S = 8


def _mesh(s=S):
    return DeviceMesh(["cpu"] * s)


def test_mesh_has_8_positions():
    assert _mesh().num_devices == JMesh().num_devices == 8
    assert _mesh().first == torch.device("cpu")
    assert _mesh().stream(3) is None  # the CPU has no streams


def test_mesh_default_is_every_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMesh()
    with pytest.raises(RuntimeError):
        DeviceMesh([])


class _FakeStream:
    """Stands in for torch.cuda.Stream: records what it waited for."""

    def __init__(self, device=None):
        self.waited = []

    def wait_stream(self, other):
        self.waited.append(other)


class _FakeOut:
    """A shard output: remembers the stream it was launched on."""

    def __init__(self, launched_on):
        self.launched_on = launched_on

    def record_stream(self, stream):
        pass

    def to(self, device):
        return self


def _fake_cuda(monkeypatch, make_delay: float):
    """torch.cuda's stream calls replaced by fakes, so fan_out's stream
    handling runs on the CPU; each thread has its own current stream."""
    import contextlib
    import threading
    import time

    local = threading.local()
    made = []

    def make(device=None):
        time.sleep(make_delay)  # widen the window of a racing first use
        made.append(_FakeStream())
        return made[-1]

    def current(device=None):
        if not hasattr(local, "reader"):
            local.reader = _FakeStream()
        return local.reader

    @contextlib.contextmanager
    def on(stream):
        local.side = stream
        yield

    monkeypatch.setattr(torch.cuda, "Stream", make)
    monkeypatch.setattr(torch.cuda, "current_stream", current)
    monkeypatch.setattr(torch.cuda, "stream", on)
    return local, made


def test_concurrent_first_fan_out_waits_on_its_own_stream(monkeypatch):
    """Two threads make the first search of a fresh mesh at once (the
    daemon's dispatchers after a load): one stream is made a position, and
    each thread's reader waits for the very stream its shard work was
    launched on."""
    import threading

    local, made = _fake_cuda(monkeypatch, make_delay=0.05)
    mesh = DeviceMesh(["cuda:0"] * 2)
    start = threading.Barrier(2)
    seen, errors = [], []

    def search():
        try:
            start.wait()
            outs = mesh.fan_out(lambda i: (_FakeOut(local.side),),
                                range(mesh.num_devices))
            for (out,) in outs:
                if out.launched_on not in local.reader.waited:
                    raise AssertionError("read before its stream was waited")
            seen.append([o.launched_on for (o,) in outs])
        except Exception as e:  # reported in the main thread
            errors.append(e)

    threads = [threading.Thread(target=search) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(made) == mesh.num_devices
    assert seen[0] == seen[1] == [mesh.stream(0), mesh.stream(1)]


def test_device_infos_report_no_memory_on_the_cpu():
    infos = _mesh(2).device_infos()
    assert [i.index for i in infos] == [0, 1]
    assert infos[0].platform == "cpu" and infos[0].memory_free_bytes is None
    assert sorted(_mesh(2).memory_info()) == [0, 1]


@pytest.mark.parametrize("total", [1003, 8, 5, 64])
@pytest.mark.parametrize("strategy", ["even", "memory_based"])
def test_split_sizes_match_jax(total, strategy):
    """memory_based on devices that report no memory is the equal split
    rounded down, the remainder to the last position, in both packages."""
    sizes = _mesh().split_sizes(total, strategy)
    assert sizes == JMesh().split_sizes(total, strategy)
    assert sum(sizes) == total
    if strategy == "even":
        assert max(sizes) - min(sizes) <= 1


def test_validate_device_index():
    dmesh = _mesh()
    assert dmesh.validate_device_index(0)
    assert dmesh.validate_device_index(7)
    assert not dmesh.validate_device_index(8)
    assert not dmesh.validate_device_index(-1)


@pytest.mark.parametrize("total,s,rm", [(1003, 8, 8), (20, 8, 8),
                                        (6_290_000, 4, 2048), (64, 3, 64)])
def test_shard_layout_matches_jax(total, s, rm):
    per, n_valid, offsets = tshard.shard_layout(total, s, rm)
    jper, jn, joff = jshard.shard_layout(total, s, rm)
    assert per == jper and per % rm == 0
    np.testing.assert_array_equal(n_valid, jn)
    np.testing.assert_array_equal(offsets, joff)
    assert n_valid.sum() == total


def test_shard_corpus_round_trip(rng):
    corpus = rng.standard_normal((1003, 32)).astype(np.float32)
    sc = tshard.shard_corpus(corpus, _mesh())
    sc.validate()
    jsc = jshard.shard_corpus(corpus, JMesh())
    assert sc.num_shards == 8 and sc.per_shard == jsc.per_shard
    np.testing.assert_array_equal(np.stack([b.numpy() for b in sc.data]),
                                  np.asarray(jsc.data))
    np.testing.assert_array_equal(sc.n_valid, np.asarray(jsc.n_valid))
    np.testing.assert_array_equal(sc.offsets, np.asarray(jsc.offsets))
    np.testing.assert_array_equal(sc.gather_to_host(), corpus)


def test_shard_corpus_device_placement(rng):
    """Each block lies on its position's device; a block wholly inside a
    corpus tensor on that device is a view of it, and only a padded block
    is a copy."""
    corpus = torch.from_numpy(rng.standard_normal((60, 8)).astype(np.float32))
    sc = tshard.shard_corpus(corpus, _mesh(4))
    assert [b.device for b in sc.data] == [torch.device("cpu")] * 4
    assert sc.per_shard == 16 and sc.n_valid.tolist() == [16, 16, 16, 12]
    base = corpus.data_ptr()
    for i, blk in enumerate(sc.data[:3]):
        assert blk.data_ptr() == base + i * 16 * 8 * 4
    assert sc.data[3].data_ptr() != base + 3 * 16 * 8 * 4
    assert torch.equal(sc.data[3][12:], torch.zeros(4, 8))


def test_reshard_to_smaller_mesh(rng):
    corpus = rng.standard_normal((100, 8)).astype(np.float32)
    sc = tshard.shard_corpus(corpus, _mesh())
    sc2 = tshard.reshard(sc, _mesh(4))
    jsc2 = jshard.reshard(jshard.shard_corpus(corpus, JMesh()),
                          JMesh(jax.devices()[:4]))
    assert sc2.num_shards == 4
    np.testing.assert_array_equal(sc2.gather_to_host(), corpus)
    np.testing.assert_array_equal(sc2.offsets, np.asarray(jsc2.offsets))


def test_reshard_proportional_layout(rng):
    """A proportional layout (padding between shards) reshards to the
    same rows as the JAX package's host gather."""
    corpus = rng.standard_normal((100, 8)).astype(np.float32)
    sizes = [20, 30, 10, 8, 8, 8, 8, 8]
    per = 32
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    blocks = np.zeros((8, per, 8), np.float32)
    for i, (o, nv) in enumerate(zip(offs, sizes)):
        blocks[i, :nv] = corpus[o:o + nv]
    sc = tshard.ShardedCorpus(data=[torch.from_numpy(b) for b in blocks],
                              n_valid=np.asarray(sizes, np.int32),
                              offsets=offs, total=100)
    sc.validate()
    sc2 = tshard.reshard(sc, _mesh(4))
    assert sc2.num_shards == 4
    np.testing.assert_array_equal(sc2.gather_to_host(), corpus)


def test_bad_layouts_rejected():
    with pytest.raises(AssertionError, match="coverage"):
        tshard._validate_layout(10, 8, np.array([8, 1]), np.array([0, 8]))
    with pytest.raises(AssertionError, match="out of bounds"):
        tshard._validate_layout(10, 4, np.array([8, 2]), np.array([0, 4]))
    with pytest.raises(AssertionError, match="neither"):
        tshard._validate_layout(10, 8, np.array([5, 5]), np.array([0, 3]))


def test_empty_corpus_rejected():
    with pytest.raises(ValueError):
        tshard.shard_corpus(np.zeros((0, 8), np.float32), _mesh())


def test_memory_based_sharding_proportional(rng, monkeypatch):
    """memory_based gives proportional shards with exact global offsets,
    and the fan-out search over them returns the single index's ids, as
    the JAX package's does."""
    import jax.numpy as jnp

    from cuvs_rag_tpu.parallel import search as jsearch
    from cuvs_rag_tpu.utils.config import FlatParams as JFlatParams
    from cuvs_rag_tpu_torch.index import flat as tflat
    from cuvs_rag_tpu_torch.parallel import search as tsearch
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n, d = 1000, 32
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = corpus[[5, 500, 900]]
    sizes = [300, 200, 150, 100, 100, 70, 50, 30]
    for cls in (DeviceMesh, JMesh):
        monkeypatch.setattr(cls, "split_sizes",
                            lambda self, total, strategy="even": list(sizes))
    sc = tshard.shard_corpus(corpus, _mesh(), strategy="memory_based")
    assert sc.n_valid.tolist() == sizes
    assert sc.offsets.tolist() == [0, 300, 500, 650, 750, 850, 920, 970]
    np.testing.assert_array_equal(sc.gather_to_host(), corpus)

    six = tsearch.build_sharded("flat", FlatParams(), sc, _mesh())
    _, ids = tsearch.search_sharded(None, six, queries, 5, _mesh())
    _, want = tflat.search(None, tflat.build(FlatParams(), corpus,
                                             device="cpu"), queries, 5)
    np.testing.assert_array_equal(ids.numpy(), want.numpy())
    jsc = jshard.shard_corpus(corpus, JMesh(), strategy="memory_based")
    jsix = jsearch.build_sharded("flat", JFlatParams(), jsc, JMesh())
    _, jids = jsearch.search_sharded(None, jsix, jnp.asarray(queries), 5,
                                     JMesh())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_memory_based_unknown_strategy_rejected(rng):
    with pytest.raises(ValueError, match="unknown strategy"):
        tshard.shard_corpus(rng.standard_normal((64, 8)).astype(np.float32),
                            _mesh(), strategy="bogus")
