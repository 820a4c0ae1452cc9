"""The port's elastic layer (parallel/elastic.py) against the JAX package's
behaviour: retries with backoff, build history, health probes with failure
injection by mesh POSITION, and heal() rebuilding on the survivors from a
host copy or a re-read corpus source, with the same answers before and
after (exact flat search: the rows' own ids at top-1)."""

import numpy as np
import pytest
import torch

import jax

from cuvs_rag_tpu.parallel import elastic as jelastic
from cuvs_rag_tpu_torch.parallel import elastic
from cuvs_rag_tpu_torch.parallel import search as tps
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils.config import FlatParams

torch.set_num_threads(1)


def _mesh(s=8):
    return DeviceMesh(["cpu"] * s)


def test_with_retries_eventual_success():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert elastic.with_retries(flaky, max_retries=3,
                                base_backoff_s=0.0) == "ok"
    assert calls["n"] == 3


def test_with_retries_exhaustion():
    with pytest.raises(RuntimeError, match="always"):
        elastic.with_retries(
            lambda: (_ for _ in ()).throw(RuntimeError("always")),
            max_retries=1, base_backoff_s=0.0)


def test_health_monitor_fails_positions_not_devices():
    """Positions 0 and 3 of a mesh that repeats one device fail alone, as
    the JAX package's monitor fails devices 0 and 3 of its 8."""
    mon = elastic.DeviceHealthMonitor(fail_device_ids={0, 3})
    health = mon.probe(_mesh().devices)
    want = jelastic.DeviceHealthMonitor(fail_device_ids={0, 3}).probe(
        jax.devices())
    assert health == want
    assert health[0] is False and health[3] is False
    assert all(health[i] for i in (1, 2, 4, 5, 6, 7))
    assert len(mon.surviving_devices(_mesh().devices)) == 6


def test_elastic_index_heals_after_device_loss(rng):
    corpus = rng.standard_normal((800, 16)).astype(np.float32)
    eix = elastic.ElasticShardedIndex("flat", FlatParams(tile_n=8), corpus,
                                      dmesh=_mesh(), max_retries=0)
    assert eix.dmesh.num_devices == 8
    q = corpus[[5, 400]]
    _, i0 = eix.search(None, q, 1)
    assert i0[:, 0].tolist() == [5, 400]
    eix.monitor = elastic.DeviceHealthMonitor(fail_device_ids={1, 6})
    assert eix.heal() is True
    assert eix.dmesh.num_devices == 6 and eix.index.num_shards == 6
    _, i1 = eix.search(None, q, 1)
    assert i1[:, 0].tolist() == [5, 400]
    eix.monitor = elastic.DeviceHealthMonitor()
    assert eix.heal() is False
    summary = eix.history.summary()
    assert summary["total_builds"] == 2
    assert summary["success_rate"] == 1.0


def test_build_history_records_failures(rng):
    corpus = rng.standard_normal((100, 8)).astype(np.float32)
    with pytest.raises(KeyError):
        elastic.ElasticShardedIndex("nonexistent_family", FlatParams(),
                                    corpus, dmesh=_mesh(), max_retries=0)
    history = elastic.BuildHistory()
    history.add(elastic.BuildRecord("flat", 8, 100, False, 0.1, 1, "boom"))
    assert history.summary() == {"total_builds": 1, "successful_builds": 0,
                                 "success_rate": 0.0, "avg_build_time_s": 0.0}


def test_elastic_corpus_source_heals_without_ram_copy(rng, tmp_path):
    """heal() with a corpus_source callable re-reads the rows from storage;
    no copy stays in memory between rebuilds."""
    corpus = rng.standard_normal((800, 16)).astype(np.float32)
    path = tmp_path / "corpus.npy"
    np.save(path, corpus)
    calls = {"n": 0}

    def source():
        calls["n"] += 1
        return np.load(path, mmap_mode="r")

    mon = elastic.DeviceHealthMonitor()
    eix = elastic.ElasticShardedIndex("flat", FlatParams(),
                                      corpus_source=source, monitor=mon,
                                      dmesh=_mesh())
    assert eix.corpus_host is None and calls["n"] == 1
    mon.fail_device_ids = {0, 5}
    assert eix.heal()
    assert calls["n"] == 2
    assert eix.dmesh.num_devices == 6
    _, ids = tps.search_sharded(None, eix.index, corpus[[3, 700]], 1,
                                eix.dmesh)
    assert ids[:, 0].tolist() == [3, 700]


def test_elastic_requires_exactly_one_corpus_argument():
    with pytest.raises(ValueError, match="exactly one"):
        elastic.ElasticShardedIndex("flat", FlatParams(), dmesh=_mesh())
    with pytest.raises(ValueError, match="exactly one"):
        elastic.ElasticShardedIndex(
            "flat", FlatParams(), corpus_host=np.zeros((8, 4), np.float32),
            corpus_source=lambda: None, dmesh=_mesh())
