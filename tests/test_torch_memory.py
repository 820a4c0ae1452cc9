"""utils/memory.py of the port against the JAX package's: the planning
arithmetic equal over a grid, the CAGRA estimate equal to a port-built
index's bytes, and the OOM translation and live accounting of the CUDA
allocator (the JAX package's tests/test_memory.py, six tests)."""

import itertools

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.utils import memory as jmem
from cuvs_rag_tpu_torch.index import cagra
from cuvs_rag_tpu_torch.utils import memory as mem
from cuvs_rag_tpu_torch.utils.config import CagraParams

torch.set_num_threads(1)


def test_budget_fits():
    b = mem.DeviceBudget(limit_bytes=16 << 30, reserve_bytes=2 << 30)
    assert b.usable_bytes == 14 << 30
    assert b.fits(10 << 30)
    assert not b.fits(15 << 30)
    assert not b.fits(10 << 30, in_use=5 << 30)


def test_index_bytes_estimate_orders():
    n, d = 1_000_000, 768
    flat32 = mem.index_bytes_estimate(n, d, "flat", "float32")
    flat16 = mem.index_bytes_estimate(n, d, "flat", "bfloat16")
    pq = mem.index_bytes_estimate(n, d, "ivf_pq", pq_dim=96,
                                  store_raw=False)
    assert flat32 > flat16 > pq
    assert flat32 == n * d * 4 + n * 4
    assert pq < flat32 / 10
    pq_raw = mem.index_bytes_estimate(n, d, "ivf_pq", "bfloat16", pq_dim=96)
    assert pq_raw > flat16
    assert mem.index_bytes_estimate(n, d, "ivf_flat", "int8") == n * d + n * 8
    # CAGRA's rows are 768 + 2 columns rounded up to 128: 896 wide
    assert mem.index_bytes_estimate(n, d, "cagra", "bfloat16") == \
        n * 896 * 2 + n * 64 * 4 + n * 4


@pytest.mark.parametrize("family,dtype", [
    ("flat", "float32"), ("flat", "bfloat16"), ("flat", "int8"),
    ("ivf_flat", "bfloat16"), ("ivf_flat", "int8"), ("ivf_pq", "bfloat16"),
    ("ivf_pq", "float32"), ("cagra", "bfloat16"), ("cagra", "float32"),
])
def test_planning_equals_the_jax_package(family, dtype):
    """index_bytes_estimate, max_rows_per_device and plan_shards give the
    JAX package's numbers over (n, d, pq_dim, devices) at given budgets."""
    for n, d, pq_dim, devices, limit in itertools.product(
            (1000, 2_000_000, 100_000_000), (32, 384, 768), (0, 48, 96),
            (1, 4, 8), (16 << 30, 80 << 30)):
        assert mem.index_bytes_estimate(n, d, family, dtype, pq_dim) == \
            jmem.index_bytes_estimate(n, d, family, dtype, pq_dim)
        tb, jb = mem.DeviceBudget(limit), jmem.DeviceBudget(limit)
        assert mem.max_rows_per_device(d, tb, family, dtype, pq_dim) == \
            jmem.max_rows_per_device(d, jb, family, dtype, pq_dim)
        assert mem.plan_shards(n, d, devices, tb, family, dtype, pq_dim) \
            == jmem.plan_shards(n, d, devices, jb, family, dtype, pq_dim)
    for pq_bits, store_raw in ((4, True), (4, False), (8, False)):
        assert mem.index_bytes_estimate(
            5000, 384, "ivf_pq", dtype, 48, store_raw=store_raw,
            pq_bits=pq_bits) == jmem.index_bytes_estimate(
            5000, 384, "ivf_pq", dtype, 48, store_raw=store_raw,
            pq_bits=pq_bits)


@pytest.mark.parametrize("dim", [30, 126, 200])
def test_cagra_estimate_is_a_built_index(dim):
    """The CAGRA estimate is the bytes of a port-built CagraIndex: the
    augmented rows (dim + 2 rounded up to 128), the graph and the sqnorms,
    at a row count the build does not pad."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((512, dim)).astype(np.float32)
    ix = cagra.build(CagraParams(graph_degree=16, intermediate_graph_degree=32,
                                 dtype="bfloat16", build_algo="exact"),
                     x, device="cpu")
    built = sum(getattr(ix, f).numel() * getattr(ix, f).element_size()
                for f in type(ix)._tensor_fields)
    assert mem.index_bytes_estimate(512, dim, "cagra", "bfloat16",
                                    graph_degree=16) == built


def test_plan_shards_fit_and_overflow():
    b = mem.DeviceBudget(limit_bytes=16 << 30)
    plan = mem.plan_shards(10_000_000, 768, 8, budget=b, family="flat",
                           dtype="bfloat16")
    assert plan["fits"]
    plan2 = mem.plan_shards(100_000_000, 768, 2, budget=b, family="flat",
                            dtype="float32")
    assert not plan2["fits"]
    assert "devices" in plan2["suggestion"]


def test_detect_budget_on_the_cpu_is_the_stated_limit():
    assert mem.detect_budget("cpu").limit_bytes == 16 << 30
    assert mem.detect_budget("cpu", cpu_limit=1 << 30).usable_bytes == 0


def test_managed_allocation_passthrough():
    with mem.managed_allocation("noop"):
        x = 1 + 1
    assert x == 2
    with pytest.raises(ValueError):
        with mem.managed_allocation("op"):
            raise ValueError("unrelated")


def test_managed_allocation_oom_translation():
    with pytest.raises(MemoryError, match="device OOM during build") as e:
        with mem.managed_allocation("build"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert isinstance(e.value.__cause__, torch.cuda.OutOfMemoryError)


def test_memory_stats_shape():
    stats = mem.memory_stats()
    assert len(stats) == torch.cuda.device_count()
    assert all({"bytes_in_use", "bytes_reserved", "bytes_free",
                "bytes_limit", "peak_bytes_in_use"} <= set(v)
               for v in stats.values())
    mem.log_memory_status("test")
