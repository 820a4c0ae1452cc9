"""The port's measurement entry points (cuvs_rag_tpu_torch/bench.py and
scripts/) on the card at small sizes: what tests/test_torch_bench_entry.py
and tests/test_torch_scripts.py hold on the CPU, with the kernels running.
CUDA kernels have no CPU mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest -q tests/test_torch_cuda_scripts.py
"""

import contextlib
import importlib
import io
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-3)  # the refined distances' own rule
# above flat's 262,144-row dense threshold, so K1-K3 run
ROWS = 400_000


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _holder(held):
    from cuvs_rag_tpu_torch.utils.compare import hold_exact_search

    def hold(name, corpus, queries, dist, ids):
        held[name] = hold_exact_search(corpus, queries, dist, ids)

    return hold


def test_bench_on_the_card(cuda_device):
    from cuvs_rag_tpu_torch import bench

    held = {}
    args = bench.parse_args(["--n", str(ROWS), "--n-lists", "400",
                             "--text-rows", "20000"])
    payload = bench.run(args, hold=_holder(held))
    assert payload["metric"] == \
        f"exact_search_ms_per_query_{ROWS}x768_k5_batch100"
    src = open(os.path.join(REPO, "bench.py")).read()
    rows = set(re.findall(r'rows\["([a-z0-9_]+)"\]', src))
    assert rows <= set(payload["extra"])
    assert payload["extra"]["device"].startswith(
        torch.cuda.get_device_name(0))
    assert sorted(held) == ["clustered_oracle", "exact_k2000", "headline",
                            "ivf_k2000_exact"]
    json.dumps(payload)


def test_streamed_ground_truth_equals_one_flat_search(cuda_device):
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.scripts import common
    from cuvs_rag_tpu_torch.utils.compare import hold_exact_search
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    geo = common.clustered(1, 400, 768, 1.0, cuda_device)
    rows = ROWS // 4
    q = common.make_queries(1, 0, 100, geo, cuda_device)
    d, i = common.streamed_ground_truth(
        lambda c: common.make_chunk(1, c, rows, geo, cuda_device), 4, rows,
        q, 10)
    whole = common.make_corpus(1, ROWS, geo, cuda_device, n_chunks=4)
    fd, fi = flat.search(None, flat.build(FlatParams(), whole), q, 10)
    assert hold_exact_search(whole, q, d, i) <= 1.0
    assert hold_exact_search(whole, q, fd, fi) <= 1.0


SMALL = {
    "bench_10m": ["--n", "2000000", "--chunks", "16", "--n-lists", "1024"],
    "bench_pq_capacity": ["--n", "1000000", "--n-lists", "1024", "--opq",
                          "--refine-external", "16", "--probes", "20"],
    "bench_batch1": ["--n", str(ROWS), "--n-lists", "400"],
    "bench_topk_large": ["2000", "--n", str(ROWS)],
    "bench_int8_flat": ["--n", str(ROWS)],
    "bench_ivf_int8": ["--n", str(ROWS), "--n-lists", "400"],
    "bench_ivf_pq": ["--n", str(ROWS), "--n-lists", "400"],
    "bench_filters": ["--n", str(ROWS), "--n-lists", "400"],
    "bench_tune": ["--n", str(ROWS), "--n-lists", "400"],
    "bench_family_curves": ["hard", str(ROWS)],
}


# the scripts with an exact search among their A/Bs, held through `hold`
HELD = {"bench_batch1", "bench_topk_large", "bench_int8_flat", "bench_filters"}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_script_on_the_card(cuda_device, name, tmp_path):
    mod = importlib.import_module(f"cuvs_rag_tpu_torch.scripts.{name}")
    argv = SMALL[name]
    if name == "bench_pq_capacity":
        argv = argv + ["--memmap-store", str(tmp_path / "rows.bin")]
    held = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.run(mod.parse_args(argv), hold=_holder(held))
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith(torch.cuda.get_device_name(0))
    assert len(held) == (name in HELD)
    if name == "bench_10m":
        assert out["k4_route"] == "ring"
        assert out["probes"][10]["recall_at_10"] >= 0.95
    if name == "bench_pq_capacity":
        refined = out["points"][1]
        assert "memmap store" in out["refine_source"]
        assert refined["distance_error"] <= TOL["atol"] + TOL["rtol"] * \
            refined["distance_scale"]
        assert np.isfinite(out["peak_memory_gb"])
