"""The port's headline benchmark (cuvs_rag_tpu_torch/bench.py) against the
JAX package's bench.py, on the CPU at 2,048 x 32: one JSON line in
bench.py's shape, the metric named by bench.py's own format at the same
N, D, K and BATCH, bench.py's constants and exactly its row keys (read
from its source), every exact row equal to the fp64 exact top-k of the
same rows (utils/compare.hold_exact_search: each distance within the
search's fp32 rounding of its row's, ids up to ties within it), and a failed
row ending the run with exit code 1 and the completed rows on stderr."""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch import bench
from cuvs_rag_tpu_torch.utils.compare import hold_exact_search

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the JAX package's bench.py: no jax at import)

SMALL = ["--device", "cpu", "--n", "2048", "--dim", "32", "--n-lists", "8",
         "--text-rows", "1024", "--text-dim", "24"]


@pytest.fixture(scope="module")
def run_small():
    """bench.main at the small size, every exact row held as it runs:
    (exit code, stdout, held row names)."""
    import contextlib
    import io

    held = []

    def hold(name, corpus, queries, dist, ids):
        assert hold_exact_search(corpus, queries, dist, ids) <= 1.0
        held.append(name)

    orig = bench.run
    out = io.StringIO()
    bench.run = lambda args, rows=None: orig(args, hold=hold, rows=rows)
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(SMALL)
    finally:
        bench.run = orig
    return rc, out.getvalue(), held


def bench_py_row_keys():
    src = open(os.path.join(REPO, "bench.py")).read()
    return set(re.findall(r'rows\["([a-z0-9_]+)"\]', src))


def test_one_line_in_bench_py_shape(run_small, capsys):
    rc, out, _ = run_small
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert set(payload) == {"metric", "value", "unit", "vs_baseline",
                            "extra"}
    # bench.py's own metric format at the same N, D, K and BATCH
    assert payload["metric"] == (
        f"exact_search_ms_per_query_{2048}x{32}_k{jbench.K}"
        f"_batch{jbench.BATCH}")
    assert payload["unit"] == "ms/query" and payload["value"] > 0
    assert payload["vs_baseline"] == pytest.approx(
        jbench.BASELINE_MS / payload["value"], rel=1e-2)
    # bench.py's base extras (its _emit with no rows) and its row keys
    jbench._emit(1.0, 1.0, 1.0, 1.0, {}, [], "cpu")
    base = set(json.loads(capsys.readouterr().out)["extra"])
    assert set(payload["extra"]) == base | bench_py_row_keys()
    assert payload["extra"]["device"] == "cpu"


def test_constants_are_bench_pys():
    for name in ("N", "D", "K", "K_LARGE", "BATCH", "BASELINE_MS"):
        assert getattr(bench, name) == getattr(jbench, name), name
    assert bench.metric_name(bench.N, bench.D) == (
        f"exact_search_ms_per_query_{jbench.N}x{jbench.D}_k{jbench.K}"
        f"_batch{jbench.BATCH}")


def test_exact_rows_equal_their_oracle(run_small):
    assert run_small[2] == ["headline", "exact_k2000", "clustered_oracle",
                            "ivf_k2000_exact"]


def test_a_failed_row_ends_the_run(monkeypatch, capsys):
    def broken(*args):
        raise ValueError("no clustered rows")

    monkeypatch.setattr(bench, "_clustered_rows", broken)
    assert bench.main(SMALL) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "row clustered_rows failed" in captured.err
    done = json.loads(captured.err.split("rows completed: ")[1].splitlines()[0])
    assert set(done) == {"exact_k2000_ms_per_query", "exact_k2000_note",
                         "sketch_int8_ms_per_query", "sketch_int8_vs_baseline",
                         "sketch_int8_note"}
    assert np.isfinite(done["exact_k2000_ms_per_query"])


def test_hold_exact_search_catches_what_is_not_exact():
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((3000, 32), generator=gen).to(torch.bfloat16)
    q = torch.randn((5, 32), generator=gen)
    d, i = flat.search(None, flat.build(FlatParams(), corpus), q, 10)
    assert hold_exact_search(corpus, q, d, i) <= 1.0
    far = ((q[:, None] - corpus.float()[None]) ** 2).sum(2).argmax(1)
    for bad in (torch.cat([i[:, :-1], far[:, None].int()], 1),  # a far row
                torch.cat([i[:, :-1], i[:, :1]], 1)):  # a row twice
        with pytest.raises(AssertionError):
            hold_exact_search(corpus, q, d, bad)
    with pytest.raises(AssertionError):  # a distance off by 1e-3
        hold_exact_search(corpus, q, d + 1e-3, i)
