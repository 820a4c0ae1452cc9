"""eval/plots.py of the port: a byte copy of the JAX package's (held here)
drawing the port's StressRow and SweepPoint records (the JAX package's
tests/test_plots.py, 2 tests)."""

import os

import pytest

from cuvs_rag_tpu_torch.eval import plots
from cuvs_rag_tpu_torch.eval.bench import StressRow
from cuvs_rag_tpu_torch.eval.sweeps import SweepPoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_plots_is_a_byte_copy():
    with open(os.path.join(REPO, "cuvs_rag_tpu", "eval", "plots.py"),
              "rb") as a, open(plots.__file__, "rb") as b:
        assert a.read() == b.read()


def test_scaling_report(tmp_path):
    pytest.importorskip("matplotlib")
    rows = [
        StressRow(1000, 0.5, 2.0, 0.99, True),
        StressRow(2000, 0.9, 3.5, 0.98, True),
        StressRow(4000, 0.0, 0.0, None, False, error="MemoryError: boom"),
    ]
    p = plots.scaling_report(rows, str(tmp_path / "r.png"))
    assert os.path.exists(p) and os.path.getsize(p) > 10_000


def test_operating_curve_plot(tmp_path):
    pytest.importorskip("matplotlib")
    pts = [SweepPoint(1, 0.7, 1.0, 1000), SweepPoint(4, 0.96, 2.0, 500),
           SweepPoint(16, 1.0, 8.0, 125)]
    p = plots.operating_curve_plot(pts, str(tmp_path / "c.png"))
    assert os.path.exists(p) and os.path.getsize(p) > 10_000
