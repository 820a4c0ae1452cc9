"""The benchmark's frozen copies draw the same rows as the port's
originals (`scripts/common.py`), and its roofline peaks and formula are
those of the port's smoke test."""

import torch

from benchmark.harness import gen, roofline


def test_generators_draw_the_originals_rows():
    from cuvs_rag_tpu_torch.scripts import common

    dev = torch.device("cpu")
    assert gen.fold(42, 1, 7) == common.fold(42, 1, 7)
    for a, b in (
            (gen.clustered(42, 16, 24, 0.3, dev),
             common.clustered(42, 16, 24, 0.3, dev)),
            (gen.low_rank(42, 16, 24, 8, 1.0, dev),
             common.low_rank(42, 16, 24, 8, 1.0, dev)),
            (gen.low_rank(7, 0, 24, 8, 1.0, dev),
             common.low_rank(7, 0, 24, 8, 1.0, dev)),
            (gen.Gaussian(24), common.Gaussian(24))):
        assert torch.equal(gen.make_chunk(42, 3, 100, a, dev),
                           common.make_chunk(42, 3, 100, b, dev))
        assert torch.equal(gen.make_corpus(42, 400, a, dev, 4),
                           common.make_corpus(42, 400, b, dev, 4))
        qa = gen.make_queries(42, 2, 10, a, dev)
        assert torch.equal(qa, common.make_queries(42, 2, 10, b, dev))
        for x, y in zip(gen.perturbed(qa, 9, 3), common.perturbed(qa, 9, 3)):
            assert torch.equal(x, y)


def test_unit_rows_are_the_smoke_tests():
    """unit_clustered draws normalize(c + spread z), c unit: rows of norm 1
    near their centre."""
    g = gen.unit_clustered(1, 8, 384, 0.05, torch.device("cpu"))
    x = g.sample(gen.generator("cpu", 1, gen.CHUNK, 0), 200)
    assert torch.allclose(x.norm(dim=1), torch.ones(200), atol=1e-5)
    assert torch.allclose(g.centres.norm(dim=1), torch.ones(8), atol=1e-5)
    best = (x @ g.centres.T).max(dim=1).values
    assert (best > 0.6).all()


def test_roofline_peaks_are_the_smokes():
    """The peaks are the data sheet's, as the port's chip_smoke.py has
    them."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parents[2] / "chip_smoke.py").read_text()
    found = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name in ("H100_BYTES_PER_S", "H100_OPS_PER_S"):
                found[name] = ast.literal_eval(node.value)
    assert found["H100_BYTES_PER_S"] == roofline.HBM_BYTES_PER_S
    assert found["H100_OPS_PER_S"] == roofline.PEAK_OPS_PER_S
