"""Nothing under benchmark/ imports JAX, Flax or the JAX package
`cuvs_rag_tpu` (top-level names compared whole: the port's own name,
`cuvs_rag_tpu_torch`, begins with the JAX package's), and the plain
reference imports nothing of the program or of the rest of the harness."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cuvs_rag_tpu"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_compared():
    src = "import cuvs_rag_tpu_torch.index\nfrom cuvs_rag_tpu.index import x\n"
    tree = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tree.body}
    assert names & FORBIDDEN == {"cuvs_rag_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "typing", "torch",
                                       "numpy", "math"}


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import importlib.util
    import sys
    import types

    spec = importlib.util.spec_from_file_location("bench_run_probe",
                                                  BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_loaded() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "cuvs_rag_tpu.index",
                        types.ModuleType("cuvs_rag_tpu.index"))
    assert "cuvs_rag_tpu" in run.forbidden_loaded()
