"""The kernel wrappers' one way to the card, `kernels/build.launcher`, on
the CPU: a stub stands in for the loaded library, so what the seam does
around the foreign call (the device guard, the span `kernel.launch`, the
stream passed last, the error check, the count in `build.launches`) is
held without a GPU. And the wrappers of `ops/*_kernels.py`, read as
source: every launch goes through the seam under its label, and no ops
module reads another module's underscore names.
"""

import ast
import contextlib
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.utils import profiling

torch.set_num_threads(1)

# Each launch entry point and the label of its `kernel.launch` span: K1's
# and K4's are what the benchmark's pinning matches; the rest are their
# PERF.md names (gather_rows serves M2 and M4).
LABELS = {
    "flat_exact_topk": "K1",
    "flat_exact_wide_topk": "K1",
    "flat_sketch_topk": "K2",
    "flat_topr": "K3",
    "ivf_scan_topk": "K4",
    "ivf_scan_topr": "K5",
    "pq_adc_scores": "K6",
    "flash_attention": "K7",
    "read_all": "M1",
    "gather_rows": "M2",
    "gather_reduce": "M3",
    "cagra_candidates": "cagra_candidates",
    "cagra_merge": "cagra_merge",
}
# the one entry point that is no launch: graph_kernels' occupancy query
QUERIES = {"cagra_candidates_blocks"}
OPS = Path(build.__file__).resolve().parent.parent / "ops"
WRAPPERS = sorted(OPS.glob("*_kernels.py"))
STREAM = 0xBEEF


def _source_of(entry):
    return next(s for s, entries in build.SIGNATURES.items()
                if entry in entries)


class _Stub:
    """A library of one entry point that records its calls: the
    arguments, the clock, and whether the device guard was open."""

    def __init__(self, entry, err=0):
        self.calls, self.err, self.guarded = [], err, False
        setattr(self, entry, self._call)

    def _call(self, *args):
        self.calls.append((args, time.perf_counter_ns(), self.guarded))
        return self.err

    @contextlib.contextmanager
    def guard(self, device):
        self.guarded = True
        try:
            yield
        finally:
            self.guarded = False


@pytest.mark.parametrize("entry,label", sorted(LABELS.items()))
def test_launcher_spans_passes_the_stream_checks_and_counts(entry, label):
    source = _source_of(entry)
    dev = torch.device("cuda", 3)
    stub = _Stub(entry)
    before = build.launches[entry]
    was = profiling.record_spans(True)
    profiling.clear()
    try:
        with mock.patch.object(build, "load", lambda s: stub), \
                mock.patch.object(build, "raw_stream", lambda d: STREAM), \
                mock.patch.object(build, "device_guard", stub.guard):
            launch = build.launcher(source, entry, dev, kernel=label)
            launch(1, 2.5, None)
            spans = profiling.spans()
            assert build.launches[entry] == before + 1
            stub.err = 7
            with pytest.raises(RuntimeError, match=f"^{entry}: CUDA error 7"):
                launch(4)
    finally:
        profiling.record_spans(was)
        profiling.clear()
    (args, t, guarded), (args_bad, _, _) = stub.calls
    assert args == (1, 2.5, None, STREAM) and args_bad == (4, STREAM)
    assert guarded  # the device was made current around the call
    (span,) = spans
    assert span["name"] == "kernel.launch"
    assert span["attrs"] == {"kernel": label, "device": 3}
    assert span["start_ns"] <= t <= span["end_ns"]
    # a refused launch raises and is not counted
    assert build.launches[entry] == before + 1


def test_card_checks_on_the_cpu():
    x = torch.arange(40, dtype=torch.int8)
    assert build.aligned(x) is x
    view = x[1:]
    assert view.data_ptr() % 16 and build.aligned(view).data_ptr() % 16 == 0
    assert torch.equal(build.aligned(view), view)
    with pytest.raises(ValueError, match="no kernel for tensors on cpu"):
        build.require_cuda(x)
    assert build.MAX_SMEM < build.SM_SMEM
    assert set(build.launches) == {e for entries in build.SIGNATURES.values()
                                   for e in entries}


def _port_aliases(tree):
    """Names a module binds to the port's modules and objects, and the
    underscore names it imports from them."""
    aliases, private = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "cuvs_rag_tpu_torch"):
            for a in node.names:
                aliases.add(a.asname or a.name)
                if a.name.startswith("_"):
                    private.append(f"{node.module}.{a.name}")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("cuvs_rag_tpu_torch"):
                    aliases.add(a.asname or a.name.split(".")[0])
    return aliases, private


def _is_build_call(node, name):
    f = node.func if isinstance(node, ast.Call) else None
    return (isinstance(f, ast.Attribute) and f.attr == name
            and isinstance(f.value, ast.Name) and f.value.id == "build")


def _launchers(path):
    """[(source, entry, label)] of each `build.launcher` call in a module,
    its source resolved through the module's constants."""
    tree = ast.parse(path.read_text())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
              for t in n.targets if isinstance(t, ast.Name)}
    out = []
    for node in ast.walk(tree):
        if _is_build_call(node, "launcher"):
            src, entry = node.args[0], node.args[1]
            source = consts[src.id] if isinstance(src, ast.Name) else src.value
            (kw,) = [k for k in node.keywords if k.arg == "kernel"]
            out.append((source, entry.value, kw.value.value))
    return out


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_wrapper_launches_only_through_the_seam(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        # no launch entry called on the loaded library, no check of its
        # own: both are the seam's
        if isinstance(node, ast.Attribute) and _is_build_call(
                node.value, "load"):
            assert node.attr in QUERIES, f"{path.name}:{node.lineno}"
        elif _is_build_call(node, "load"):
            parent_ok = any(isinstance(p, ast.Attribute) and p.value is node
                            for p in ast.walk(tree))
            assert parent_ok, f"{path.name}:{node.lineno}: build.load kept"
        assert not _is_build_call(node, "check"), f"{path.name}:{node.lineno}"
        # no launch counter beside build.launches
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            assert not any(isinstance(t, ast.Attribute)
                           and t.attr.endswith("launches") for t in targets)
    aliases, private = _port_aliases(tree)
    assert not private, private
    reads = [f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
             if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
             and n.value.id in aliases and n.attr.startswith("_")
             and not n.attr.startswith("__")]
    assert not reads, f"{path.name} reads another module's names: {reads}"
    for source, entry, label in _launchers(path):
        assert entry in build.SIGNATURES[source]
        assert LABELS[entry] == label, (entry, label)


def test_every_launch_entry_has_its_launcher():
    made = [entry for p in WRAPPERS for _, entry, _ in _launchers(p)]
    assert sorted(made) == sorted(LABELS)
    assert set(LABELS) | QUERIES == set(build.launches)
