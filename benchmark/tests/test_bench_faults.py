"""`correct` comes out false for each fault the cells can have, planted
under the timed path of a small CPU run, and for each configuration's
control (the step below its stated precision); a sound run is correct."""

import pytest
import torch

from conftest import run_small


def altered(search):
    """An answer altered where it is produced: one id of each batch
    replaced by the next row's."""
    def run(q):
        d, i = search(q)
        i = i.clone()
        i[0, 0] = i[0, 0] + 1
        return d, i
    return run


def half_left_out(search):
    """Half of the batch left out: the first half searched, its answers
    handed to the rest."""
    def run(q):
        h = max(1, q.shape[0] // 2)
        d, i = search(q[:h])
        reps = -(-q.shape[0] // h)
        return d.repeat(reps, 1)[:q.shape[0]], i.repeat(reps, 1)[:q.shape[0]]
    return run


def exchange_left_out(search):
    """The gather from the other replicas left out: only the first
    replica's part of the batch is written back."""
    def run(q):
        d, i = search(q)
        part = -(-q.shape[0] // 4)
        d, i = d.clone(), i.clone()
        d[part:] = float("inf")
        i[part:] = -1
        return d, i
    return run


BATCH_CELLS = ["flat6m.batch100", "ivf10m.batch100",
               "flat6m.x4rep.batch100"]


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_altered_answer_is_not_correct(cell):
    assert run_small(cell, fault=altered)["correct"] is False


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_half_batch_left_out_is_not_correct(cell):
    assert run_small(cell, fault=half_left_out)["correct"] is False


def test_exchange_left_out_is_not_correct():
    line = run_small("flat6m.x4rep.batch100", fault=exchange_left_out)
    assert line["correct"] is False
    assert line["checks"]["invalid"]["value"] > 0
    import json
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_control_is_not_correct(cell):
    assert run_small(cell, control=True)["correct"] is False


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_sound_run_is_correct(cell):
    assert run_small(cell, seed=11)["correct"] is True


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the flat cell through run.py on a card."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flat6m.batch100", "--seed", "3", "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
