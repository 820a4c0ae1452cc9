"""The rule a top-k result is held to against a reference top-k: by the CPU
parity tests (port vs JAX package) and by chip_smoke.py (kernel vs its plain
version on the card)."""

from __future__ import annotations

import numpy as np


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def compare_topk(ks, ki, ps, pi, *, rtol: float, atol: float) -> float:
    """Top-k (ks, ki) against a reference top-k (ps, pi), (Q, k) each, as
    tensors or arrays. Scores must be allclose slot by slot (both sorted
    descending, -inf where a slot is invalid, with id -1 there); ids must
    agree as sets, except for swaps among scores tied (within the
    tolerance) with the reference's k-th. Returns the max abs score error."""
    ks, ki, ps, pi = (_np(t) for t in (ks, ki, ps, pi))
    fin = np.isfinite(ps)
    if not np.array_equal(fin, np.isfinite(ks)):
        raise AssertionError("the two disagree on which slots are valid")
    np.testing.assert_allclose(ks[fin], ps[fin], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ki[~fin], pi[~fin])
    for row in range(ks.shape[0]):
        live = fin[row]
        if not live.any():
            continue
        kth = ps[row, live][-1]
        tol = atol + rtol * abs(kth)
        a = dict(zip(ki[row, live].tolist(), ks[row, live].tolist()))
        b = dict(zip(pi[row, live].tolist(), ps[row, live].tolist()))
        for ids, scores in ((set(a) - set(b), a), (set(b) - set(a), b)):
            for i in ids:
                if abs(scores[i] - kth) > tol:
                    raise AssertionError(
                        f"row {row}: id {i} (score {scores[i]}) differs and "
                        f"is not tied with the k-th score {kth}")
    return float(np.max(np.abs(ks[fin] - ps[fin]), initial=0.0))
