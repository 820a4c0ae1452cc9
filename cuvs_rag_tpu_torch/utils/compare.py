"""The rule a top-k result is held to against a reference top-k: by the CPU
parity tests (port vs JAX package) and by chip_smoke.py (kernel vs its plain
version on the card); and the rule certified large-k planes (K3, K5) are
held to against their plain version's."""

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


def compare_planes(kp, pp, bound_fn) -> tuple:
    """Certified large-k planes `kp` = (scores (Q, R, W), ids (Q, R, W), rej
    (Q, W)) against a reference's `pp`, equal up to ties within the
    rounding bound, where `bound_fn(rows)` gives (want, allowed) fp64
    tensors for (Q, n) ids: the fp64 score of each row and what the
    kernel's roundings may add to it. Holds that both have the same empty
    (-inf) slots; that each of `kp`'s scores is within `allowed` of the fp64
    score of its own row; that no row is held twice in a class; and that
    plane by plane, and for rej, `kp`'s value is within `slack` of `pp`'s,
    slack being twice the largest allowed error among the class's plane
    rows on either side (an order statistic of values each off by at most
    a moves by at most a, on each side). Returns (largest |kp - pp| /
    slack, slack (Q, W)); raises AssertionError where a hold fails."""
    import torch

    ks, ki, kr = kp
    ps, pi, pr = pp
    q, r, w = ks.shape
    if not torch.equal(torch.isinf(ks), torch.isinf(ps)) \
            or not torch.equal(torch.isinf(kr), torch.isinf(pr)):
        raise AssertionError("the planes disagree on which slots are empty")
    want_k, allowed_k = (t.view(q, r, w) for t in bound_fn(ki.reshape(q, -1)))
    allowed_p = bound_fn(pi.reshape(q, -1))[1].view(q, r, w)
    live = ki >= 0
    off = ((ks.double() - want_k).abs() / allowed_k)[live]
    if off.numel() and not float(off.max()) <= 1.0:
        raise AssertionError(f"a plane score is off by {float(off.max())} "
                             "times what its roundings allow")
    srt = ki.sort(dim=1).values
    if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any():
        raise AssertionError("the planes hold a row twice in a class")
    slack = 2.0 * torch.maximum(
        torch.where(live, allowed_k, 0.0).amax(dim=1),
        torch.where(pi >= 0, allowed_p, 0.0).amax(dim=1))
    tiny = torch.finfo(torch.float64).tiny
    ratio = torch.cat([
        ((ks.double() - ps.double()).abs()
         / slack[:, None, :].clamp(min=tiny))[torch.isfinite(ps)],
        ((kr.double() - pr.double()).abs()
         / slack.clamp(min=tiny))[torch.isfinite(pr)]])
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not worst <= 1.0:
        raise AssertionError(f"planes off by {worst} times the slack")
    return worst, slack


def hold_exact_search(corpus, queries, distances, ids,
                      chunk: int = 262_144) -> float:
    """Hold a flat search's (Q, k) squared-L2 (distances, ids) over `corpus`
    (its stored rows, any float dtype) to the exact answer in fp64. Each
    returned distance must lie within what a flat search's fp32 arithmetic
    may lose against the fp64 distance of its own row; no row may come
    twice; and no returned row may lie farther than the exact k-th by more
    than that, so the set is the exact top-k up to ties within rounding.
    The allowed error of a (query, row) pair is

        2^-22 * D * (sum_i |q'_i x_i| + |q|^2 + |x|^2) + 2^-23 * |d|

    q' being the query in the storage dtype, as flat search scores it: the
    D fp32 adds of the product (each losing at most a unit in the last
    place of a partial sum bounded by sum_i |q'_i x_i|, doubled as the
    product is), those of the two norms, and the final subtractions.
    Returns the largest error / allowed; raises AssertionError."""
    import torch

    dist = torch.as_tensor(distances).to(corpus.device, torch.float64)
    ids = torch.as_tensor(ids).to(corpus.device, torch.int64)
    q = queries.to(corpus.device).double()
    qr = queries.to(corpus.device, corpus.dtype).double()
    qsq = (q * q).sum(1, keepdim=True)
    n, d = corpus.shape
    k = ids.shape[1]
    kth = torch.full((q.shape[0], min(k, n)), float("inf"),
                     dtype=torch.float64, device=q.device)
    for s in range(0, n, chunk):  # the exact k nearest distances, in fp64
        x = corpus[s:s + chunk].double()
        dd = qsq + (x * x).sum(1)[None, :] - 2 * qr @ x.T
        kth = torch.topk(torch.cat([kth, dd], 1), kth.shape[1], dim=1,
                         largest=False).values
    kth = kth[:, -1:]
    if bool((ids[:, :min(k, n)] < 0).any()):
        raise AssertionError("fewer results than the corpus holds rows")
    live = ids >= 0
    srt = torch.where(live, ids, -1 - torch.arange(
        k, device=ids.device)[None, :].expand_as(ids)).sort(1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError("a row returned twice")
    x = corpus[ids.clamp(min=0)].double()
    d64 = qsq + (x * x).sum(2) - 2 * torch.einsum("qd,qkd->qk", qr, x)
    mag = torch.einsum("qd,qkd->qk", qr.abs(), x.abs())
    allowed = 2.0 ** -22 * d * (mag + qsq + (x * x).sum(2)) \
        + 2.0 ** -23 * d64.abs()
    ratio = ((dist - d64).abs() / allowed)[live]
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not worst <= 1.0:
        raise AssertionError(f"a distance is off by {worst} times what the "
                             "search's roundings allow")
    far = (d64 > kth + allowed) & live
    if bool(far.any()):
        raise AssertionError(
            f"{int(far.sum())} returned rows lie beyond the exact k-th "
            "by more than rounding")
    return worst
