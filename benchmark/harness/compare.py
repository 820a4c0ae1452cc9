"""The numbers that decide `correct`: a top-k answer against the plain
reference's exact top-k of the same rows and queries.

For each checked query the program's k ids and k distances, the
reference's k exact distances and ids, and the reference's distance of each
id the program returned:

  invalid       answers with an id outside the corpus, an id twice, or a
                missing id (limit 0: the structure of an answer is exact);
  recall_at_10  mean |program ids & reference ids| / k;
  excess        the worst, over queries and ranks j, of (the j-th best
                true distance among the program's ids - the reference's
                j-th distance) / the reference's k-th distance: 0 where the
                program returned the exact k rows, rounding where it swapped
                rows tied within it, large where it returned a wrong row;
  dist_gap      the worst |distance the program reported - the true
                distance of the id it reported| / the reference's k-th
                distance.

A configuration names the numbers it is held to and each one's limit
({"max": x} or {"min": y}) under "checks"; `judge` says which pass.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TINY = 1e-30


def numbers(prog_d: np.ndarray, prog_i: np.ndarray, ref_d: np.ndarray,
            ref_i: np.ndarray, pair_d: np.ndarray, n_rows: int) -> dict:
    """The numbers above over (Q, k) arrays; pair_d is the reference's
    distance of each of the program's ids (inf outside the corpus)."""
    prog_i = np.asarray(prog_i, np.int64)
    prog_d = np.asarray(prog_d, np.float64)
    q, k = ref_i.shape
    srt = np.sort(prog_i, axis=1)
    bad = ((prog_i < 0) | (prog_i >= n_rows)).any(axis=1) \
        | (srt[:, 1:] == srt[:, :-1]).any(axis=1) \
        | (prog_i.shape[1] < k)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(prog_i[:, :k], ref_i))
    scale = np.maximum(ref_d[:, -1], TINY)
    true_sorted = np.sort(pair_d[:, :k], axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf in invalid answers
        excess = np.max((true_sorted - ref_d) / scale[:, None], axis=1)
        gap = np.max(np.abs(prog_d[:, :k] - pair_d[:, :k]) / scale[:, None],
                     axis=1)
    excess = np.where(bad, np.inf, excess)
    gap = np.where(bad, np.inf, gap)
    return {"invalid": int(bad.sum()),
            "recall_at_10": hits / float(q * k),
            "excess": float(np.max(excess, initial=0.0)),
            "dist_gap": float(np.max(gap, initial=0.0))}


def judge(values: Dict[str, float], checks: Dict[str, dict]) -> dict:
    """{name: {"value", "limit", "ok"}} for each check the configuration
    names; a number that is missing or NaN fails."""
    out = {}
    for name, lim in checks.items():
        v = values.get(name)
        if "max" in lim:
            ok = v is not None and not np.isnan(v) and v <= lim["max"]
            out[name] = {"value": v, "limit": lim["max"], "ok": bool(ok),
                         "side": "max"}
        else:
            ok = v is not None and not np.isnan(v) and v >= lim["min"]
            out[name] = {"value": v, "limit": lim["min"], "ok": bool(ok),
                         "side": "min"}
    return out
