"""The plain reference: exact k nearest rows by squared L2 distance.

Plain PyTorch, in float64, over a corpus handed over chunk by chunk
(`chunk_fn(i)` -> (chunk_rows, D) rows of any float dtype, on the device
the work runs on). It imports nothing of the program and takes nothing the
program made: the rows and queries are the benchmark's own.

`precision` other than "float64" puts the rows through a lower precision
first ("int8", "int4": symmetric per-row scales): that is the
control, which a sound comparison has to tell apart from the program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

def lower(rows: torch.Tensor, precision: str) -> torch.Tensor:
    """`rows` (fp) as float64 after a round trip through `precision`."""
    x = rows.double()
    if precision == "float64":
        return x
    if precision in ("int8", "int4"):
        top = 127.0 if precision == "int8" else 7.0
        scale = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / top
        return torch.round(x / scale).clamp(-top, top) * scale
    raise ValueError(f"unknown precision {precision!r}")


def sqdist(q: torch.Tensor, x: torch.Tensor, xn=None) -> torch.Tensor:
    """(Q, N) float64 squared L2 distances of float64 q (Q, D), x (N, D);
    `xn` the rows' squared norms where already known."""
    if xn is None:
        xn = (x * x).sum(1)
    return ((q * q).sum(1)[:, None] - 2.0 * (q @ x.T)
            + xn[None, :]).clamp_min(0.0)


def exact_topk(chunk_fn: Callable[[int], torch.Tensor], n_chunks: int,
               chunk_rows: int, queries: torch.Tensor, k: int, *,
               precision: str = "float64", pairs: Optional[torch.Tensor] = None,
               block_elems: int = 1 << 27):
    """((Q, k) float64 distances ascending, (Q, k) int64 ids) of the k
    rows nearest each query over the whole corpus, ties broken by the
    lower id, and, where `pairs` (Q, m) ids are given, (Q, m) float64
    distances of each query to those rows (ids outside the corpus read
    inf; rows at full precision). Rows are id = i * chunk_rows + row of
    chunk i; each chunk is made once."""
    q = queries.double()
    n_q = q.shape[0]
    dev = q.device
    best_d = torch.full((n_q, k), float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
    if pairs is not None:
        pairs = pairs.long().to(dev)
        pair_d = torch.full(pairs.shape, float("inf"), dtype=torch.float64,
                            device=dev)
        chunk_of = torch.where(pairs >= 0, pairs // chunk_rows,
                               torch.full_like(pairs, -1))
    step = max(1, block_elems // max(chunk_rows, 1))
    for c in range(n_chunks):
        rows = chunk_fn(c)
        base = c * chunk_rows
        if pairs is not None:
            sel = (chunk_of == c).nonzero(as_tuple=False)
            if sel.shape[0]:
                diff = q[sel[:, 0]] - rows[
                    pairs[sel[:, 0], sel[:, 1]] - base].double()
                pair_d[sel[:, 0], sel[:, 1]] = (diff * diff).sum(1)
        x = lower(rows, precision)
        del rows
        xn = (x * x).sum(1)
        for s in range(0, n_q, step):
            d = sqdist(q[s:s + step], x, xn)
            kk = min(k, d.shape[1])
            cd, ci = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            del d
            all_d = torch.cat([best_d[s:s + step], cd], dim=1)
            all_i = torch.cat([best_i[s:s + step], ci + base], dim=1)
            # ascending distance, then ascending id: sort by id first, then
            # stably by distance
            order = torch.argsort(all_i, dim=1, stable=True)
            all_d = torch.gather(all_d, 1, order)
            all_i = torch.gather(all_i, 1, order)
            order = torch.argsort(all_d, dim=1, stable=True)[:, :k]
            best_d[s:s + step] = torch.gather(all_d, 1, order)
            best_i[s:s + step] = torch.gather(all_i, 1, order)
        del x
    if pairs is None:
        return best_d, best_i, None
    return best_d, best_i, pair_d
