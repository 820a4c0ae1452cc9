"""The plain reference of a CAGRA search: a beam search over the index's
graph, one query at a time, in float64.

Plain PyTorch. It follows CAGRA's published search (Ootomo et al., "CAGRA:
Highly Parallel Graph Construction and Approximate Nearest Neighbor Search
for GPUs", arXiv:2308.15136, section IV): an internal top-M list (M =
itopk) sorted by distance, each entry flagged once it has been expanded;
each iteration takes the search_width best entries not yet expanded as
parents, scores their graph_degree neighbours and merges them into the
list; the number of iterations is fixed. Its inputs are what an index
holds: the stored rows, the graph and the entry map (the coarse centroids
and each list's medoid row), from which it finds each query's entry rows
itself. It imports nothing of the program.

Departures from the paper, each one the port's search makes as well:
  * no visited set: a neighbour is dropped while it is in the list (a row
    pushed out of the list cannot come back, since the list only gets
    better), and so is a later copy within one iteration's neighbours;
  * the earlier copy wins: among copies of one id, in the entry rows or in
    an iteration's neighbours (parents in list order, each parent's
    neighbours in graph order), the first is kept;
  * stable ties: every selection keeps the lower position first among
    equal distances (the list before the new neighbours);
  * entry rows: the medoids of the num_entry_points coarse lists nearest
    the query, then evenly spaced rows where the lists are fewer (the
    paper samples random rows); without an entry map, evenly spaced rows
    alone; the spacing is the port's (`linspace(0, n - 1, count)` in
    float32, truncated);
  * the iteration count: 2 * ceil(M / search_width), at least 8 and at
    most 64, unless one is given (the paper stops when every entry of the
    list has been expanded, within a least and a most).

Distances are exact squared L2 in float64 over each stored row's first
`dim` columns; rows at or past `n_valid` (pad rows) are never scored.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def plan(itopk: int, k: int, search_width: int,
         max_iterations: int = 0) -> Tuple[int, int, int]:
    """(list size M = max(itopk, k), parents an iteration, iterations)."""
    m = max(itopk, k)
    width = max(1, min(search_width, m))
    iters = max_iterations or min(64, max(8, 2 * math.ceil(m / width)))
    return m, width, iters


def evenly_spaced(n: int, count: int) -> List[int]:
    """`count` rows spaced over 0 .. n - 1: linspace computed in float32
    as stop * (1 / (count - 1)) * i, truncated, the last row n - 1."""
    if count == 1:
        return [0]
    f32 = torch.float32
    stop = torch.tensor(n - 1, dtype=f32)
    scale = stop * (torch.tensor(1.0, dtype=f32)
                    / torch.tensor(count - 1, dtype=f32))
    v = scale * torch.arange(count - 1, dtype=f32)
    return v.to(torch.int64).tolist() + [n - 1]


def entry_rows(query: torch.Tensor, centroids: torch.Tensor,
               medoids: torch.Tensor, num_entry_points: int,
               n_stored: int) -> List[int]:
    """A query's entry rows: the medoids of its nearest coarse lists (by
    float64 squared L2 to the centroids, ties to the lower list), then
    evenly spaced rows up to num_entry_points; evenly spaced rows alone
    where the index has no entry map."""
    if medoids.numel() == 0:
        return evenly_spaced(n_stored, min(num_entry_points, n_stored))
    c = centroids.double()
    d = ((c - query[None, :]) ** 2).sum(1)
    n_lists = min(num_entry_points, c.shape[0])
    lists = torch.sort(d, stable=True).indices[:n_lists]
    out = medoids.long()[lists].tolist()
    if num_entry_points > n_lists:
        out += evenly_spaced(n_stored, num_entry_points - n_lists)
    return out


def search_one(rows: torch.Tensor, graph: torch.Tensor, n_valid: int,
               query: torch.Tensor, entries: List[int], k: int, m: int,
               width: int, iters: int) -> Tuple[List[float], List[int]]:
    """One query's (k distances ascending, k ids); fewer where the search
    saw fewer than k rows. `rows` (n, >= dim) with the data in its first
    dim = query.shape[0] columns; `graph` (n, degree)."""
    dim = query.shape[0]

    def dist(ids: List[int]) -> List[float]:
        if not ids:
            return []
        x = rows[torch.tensor(ids, device=rows.device), :dim].double()
        return ((x - query[None, :]) ** 2).sum(1).tolist()

    seen, first = set(), []
    for i in entries:
        if i not in seen:
            seen.add(i)
            if 0 <= i < n_valid:
                first.append(i)
    # the list: [distance, id, expanded], sorted by distance, stable
    beam = sorted(([d, i, False] for d, i in zip(dist(first), first)),
                  key=lambda t: t[0])[:m]
    for _ in range(iters):
        parents = [t for t in beam if not t[2]][:width]
        if not parents:
            continue
        for t in parents:
            t[2] = True
        nbrs = graph[torch.tensor([t[1] for t in parents],
                                  device=graph.device)].reshape(-1).tolist()
        in_beam = {t[1] for t in beam}
        seen, new = set(), []
        for i in nbrs:
            if i in seen:
                continue
            seen.add(i)
            if i not in in_beam and 0 <= i < n_valid:
                new.append(i)
        beam = sorted(beam + [[d, i, False] for d, i in zip(dist(new), new)],
                      key=lambda t: t[0])[:m]
    return [t[0] for t in beam[:k]], [t[1] for t in beam[:k]]


def beam_search(rows: torch.Tensor, graph: torch.Tensor, n_valid: int,
                entry_centroids: torch.Tensor, entry_medoids: torch.Tensor,
                queries: torch.Tensor, k: int, *, itopk: int,
                search_width: int, num_entry_points: int,
                max_iterations: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """((Q, k) float64 distances ascending, (Q, k) int64 ids) of the beam
    search over an index's stored rows (n, >= D; the data in the first D =
    queries.shape[1] columns), graph (n, degree) and entry map ((C, D)
    centroids, (C,) medoid rows; C = 0 without one), on the rows' device;
    inf and -1 where a query's search saw fewer than k rows."""
    m, width, iters = plan(itopk, k, search_width, max_iterations)
    q = queries.double().to(rows.device)
    out_d = torch.full((q.shape[0], k), math.inf, dtype=torch.float64)
    out_i = torch.full((q.shape[0], k), -1, dtype=torch.int64)
    cents = entry_centroids.to(rows.device)
    medoids = entry_medoids.to(rows.device)
    for j in range(q.shape[0]):
        entries = entry_rows(q[j], cents, medoids, num_entry_points,
                             rows.shape[0])
        d, i = search_one(rows, graph, n_valid, q[j], entries, k, m, width,
                          iters)
        out_d[j, :len(d)] = torch.tensor(d, dtype=torch.float64)
        out_i[j, :len(i)] = torch.tensor(i, dtype=torch.int64)
    return out_d, out_i
