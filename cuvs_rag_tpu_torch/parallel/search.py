"""Sharded and replicated indexes over a device mesh: build, fan-out search
and merge, delete, extend, filtered views.

The counterpart of the JAX package's `parallel/search.py`, which runs each
operation as one SPMD program under `shard_map` and merges the shards'
candidates with an `all_gather` and `ops/topk.merge_topk`. Here one process
holds every shard: a `ShardedIndex` is one family index per mesh position,
on that position's device, plus each shard's global row offset. A search
launches every shard's scan on its position's own CUDA stream (the kernel
wrappers launch on the current stream), the merging stream waits for them,
and the (Q, k) scores and global ids of all shards merge on the
mesh's first device. On the CPU the shards run one after another.

Shards are contiguous row ranges (parallel/shard.py), so a global id is the
shard's offset plus the local id, and -1 stays -1. Offsets step by the
padded shard size, so an offset may pass the corpus size and trailing
shards may be empty.

Large k (32 < k <= 8192) takes each family's certified kernel on every
shard, flat's K3 as well as IVF-Flat's K5 (the JAX package's sharded flat
search runs its plain scan there); the shards' certificates are ANDed, and
one False re-runs the whole batch through the plain scan and counts
`<family>.certificate_reruns`. Results are exact either way.

The replicated placement holds the whole index at every position (one copy
per distinct device: positions that share a card share its storage) and
splits the query batch over the positions.

`search` and `view` take an index in any placement (single, sharded or
replicated); the pipeline, the hybrid retriever and the daemon call them.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base as index_base
from cuvs_rag_tpu_torch.index import cagra as cagra_family
from cuvs_rag_tpu_torch.index import filters as filters_lib
from cuvs_rag_tpu_torch.index import flat as flat_family
from cuvs_rag_tpu_torch.index import ivf_flat as ivf_flat_family
from cuvs_rag_tpu_torch.index import ivf_pq as ivf_pq_family
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import graph as graph_ops
from cuvs_rag_tpu_torch.ops import ivf_kernels
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.parallel import shard as shard_lib
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import Metric
from cuvs_rag_tpu_torch.utils.metrics import default_registry

# Each family module defines its index class and provides build, search,
# search_scores, default_search_params, delete, extend, and build_local or
# build_sharded_local.
FAMILIES = {
    "flat": flat_family,
    "ivf_flat": ivf_flat_family,
    "ivf_pq": ivf_pq_family,
    "cagra": cagra_family,
}


def register_family(name: str, module) -> None:
    FAMILIES[name] = module


def family_of(index) -> str:
    """The FAMILIES name of an index in any placement (a single index's
    family is the module that defines its class)."""
    if isinstance(index, (ShardedIndex, ReplicatedIndex)):
        return index.family
    for name, mod in FAMILIES.items():
        if type(index).__module__ == mod.__name__:
            return name
    raise TypeError(f"no family defines {type(index).__name__}")


class Shards(list):
    """Per-position indexes, entry i on the mesh's i-th device. A list
    subclass: unlike a list or tuple it takes a weak reference, which the
    filtered-view cache keys on."""


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """A family index sharded row-wise over a mesh: local[i] holds global
    rows offsets[i] .. offsets[i] + its n_valid - 1."""

    local: Shards
    offsets: np.ndarray  # (S,) int64
    family: str
    total: int

    @property
    def num_shards(self) -> int:
        return len(self.local)

    @property
    def metric(self) -> str:
        return self.local[0].metric

    @property
    def dim(self) -> int:
        return self.local[0].dim

    @property
    def device(self) -> torch.device:
        """Where queries go and the shards' candidates merge."""
        return self.local[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [ix.device for ix in self.local]


@dataclasses.dataclass(frozen=True)
class ReplicatedIndex:
    """The whole index at every mesh position: replicas[i] on the mesh's
    i-th device, positions on one device sharing one copy."""

    replicas: Shards
    family: str

    @property
    def index(self):
        return self.replicas[0]

    @property
    def metric(self) -> str:
        return self.index.metric

    @property
    def dim(self) -> int:
        return self.index.dim

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def devices(self) -> List[torch.device]:
        return [ix.device for ix in self.replicas]


def _mesh_of(index, dmesh: Optional[DeviceMesh]) -> DeviceMesh:
    return dmesh if dmesh is not None else DeviceMesh(index.devices)


def _shard_sizes(sindex: ShardedIndex) -> np.ndarray:
    """(S,) global rows each shard owns: shard i owns
    [offsets[i], min(offsets[i+1], total))."""
    offs = sindex.offsets
    ends = np.minimum(np.append(offs[1:], sindex.total), sindex.total)
    return np.clip(ends - offs, 0, None)


# ------------------------------------------------------------------ build ---


def build_sharded(family: str, params, corpus, dmesh: DeviceMesh,
                  row_multiple: Optional[int] = None) -> ShardedIndex:
    """One index shard per mesh position, each on its device. `corpus` is
    an (N, D) numpy array or tensor (sharded by shard_corpus with
    `row_multiple`, default the params' tile_n or 8) or a ShardedCorpus."""
    mod = FAMILIES[family]
    if not isinstance(corpus, shard_lib.ShardedCorpus):
        index_base.validate_dataset(corpus)
        rm = row_multiple or getattr(params, "tile_n", 8)
        corpus = shard_lib.shard_corpus(corpus, dmesh, row_multiple=rm)
    if hasattr(mod, "build_sharded_local"):
        local = mod.build_sharded_local(params, corpus, dmesh)
    else:
        local = [mod.build_local(params, blk, int(nv))
                 for blk, nv in zip(corpus.data, corpus.n_valid)]
    return ShardedIndex(local=Shards(local),
                        offsets=np.asarray(corpus.offsets, np.int64),
                        family=family, total=corpus.total)


def _index_to(index, device: torch.device):
    """`index` with its tensors on `device` (itself where they are)."""
    if index.device == device:
        return index
    return dataclasses.replace(index, **{
        f: getattr(index, f).to(device) for f in type(index)._tensor_fields})


def replicate(index, devices: Sequence[torch.device]) -> Shards:
    """One replica per position, one copy per distinct device."""
    copies = {}
    out = Shards()
    for dev in devices:
        if dev not in copies:
            copies[dev] = _index_to(index, dev)
        out.append(copies[dev])
    return out


def build_replicated(family: str, params, corpus,
                     dmesh: DeviceMesh) -> ReplicatedIndex:
    """The family index built once on the mesh's first device and placed
    at every position."""
    ix = FAMILIES[family].build(params, corpus, device=dmesh.first)
    return ReplicatedIndex(replicas=replicate(ix, dmesh.devices),
                           family=family)


# ----------------------------------------------------------------- update ---


def _require_delete(family: str):
    mod = FAMILIES[family]
    if not hasattr(mod, "delete"):
        raise ValueError(f"family {family!r} does not support delete")
    return mod


def delete_sharded(sindex: ShardedIndex, global_ids) -> ShardedIndex:
    """Tombstone-remove rows by GLOBAL id: each shard deletes the ids in
    its range, translated by its offset; ids outside every range are
    ignored."""
    mod = _require_delete(sindex.family)
    if isinstance(global_ids, torch.Tensor):
        global_ids = global_ids.cpu().numpy()
    ids = np.asarray(global_ids, np.int64).reshape(-1)
    if ids.size == 0:
        return sindex
    local = Shards()
    for ix, off, n in zip(sindex.local, sindex.offsets, _shard_sizes(sindex)):
        mine = ids[(ids >= off) & (ids < off + n)] - off
        local.append(mod.delete(ix, mine) if mine.size else ix)
    return dataclasses.replace(sindex, local=local)


def delete_replicated(rindex: ReplicatedIndex, ids) -> ReplicatedIndex:
    """Tombstone-remove rows by id (global == local on a replica)."""
    mod = _require_delete(rindex.family)
    return dataclasses.replace(rindex, replicas=replicate(
        mod.delete(rindex.index, ids), rindex.devices))


def extend_replicated(rindex: ReplicatedIndex,
                      new_vectors) -> ReplicatedIndex:
    """Append rows: the family's extend runs once, on the first replica
    (which it consumes), and the grown index is placed again; new rows get
    ids total..total+B-1 on every replica."""
    grown = FAMILIES[rindex.family].extend(
        rindex.index, index_base.as_tensor(new_vectors, rindex.device))
    return dataclasses.replace(rindex,
                               replicas=replicate(grown, rindex.devices))


def extend_sharded(sindex: ShardedIndex, new_vectors,
                   dmesh: Optional[DeviceMesh], params) -> ShardedIndex:
    """Append rows: new rows get global ids total..total+B-1, existing ids
    stay, deletions survive.

    A sharded extend is a RE-SHARD: every shard's rows are recovered in
    global order (index/io.recover_rows; reconstructions for compressed
    families), joined with the new rows on the mesh's first device (no
    host round trip), sharded evenly and rebuilt with `params` (indexes do
    not keep their build params); the old tombstones are applied again.
    It costs O(total + B): batch the appends. `dmesh` None: the mesh of
    the index's own devices."""
    from cuvs_rag_tpu_torch.index import io as io_lib

    dmesh = _mesh_of(sindex, dmesh)
    dim = sindex.dim
    if new_vectors.ndim != 2 or new_vectors.shape[1] != dim:
        raise ValueError(f"new vectors must be (B, {dim}), got "
                         f"{tuple(new_vectors.shape)}")
    new = index_base.as_tensor(new_vectors, dmesh.first)
    rows, deleted = [], []
    for ix, off, n in zip(sindex.local, sindex.offsets, _shard_sizes(sindex)):
        if n == 0:
            continue
        rows.append(io_lib.recover_rows(ix).to(dmesh.first))
        deleted.append(off + io_lib.deleted_row_ids(ix))
    full = torch.cat(rows + [new.to(rows[0].dtype)]) if rows else new
    if full.shape[0] != sindex.total + new.shape[0]:
        raise RuntimeError(f"recovered {full.shape[0] - new.shape[0]} rows "
                           f"of a {sindex.total}-row index")
    out = build_sharded(sindex.family, params, full, dmesh)
    del full
    gone = np.concatenate(deleted) if deleted else np.zeros(0, np.int64)
    return delete_sharded(out, gone) if gone.size else out


# ----------------------------------------------------------- filtered views ---


def filtered_view_sharded(sindex: ShardedIndex, allow) -> ShardedIndex:
    """A sharded index restricted to a GLOBAL (total,) bool allow mask:
    each shard takes its own rows of the mask in its local id space and
    makes its family's view (index/filters.view_traced), which shares the
    vector storage. CAGRA is post-filter only: pass `allow=` to
    search_sharded."""
    if sindex.family == "cagra":
        raise ValueError("cagra filtering is post-filter only; pass allow= to "
                         "search_sharded instead of building a view")
    mask = _host_mask(allow)
    if mask.dtype != np.bool_ or mask.shape != (sindex.total,):
        raise ValueError(
            f"allow must be a ({sindex.total},) bool mask over global ids, "
            f"got {mask.dtype} {mask.shape}")
    local = Shards()
    for ix, off, n in zip(sindex.local, sindex.offsets, _shard_sizes(sindex)):
        # flat views add the penalty row by row over the padded rows; the
        # IVF families read a layout slot's mask entry by its local row id
        width = ix.size if sindex.family == "flat" else max(int(n), 1)
        part = np.zeros(width, bool)
        part[:n] = mask[off:off + n]
        local.append(filters_lib.view_traced(
            ix, torch.from_numpy(part).to(ix.device)))
    return dataclasses.replace(sindex, local=local)


def _host_mask(allow) -> np.ndarray:
    if isinstance(allow, torch.Tensor):
        return allow.cpu().numpy()
    return np.asarray(allow)


# A request's `allow=` mask repeats across requests (tenant ACLs, session
# scopes), and making a sharded view costs O(total) host work and a copy to
# every shard. Views are cached by the mask's content and the identity of
# the source's shard container (checked through a weak reference, so a
# recycled id() never aliases; dead entries go at every lookup). An entry
# shares the vector storage, so it costs one (rows,) tensor a shard.
_VIEW_CACHE: "dict[tuple, tuple]" = {}
_VIEW_CACHE_MAX = 8
# The daemon searches from several threads; the cache is changed only under
# this lock (the view itself is made outside it: a racing duplicate is
# harmless, the last writer wins).
_VIEW_CACHE_LOCK = threading.Lock()


def _filtered_view_sharded_cached(sindex: ShardedIndex,
                                  allow) -> ShardedIndex:
    mask = np.ascontiguousarray(_host_mask(allow))
    key = (id(sindex.local), sindex.total,
           hashlib.sha1(mask.tobytes()).hexdigest())
    with _VIEW_CACHE_LOCK:
        for kk in [k for k, v in _VIEW_CACHE.items() if v[0]() is None]:
            del _VIEW_CACHE[kk]
        hit = _VIEW_CACHE.get(key)
        if hit is not None and hit[0]() is sindex.local:
            default_registry.inc("parallel.view_cache_hits")
            return dataclasses.replace(sindex, local=hit[1])
    view = filtered_view_sharded(sindex, mask)
    with _VIEW_CACHE_LOCK:
        if len(_VIEW_CACHE) >= _VIEW_CACHE_MAX:
            _VIEW_CACHE.pop(next(iter(_VIEW_CACHE)))
        _VIEW_CACHE[key] = (weakref.ref(sindex.local), view.local)
    return view


def filtered_view_replicated(rindex: ReplicatedIndex,
                             allow) -> ReplicatedIndex:
    """The view of the first replica, placed at every position."""
    view = filters_lib.filtered_view(rindex.index, allow)
    return dataclasses.replace(rindex,
                               replicas=replicate(view, rindex.devices))


# ----------------------------------------------------------------- search ---


def _postfilter_merged(scores, idx, mask: torch.Tensor, k: int):
    """Drop merged candidates outside the global allow mask and keep the k
    best, ties to the lowest position (a stable sort, as `lax.top_k`)."""
    ok = filters_lib._gather_by_row_ids(mask, idx.reshape(-1)
                                        ).reshape(idx.shape)
    top_s, arg = graph_ops.topk_first(
        scores.masked_fill(~ok, graph_ops.NEG_INF), k)
    top_i = torch.gather(idx, 1, arg).masked_fill(
        top_s == graph_ops.NEG_INF, -1)
    return top_s, top_i


def _sharded_large_route(sindex: ShardedIndex, k_local: int, search_params):
    """The family's certified large-k scan of one shard,
    fn(sp, index, queries, k) -> (scores, ids, certified), or None: flat's
    K3 where its single search takes it, IVF-Flat's K5 where the card's
    `large_k_config` admits the shards' common window."""
    loc = sindex.local[0]
    if sindex.family == "flat":
        if flat_family._use_kernel_large(loc, k_local, search_params):
            return flat_family.search_scores_large
        return None
    if sindex.family == "ivf_flat":
        cfg = ivf_kernels.large_k_config(loc.max_list_size, loc.dim, k_local)
        if cfg is not None:
            return functools.partial(ivf_flat_family.search_scores_large,
                                     n_sub=cfg[0], r_planes=cfg[1])
    return None


def _fan_out_search(dmesh, sindex, queries, kk, scan):
    """scan(index, queries) -> (scores, local ids[, certified]) on every
    shard, then the merge: ((Q, kk) scores, global ids, (Q,) certified)."""
    offsets = sindex.offsets

    def work(i):
        ix = sindex.local[i]
        out = scan(ix, queries.to(ix.device))
        scores, lidx = out[0], out[1]
        cert = out[2] if len(out) > 2 else torch.ones(
            scores.shape[0], dtype=torch.bool, device=scores.device)
        gidx = torch.where(lidx >= 0, lidx.to(torch.int32) + int(offsets[i]),
                           torch.full_like(lidx, -1, dtype=torch.int32))
        return scores, gidx, cert

    outs = dmesh.fan_out(work, range(sindex.num_shards))
    scores, idx = topk_ops.merge_topk(torch.cat([o[0] for o in outs], 1),
                                      torch.cat([o[1] for o in outs], 1), kk)
    cert = torch.stack([o[2] for o in outs]).all(dim=0)
    return scores, idx, cert


def search_sharded(search_params, sindex: ShardedIndex, queries, k: int,
                   dmesh: Optional[DeviceMesh] = None,
                   allow=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fan-out search: every shard's top-k on its device and stream, the
    candidates gathered to the first device and merged there -> ((Q, k)
    distances, (Q, k) global ids). A shard's own top-k is all it can add:
    a row outside it has k better rows in that shard alone, so a larger
    fetch a shard cannot change the merged result.

    `allow` (optional): a (total,) bool mask over GLOBAL ids. Flat and the
    IVF families search a cached filtered view (exact); CAGRA over-fetches
    the merge 4x (up to itopk_size) and post-filters it. A mask reused
    across many searches can be baked once with filtered_view_sharded."""
    queries, scores, idx = search_sharded_scores(
        search_params, sindex, queries, k, dmesh, allow)
    return scores_to_distances(sindex.metric, queries, scores), idx


def scores_to_distances(metric: str, queries: torch.Tensor,
                        scores: torch.Tensor) -> torch.Tensor:
    """A merged (Q, k) score block as the metric's distances."""
    qn = dist_ops.l2_normalize(queries) \
        if metric == Metric.COSINE else queries
    return dist_ops.scores_to_distances(
        scores, dist_ops.sqnorms(qn.float()), metric)


def search_sharded_scores(search_params, sindex: ShardedIndex, queries,
                          k: int, dmesh: Optional[DeviceMesh] = None,
                          allow=None):
    """search_sharded before the scores become distances -> (the queries
    as validated on the merging device, (Q, k) merged scores, larger is
    better, (Q, k) global ids): what parallel/distributed.py gathers
    across processes and merges again."""
    dmesh = _mesh_of(sindex, dmesh)
    mod = FAMILIES[sindex.family]
    queries = index_base.validate_queries(
        index_base.as_tensor(queries, sindex.device), sindex.dim)
    if search_params is None:
        search_params = mod.default_search_params()
    kk, mask = k, None
    if allow is not None:
        if sindex.family == "cagra":
            mask = filters_lib._as_mask(allow, sindex.total, sindex.device)
            kk = min(max(k, int(round(k * 4.0))), search_params.itopk_size)
            if kk < k:
                raise ValueError(
                    f"k={k} exceeds itopk_size={search_params.itopk_size}; "
                    "raise CagraSearchParams.itopk_size")
        else:
            sindex = _filtered_view_sharded_cached(sindex, allow)
    sp = search_params
    large = _sharded_large_route(sindex, kk, sp)
    if large is not None:
        scores, idx, cert = _fan_out_search(
            dmesh, sindex, queries, kk, lambda ix, q: large(sp, ix, q, kk))
        if not bool(cert.all()):
            # a Poisson-rare certificate failure on some shard: the whole
            # batch takes the plain scan
            default_registry.inc(f"{sindex.family}.certificate_reruns")
            large = None
    if large is None:
        scores, idx, _ = _fan_out_search(
            dmesh, sindex, queries, kk,
            lambda ix, q: mod.search_scores(sp, ix, q, kk))
    if mask is not None:
        scores, idx = _postfilter_merged(scores, idx, mask, k)
    return queries, scores, idx


def search_sharded_batched(search_params, sindex: ShardedIndex, queries,
                           k: int, dmesh: Optional[DeviceMesh] = None,
                           batch_size: int = 100,
                           allow=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """search_sharded over `batch_size` queries at a time (the filtered view
    is made once), the results joined."""
    queries = index_base.validate_queries(
        index_base.as_tensor(queries, sindex.device), sindex.dim)
    if allow is not None and sindex.family != "cagra":
        sindex, allow = _filtered_view_sharded_cached(sindex, allow), None
    outs = [search_sharded(search_params, sindex,
                           queries[i:i + batch_size], k, dmesh,
                           allow=allow)
            for i in range(0, queries.shape[0], batch_size)]
    return torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs])


def search_replicated(search_params, rindex: ReplicatedIndex, queries,
                      k: int, dmesh: Optional[DeviceMesh] = None,
                      allow=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-parallel search: the batch is cut into one contiguous part a
    position, each part searched on its position's replica and stream, and
    the parts joined in order on the first device. No merge: every replica
    holds every row. `allow`: an (n,) bool mask (a filtered view, or
    CAGRA's post-filter)."""
    dmesh = _mesh_of(rindex, dmesh)
    mod = FAMILIES[rindex.family]
    queries = index_base.validate_queries(
        index_base.as_tensor(queries, rindex.device), rindex.dim)
    if search_params is None:
        search_params = mod.default_search_params()
    replicas = rindex.replicas
    if allow is not None and rindex.family != "cagra":
        replicas = filtered_view_replicated(rindex, allow).replicas
        allow = None
    step = -(-queries.shape[0] // len(replicas))
    parts = range(-(-queries.shape[0] // step))

    def work(i):
        ix = replicas[i]
        q = queries[i * step:(i + 1) * step].to(ix.device)
        if allow is not None:
            return filters_lib.search(search_params, ix, q, k, allow)
        return mod.search(search_params, ix, q, k)

    outs = dmesh.fan_out(work, parts)
    return torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs])


# --------------------------------------------------- any placement ---


def view(index, allow):
    """A filtered view of an index in any placement: `allow` a bool mask
    over its (global) ids. Shares the vector storage; CAGRA, post-filter
    only, raises."""
    if isinstance(index, ShardedIndex):
        return filtered_view_sharded(index, allow)
    if isinstance(index, ReplicatedIndex):
        return filtered_view_replicated(index, allow)
    return filters_lib.filtered_view(index, allow)


def search(search_params, index, queries, k: int,
           dmesh: Optional[DeviceMesh] = None, allow=None,
           **search_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an index in any placement -> ((Q, k) distances, (Q, k) ids).
    `allow` (optional): a bool mask over the index's ids (a filtered view;
    CAGRA's post-filter). `search_kw` goes to a single index's family
    search (the pipeline's out-of-core refine). The call is the span
    `search` (family, placement, queries)."""
    if isinstance(index, ShardedIndex):
        placement, family = "shard", index.family
    elif isinstance(index, ReplicatedIndex):
        placement, family = "replicate", index.family
    else:
        placement, family = "single", family_of(index)
    n_queries = 1 if getattr(queries, "ndim", 2) == 1 else len(queries)
    with profiling.span("search", family=family, placement=placement,
                        queries=n_queries):
        if placement == "shard":
            return search_sharded(search_params, index, queries, k, dmesh,
                                  allow=allow)
        if placement == "replicate":
            return search_replicated(search_params, index, queries, k,
                                     dmesh, allow=allow)
        mod = FAMILIES[family]
        if allow is not None:
            if mod is cagra_family:
                return filters_lib.search(search_params, index, queries, k,
                                          allow)
            index = filters_lib.filtered_view(index, allow)
        return mod.search(search_params, index, queries, k, **search_kw)
