"""Index checkpoint/restore in the JAX package's npz format (format 3).

One .npz file per index: each tensor field as an array (bf16 stored as its
uint16 bit pattern, listed under "bf16"), `n_valid` as a 0-d int32 array,
and a `__meta__` JSON record {"__class__", "static", "bf16", "format"}. A
file saved by either package loads in the other, for all four families. An
IVFPQIndex file older than format 2 holds row-major (cap, mb) codes and is
transposed to the stream-major layout on load; a CagraIndex file older
than format 3 holds raw (Np, D) rows and no data_dim, and is migrated to
the score-augmented layout (_migrate_cagra_v2).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base

_BF16 = "bf16"


def _registry():
    from cuvs_rag_tpu_torch.index.cagra import CagraIndex
    from cuvs_rag_tpu_torch.index.flat import FlatIndex
    from cuvs_rag_tpu_torch.index.ivf_flat import IVFFlatIndex
    from cuvs_rag_tpu_torch.index.ivf_pq import IVFPQIndex

    return {"FlatIndex": FlatIndex, "IVFFlatIndex": IVFFlatIndex,
            "IVFPQIndex": IVFPQIndex, "CagraIndex": CagraIndex}


def save_index(path: str, index: Any) -> None:
    """Serialize an index dataclass to one .npz file."""
    cls = type(index).__name__
    if cls not in _registry():
        raise ValueError(f"unknown index type {cls}; known: {list(_registry())}")
    arrays, meta = {}, {"__class__": cls, "static": {}, _BF16: [], "format": 3}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if f.name in type(index)._tensor_fields:
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                meta[_BF16].append(f.name)
                a = t.view(torch.int16).numpy().view(np.uint16)
            else:
                a = t.numpy()
            arrays[f.name] = a
        elif f.name == "n_valid":  # an array leaf in the format
            arrays[f.name] = np.asarray(v, np.int32)
        else:
            meta["static"][f.name] = v
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_index(path: str, device=None) -> Any:
    """Restore an index saved by either package's save_index, onto `device`
    (the card when None: base.resolve_device)."""
    device = base.resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        name = meta["__class__"]
        if name not in _registry():
            raise NotImplementedError(
                f"{name} files load once that family is ported (ROADMAP.md)"
            )
        cls = _registry()[name]
        kwargs = dict(meta["static"])
        kwargs["n_valid"] = int(z["n_valid"])
        for field in cls._tensor_fields:
            if field not in z:
                continue  # a field newer than the file: migrated below
            a = z[field]
            if field in meta[_BF16]:
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            kwargs[field] = t.to(device)
        if name == "IVFPQIndex" and meta.get("format", 1) < 2:
            kwargs["codes"] = kwargs["codes"].T.contiguous()
        if name == "CagraIndex" and "data_dim" not in kwargs:
            _migrate_cagra_v2(kwargs)
    return cls(**kwargs)


def _migrate_cagra_v2(kwargs: dict) -> None:
    """A CagraIndex file older than format 3 holds raw (Np, D) rows and no
    data_dim or entry-map fields: rebuild the score-augmented rows
    (ops/graph.augment_rows) and put the sqnorm slots' tombstones back
    into the [hi, lo] columns, so deleted rows stay deleted in every
    metric."""
    from cuvs_rag_tpu_torch.ops import distance as dist_ops
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    v = kwargs["vectors"]
    d = v.shape[-1]
    kwargs["data_dim"] = d
    kwargs.setdefault("entry_centroids", torch.zeros(
        (0, d), dtype=torch.float32, device=v.device))
    kwargs.setdefault("entry_rows", torch.zeros(0, dtype=torch.int32,
                                                device=v.device))
    sq = kwargs["sqnorms"].float()
    aug = graph_ops.augment_rows(
        v, torch.clamp(sq, max=dist_ops.DELETED_THRESHOLD),
        kwargs["n_valid"], kwargs["metric"])
    tomb = sq > dist_ops.DELETED_THRESHOLD
    aug[tomb, d] = dist_ops.DELETED_PENALTY
    aug[tomb, d + 1] = 0.0
    kwargs["vectors"] = aug


def recover_rows(index: Any) -> torch.Tensor:
    """(n_valid, dim) corpus rows in ORIGINAL order, reconstructed from any
    ported family's storage (dequantized or decoded where compressed)."""
    cls = type(index).__name__
    nv = int(index.n_valid)
    if cls == "FlatIndex":
        v = index.vectors[:nv]
        if v.dtype == torch.int8:
            v = v.float() * index.scales[:nv, None]
        return v
    if cls == "CagraIndex":
        return index.vectors[:nv, :index.dim]  # drop the [hi, lo] columns
    if cls == "IVFFlatIndex":
        from cuvs_rag_tpu_torch.index.ivf_flat import _recover_rows

        return _recover_rows(index, nv)[0]
    if cls == "IVFPQIndex":
        return _recover_rows_pq(index, nv)
    raise ValueError(f"cannot recover rows from {cls}")


def _recover_rows_pq(index: Any, nv: int) -> torch.Tensor:
    """Original-order rows of an IVF-PQ layout: the raw refine store when
    present, else the PQ reconstruction (centroid + decoded residual)."""
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.ops import pq as pq_ops

    slot_of, label_of_slot = ivf_ops.invert_layout(
        index.row_ids, index.list_offsets, nv)
    slot_of = slot_of.long()
    if index.has_raw:
        return index.raw_vectors[slot_of][:, :index.dim]
    codes = index.codes.T[slot_of]  # stream-major -> (nv, code bytes)
    if index.codes_packed:
        codes = pq_ops.unpack_nibbles(codes, index.codebooks.shape[0])
    if index.levels == 2:
        m = index.pq_dim
        res = pq_ops.reconstruct(codes[:, :m], index.codebooks[:m]) \
            + pq_ops.reconstruct(codes[:, m:], index.codebooks[m:])
    else:
        res = pq_ops.reconstruct(codes, index.codebooks)
    if index.has_opq:
        res = res @ index.rotation  # inverse of r @ R.T
    cents = index.centroids[label_of_slot[slot_of].long()]
    return (cents + res)[:, :index.dim]


def deleted_row_ids(index: Any) -> np.ndarray:
    """Host-side: original ids tombstone-removed from any ported family's
    index (see <family>.delete). The positional families (flat, CAGRA) read
    the sqnorm-slot tombstone; the layout families read the row_ids gaps,
    and refuse a window-capped layout, whose gaps are not deletions."""
    from cuvs_rag_tpu_torch.ops.distance import DELETED_THRESHOLD

    cls = type(index).__name__
    nv = int(index.n_valid)
    if cls in ("FlatIndex", "CagraIndex"):
        sq = index.sqnorms[:nv].cpu().numpy()
        return np.nonzero(sq > DELETED_THRESHOLD)[0].astype(np.int64)
    from cuvs_rag_tpu_torch.index.ivf_flat import deleted_ids

    return deleted_ids(index)


def save_sharded(prefix: str, sindex: Any) -> None:
    """Persist a parallel/search.ShardedIndex as `{prefix}_part{i}.npz` (each
    shard's save_index) and `{prefix}.json` (family, total, offsets,
    num_shards): the JAX package's files, loadable by either package.

    A parallel/distributed.DistributedIndex (one rank's shards) is saved
    by every rank at once: each writes only its own shards' part files,
    under their global numbers; after a barrier rank 0 writes the
    manifest, and a second barrier holds every rank until it exists."""
    from cuvs_rag_tpu_torch.parallel import distributed

    if isinstance(sindex, distributed.DistributedIndex):
        for j, part in enumerate(sindex.local.local):
            save_index(f"{prefix}_part{sindex.first_shard + j}.npz", part)
        distributed.barrier()
        if sindex.rank == 0:
            _write_manifest(prefix, sindex)
        distributed.barrier()
        return
    for i, part in enumerate(sindex.local):
        save_index(f"{prefix}_part{i}.npz", part)
    _write_manifest(prefix, sindex)


def _write_manifest(prefix: str, sindex: Any) -> None:
    with open(f"{prefix}.json", "w") as f:
        json.dump({
            "family": sindex.family,
            "total": sindex.total,
            "offsets": [int(o) for o in sindex.offsets],
            "num_shards": sindex.num_shards,
        }, f)


def load_sharded(prefix: str, dmesh, params: Any = None) -> Any:
    """Restore a sharded index saved by either package's save_sharded onto
    `dmesh`. A mesh of the saved size restores exactly, part i on the i-th
    position's device. Another size recovers the rows (recover_rows, on
    the mesh's first device) and rebuilds them on the new mesh with
    `params`, which are then required; tombstones are applied again.

    In a process group (parallel/distributed.init_from_env) `dmesh` is the
    rank's local mesh and every rank calls this: where world_size x its
    positions equals the saved shards, each rank reads only its own part
    files and gets a DistributedIndex; otherwise every rank recovers all
    the rows and the rebuild runs across the ranks
    (distributed.build_sharded)."""
    from cuvs_rag_tpu_torch.parallel import distributed
    from cuvs_rag_tpu_torch.parallel import search as psearch

    with open(f"{prefix}.json") as f:
        meta = json.load(f)
    s = meta["num_shards"]
    offsets = np.asarray(meta["offsets"], np.int64)
    multi = distributed.is_initialized()
    if multi:
        rank, world = distributed.rank_and_world()
        n_here = world * dmesh.num_devices
    else:
        n_here = dmesh.num_devices
    if n_here == s:
        if multi:
            n_local = dmesh.num_devices
            first = rank * n_local
            parts = [load_index(f"{prefix}_part{first + j}.npz", device=dev)
                     for j, dev in enumerate(dmesh.devices)]
            n_valid = np.diff(np.minimum(
                np.append(offsets, meta["total"]), meta["total"])).clip(0)
            return distributed.local_index(
                meta["family"], parts, offsets, n_valid, meta["total"],
                rank, world, n_local)
        parts = [load_index(f"{prefix}_part{i}.npz", device=dev)
                 for i, dev in enumerate(dmesh.devices)]
        return psearch.ShardedIndex(
            local=psearch.Shards(parts), offsets=offsets,
            family=meta["family"], total=meta["total"])
    if params is None:
        raise ValueError(
            f"checkpoint has {s} shards but mesh has {n_here} "
            "devices; pass `params` to rebuild on the new mesh")
    rows, gone = [], []
    for i in range(s):
        part = load_index(f"{prefix}_part{i}.npz", device=dmesh.first)
        rows.append(recover_rows(part))
        gone.append(deleted_row_ids(part) + offsets[i])
    rows = torch.cat(rows)
    if rows.shape[0] != meta["total"]:
        raise ValueError(
            f"sharded checkpoint is corrupt: recovered {rows.shape[0]} rows, "
            f"meta says {meta['total']}")
    if multi:
        out = distributed.build_sharded(meta["family"], params, rows, dmesh)
        delete = distributed.delete
    else:
        out = psearch.build_sharded(meta["family"], params, rows, dmesh)
        delete = psearch.delete_sharded
    del rows
    gone = np.concatenate(gone)
    return delete(out, gone) if gone.size else out
