"""Sharded indexes across processes: one torch.distributed rank a process.

The counterpart of the JAX package's multi-process path
(`jax.distributed.initialize()` and one SPMD program over a mesh that spans
the processes). Here every rank holds only its own shards: the corpus's
global layout is the one-process layout over world_size x local positions
(parallel/shard.shard_layout), rank r owns positions r * L .. (r + 1) * L - 1
of it and builds them over its local mesh (parallel/search.build_sharded)
with their global offsets. The IVF families' builds agree on one probe
window through one all_reduce (ShardedCorpus.reduce_max), so the shards are
the ones a single process would build over the same positions.

A search runs `search_sharded` on the rank's shards, `all_gather`s the
rank's (Q, k) scores and global ids, and every rank merges them with
`ops/topk.merge_topk`: every rank holds the same result, equal to the
one-process search over the same positions.

    init_from_env()                         # under torchrun, before CUDA work
    dix = build_sharded("ivf_flat", params, corpus, DeviceMesh([dev]))
    dists, ids = search(None, dix, queries, 10)

NCCL runs one rank a card (cuda:LOCAL_RANK); gloo runs ranks on the CPU.
Every rank must make the same calls in the same order (they are
collectives), with the same corpus and queries.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cuvs_rag_tpu_torch.index import base as index_base
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel import shard as shard_lib
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

# how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)


def init_from_env(device=None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) and return
    this rank's device: `device` where given, else cuda:LOCAL_RANK. A CUDA
    device takes NCCL (the rank's card is made current first), the CPU
    gloo. Call it before the first CUDA allocation of the process."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None \
        else torch.device("cuda", local_rank)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world():
    return dist.get_rank(), dist.get_world_size()


def _comm_device() -> torch.device:
    """Where collective buffers live: the current card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_max(x: int) -> int:
    """The largest x over every rank."""
    t = torch.tensor([int(x)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's (Q, C) block joined along dim 1 in rank order, on the
    device of `t`."""
    src = t.contiguous().to(_comm_device())
    parts: List[torch.Tensor] = [torch.empty_like(src)
                                 for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=1).to(t.device)


@dataclasses.dataclass(frozen=True)
class DistributedIndex:
    """A sharded index spread over the ranks: `local` is this rank's
    ShardedIndex (its shards with their global offsets; its `total` is the
    end of the rank's rows), `offsets` every shard's global offset,
    `first_shard` the global number of local.local[0]."""

    local: psearch.ShardedIndex
    offsets: np.ndarray  # (S,) int64, every rank's shards
    family: str
    total: int
    first_shard: int
    rank: int
    world_size: int

    @property
    def num_shards(self) -> int:
        return len(self.offsets)

    @property
    def metric(self) -> str:
        return self.local.metric

    @property
    def dim(self) -> int:
        return self.local.dim

    @property
    def device(self) -> torch.device:
        return self.local.device


def _rank_positions(dmesh: DeviceMesh):
    """(rank, world, local positions L, global shards S) after checking
    that every rank brings the same number of positions."""
    rank, world = rank_and_world()
    n = dmesh.num_devices
    if reduce_max(n) != n or reduce_max(-n) != -n:
        raise ValueError("every rank needs a mesh of the same size")
    return rank, world, n, world * n


def local_index(family: str, local_shards: list, offsets: np.ndarray,
                n_valid: np.ndarray, total: int, rank: int, world: int,
                n_local: int) -> DistributedIndex:
    """Wrap this rank's shards (global shard numbers rank * n_local ...)
    as a DistributedIndex over the global `offsets` / `n_valid`."""
    mine = slice(rank * n_local, (rank + 1) * n_local)
    end = int(offsets[mine][-1] + n_valid[mine][-1])
    local = psearch.ShardedIndex(
        local=psearch.Shards(local_shards),
        offsets=np.asarray(offsets[mine], np.int64), family=family,
        total=end)
    return DistributedIndex(local=local,
                            offsets=np.asarray(offsets, np.int64),
                            family=family, total=int(total),
                            first_shard=rank * n_local, rank=rank,
                            world_size=world)


def build_sharded(family: str, params, corpus, dmesh: DeviceMesh,
                  row_multiple: Optional[int] = None) -> DistributedIndex:
    """This rank's shards of the common (N, D) `corpus` (numpy or tensor;
    the same on every rank), built over its local mesh: the layout of
    world_size x dmesh.num_devices equal padded shards, as shard_corpus
    makes it in one process (row_multiple defaults to the params' tile_n
    or 8)."""
    index_base.validate_dataset(corpus)
    rank, world, n_local, n_shards = _rank_positions(dmesh)
    rm = row_multiple or getattr(params, "tile_n", 8)
    n = corpus.shape[0]
    per, n_valid, offsets = shard_lib.shard_layout(n, n_shards, rm)
    mine = slice(rank * n_local, (rank + 1) * n_local)
    data = [shard_lib._block(corpus, int(off), int(nv), per, dev)
            for off, nv, dev in zip(offsets[mine], n_valid[mine],
                                    dmesh.devices)]
    sc = shard_lib.ShardedCorpus(
        data=data, n_valid=n_valid[mine], offsets=offsets[mine], total=n,
        global_shards=n_shards, reduce_max=reduce_max)
    sidx = psearch.build_sharded(family, params, sc, dmesh)
    return local_index(family, list(sidx.local), offsets, n_valid, n, rank,
                       world, n_local)


def search(search_params, dindex: DistributedIndex, queries, k: int,
           dmesh: Optional[DeviceMesh] = None):
    """((Q, k) distances, (Q, k) global ids) over every rank's shards, the
    same on every rank: the rank's own fan-out and merge
    (search_sharded_scores), then an all_gather of every rank's (Q, k)
    scores and ids and one more merge_topk."""
    q, scores, ids = psearch.search_sharded_scores(
        search_params, dindex.local, queries, k, dmesh)
    scores, ids = topk_ops.merge_topk(all_gather_cat(scores),
                                      all_gather_cat(ids), k)
    return psearch.scores_to_distances(dindex.metric, q, scores), ids


def delete(dindex: DistributedIndex, global_ids) -> DistributedIndex:
    """Tombstone-remove rows by global id; each rank deletes those in its
    own shards."""
    return dataclasses.replace(
        dindex, local=psearch.delete_sharded(dindex.local, global_ids))
