"""Corpus sharding with validated invariants and explicit global offsets.

The counterpart of the JAX package's `parallel/shard.py`. Shards are
contiguous row ranges, so a row's global id is its shard's offset plus its
local id. Shard i is a (per_shard, D) block on the mesh's i-th device whose
rows past `n_valid[i]` are zero padding; a block that lies whole inside a
corpus tensor already on its device is a view of it, not a copy.

Two layouts are legal (`_validate_layout`): equal padded shards, whose
offsets step by per_shard (the even strategy; offsets may pass the corpus
size and trailing shards may be empty), and proportional shards, whose
offsets step by each shard's row count (the memory_based strategy).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class ShardedCorpus:
    """An (N, D) corpus as S blocks of (per_shard, D) rows.

    data: block i on the mesh's i-th device. n_valid: (S,) int32, real rows
    per block (the rest is zero padding). offsets: (S,) int32, the global
    row id of each block's first row. total: the corpus size N."""

    data: List[torch.Tensor]
    n_valid: np.ndarray
    offsets: np.ndarray
    total: int

    @property
    def num_shards(self) -> int:
        return len(self.data)

    @property
    def per_shard(self) -> int:
        return self.data[0].shape[0]

    @property
    def dim(self) -> int:
        return self.data[0].shape[1]

    def validate(self) -> None:
        _validate_layout(self.total, self.per_shard, self.n_valid,
                         self.offsets)

    def gather_to_host(self) -> np.ndarray:
        """The original (N, D) corpus as a host array (bf16 as fp32)."""
        return np.concatenate([
            _host(blk[:nv]) for blk, nv in zip(self.data, self.n_valid)
        ], axis=0)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _validate_layout(total, per_shard, n_valid, offsets) -> None:
    """The coverage, bounds and no-gap/no-overlap invariants on host
    values."""
    n_valid = np.asarray(n_valid)
    offsets = np.asarray(offsets)
    num_shards = len(n_valid)
    if n_valid.sum() != total:
        raise AssertionError(
            f"coverage violated: shard sizes {n_valid.tolist()} sum to "
            f"{n_valid.sum()}, expected {total}")
    if np.any(n_valid < 0) or np.any(n_valid > per_shard):
        raise AssertionError(f"shard size out of bounds: {n_valid.tolist()}")
    even = np.arange(num_shards) * per_shard
    prop = np.concatenate([[0], np.cumsum(n_valid)[:-1]])
    if not (np.array_equal(offsets, even) or np.array_equal(offsets, prop)):
        raise AssertionError(
            f"offsets {offsets.tolist()} match neither the equal-padded "
            f"({even.tolist()}) nor the proportional ({prop.tolist()}) "
            "layout")


def shard_layout(total: int, num_shards: int, row_multiple: int = 8):
    """(per_shard, n_valid (S,), offsets (S,)) of equal padded shards:
    per_shard is ceil(total / S) rounded up to `row_multiple`, and shard i
    owns global rows [i * per_shard, i * per_shard + n_valid[i])."""
    per = -(-total // num_shards)
    per = topk_ops.round_up(max(per, 1), row_multiple)
    n_valid = np.clip(total - np.arange(num_shards) * per, 0, per
                      ).astype(np.int32)
    offsets = (np.arange(num_shards) * per).astype(np.int32)
    return per, n_valid, offsets


def _block(corpus, off: int, nv: int, per: int, device) -> torch.Tensor:
    """Rows [off, off + nv) of `corpus` (numpy or tensor) as a (per, D)
    block on `device`, zero-padded; a whole block of a tensor already on
    `device` is a view."""
    if isinstance(corpus, np.ndarray):
        rows = np.ascontiguousarray(corpus[off:off + nv])
        if not rows.flags.writeable:  # a read-only memmap: copy the block
            rows = rows.copy()
        rows = torch.from_numpy(rows)
    else:
        rows = corpus[off:off + nv]
    rows = rows.to(device)
    return rows if nv == per else topk_ops.pad_rows(rows, per)


def shard_corpus(corpus, dmesh: DeviceMesh, row_multiple: int = 8,
                 strategy: str = "even") -> ShardedCorpus:
    """Shard an (N, D) numpy array or tensor over the mesh.

    strategy: 'even' (equal padded shards) or 'memory_based' (rows in
    proportion to each position's free memory, DeviceMesh.split_sizes;
    every block is padded to the largest shard, with exact per-shard row
    counts and global offsets)."""
    if corpus.ndim != 2 or corpus.shape[0] == 0:
        raise ValueError(
            f"corpus must be non-empty (N, D), got {tuple(corpus.shape)}")
    n = corpus.shape[0]
    s = dmesh.num_devices
    if strategy == "even":
        per, n_valid, offsets = shard_layout(n, s, row_multiple)
    else:
        sizes = dmesh.split_sizes(n, strategy)  # validates the strategy name
        per = topk_ops.round_up(max(max(sizes), 1), row_multiple)
        n_valid = np.asarray(sizes, np.int32)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]
                                 ).astype(np.int32)
    _validate_layout(n, per, n_valid, offsets)
    data = [_block(corpus, int(off), int(nv), per, dev)
            for off, nv, dev in zip(offsets, n_valid, dmesh.devices)]
    return ShardedCorpus(data=data, n_valid=n_valid, offsets=offsets,
                         total=n)


def reshard(corpus: ShardedCorpus, dmesh: DeviceMesh) -> ShardedCorpus:
    """Re-shard onto a (possibly different-size) mesh. The rows are joined
    on the new mesh's first device, in global order, and split again: no
    host round trip, whichever layout the source has. Device LOSS goes
    through parallel/elastic.ElasticShardedIndex.heal, which rebuilds from
    its durability source (a lost shard cannot be read)."""
    rows = torch.cat([blk[:nv].to(dmesh.first)
                      for blk, nv in zip(corpus.data, corpus.n_valid)])
    return shard_corpus(rows, dmesh)
