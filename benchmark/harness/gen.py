"""The benchmark's data: seeded corpora and queries, made on a device.

`fold`, `generator`, `Gaussian`, `Clustered`, `LowRank`, `clustered`,
`low_rank`, `make_chunk`, `make_corpus`, `make_queries` and `perturbed` are
a frozen copy of the port's `scripts/common.py` (a test holds them to draw
the same rows as the originals): chunk i of a corpus comes from a
`torch.Generator` seeded by (seed, chunk), the stand-in for
`jax.random.fold_in(key, i)`, so chunk i is the same whenever and in
whatever order it is made. `UnitClustered` adds the smoke test's unit rows,
normalize(centre + spread * z) around centres uniform on the sphere.

`Data` turns a configuration's "data" block into a chunk maker and a query
maker; the harness, the program's build and the reference all draw from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# the streams of one seed: chunk i, query set t, perturbation r, the
# geometry's own draws, a warm-up batch
CHUNK, QUERIES, PERTURB, GEOMETRY, WARMUP = 1, 2, 3, 4, 5

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fold(seed: int, *path: int) -> int:
    """One generator seed for the stream `path` of `seed`."""
    s = int(seed)
    for p in path:
        s = (s * 1_000_003 + int(p) + 1) % (1 << 62)
    return s


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold(seed, *path))


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """N(0, 1) rows."""

    dim: int

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        return torch.randn((m, self.dim), generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True)
class Clustered:
    """centres[c] + sigma * N(0, 1), c uniform over the centres."""

    centres: torch.Tensor  # (n_centres, dim) fp32
    sigma: float

    @property
    def dim(self) -> int:
        return self.centres.shape[1]

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        idx = torch.randint(0, self.centres.shape[0], (m,), generator=gen,
                            device=gen.device)
        return self.centres[idx] + self.sigma * torch.randn(
            (m, self.dim), generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True)
class LowRank:
    """Rows near an r-dimensional subspace of R^dim: (z_c + sigma * N(0, 1))
    @ basis + jitter * N(0, 1), the subspace's centres z_c uniform (no
    centres: one Gaussian blob), as real text embeddings' spectra decay."""

    basis: torch.Tensor  # (r, dim) orthonormal rows
    centres: Optional[torch.Tensor]  # (n_centres, r) fp32
    sigma: float
    jitter: float = 0.02

    @property
    def dim(self) -> int:
        return self.basis.shape[1]

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        r = self.basis.shape[0]
        z = self.sigma * torch.randn((m, r), generator=gen, device=gen.device)
        if self.centres is not None:
            z = z + self.centres[torch.randint(
                0, self.centres.shape[0], (m,), generator=gen,
                device=gen.device)]
        return z @ self.basis + self.jitter * torch.randn(
            (m, self.dim), generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True)
class UnitClustered:
    """normalize(centres[c] + spread * N(0, 1)), c uniform, the centres
    uniform on the unit sphere (the smoke test's sentence-embedding rows)."""

    centres: torch.Tensor  # (n_centres, dim) fp32 unit rows
    spread: float

    @property
    def dim(self) -> int:
        return self.centres.shape[1]

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        idx = torch.randint(0, self.centres.shape[0], (m,), generator=gen,
                            device=gen.device)
        return torch.nn.functional.normalize(
            self.centres[idx] + self.spread * torch.randn(
                (m, self.dim), generator=gen, device=gen.device), dim=1)


def clustered(seed: int, n_centres: int, dim: int, sigma: float,
              device) -> Clustered:
    gen = generator(device, seed, GEOMETRY)
    return Clustered(torch.randn((n_centres, dim), generator=gen,
                                 device=gen.device), sigma)


def low_rank(seed: int, n_centres: int, dim: int, r: int, sigma: float,
             device) -> LowRank:
    """n_centres 0: no cluster structure; r is at most dim."""
    r = min(r, dim)
    gen = generator(device, seed, GEOMETRY)
    q, _ = torch.linalg.qr(torch.randn((dim, r), generator=gen,
                                       device=gen.device))
    centres = torch.randn((n_centres, r), generator=gen, device=gen.device) \
        if n_centres else None
    return LowRank(q.T.contiguous(), centres, sigma)


def unit_clustered(seed: int, n_centres: int, dim: int, spread: float,
                   device) -> UnitClustered:
    gen = generator(device, seed, GEOMETRY)
    return UnitClustered(torch.nn.functional.normalize(torch.randn(
        (n_centres, dim), generator=gen, device=gen.device), dim=1), spread)


def make_chunk(seed: int, i: int, rows: int, geometry, device) -> torch.Tensor:
    """Chunk i (rows, dim) bf16 of the corpus `seed` draws from `geometry`,
    on `device`."""
    return geometry.sample(generator(device, seed, CHUNK, i),
                           rows).to(torch.bfloat16)


def make_corpus(seed: int, n: int, geometry, device,
                n_chunks: int = 8) -> torch.Tensor:
    """The (n, dim) bf16 corpus of `n_chunks` chunks, written into one
    buffer."""
    if n % n_chunks:
        raise ValueError(f"n ({n}) must divide into {n_chunks} chunks")
    rows = n // n_chunks
    out = torch.empty((n, geometry.dim), dtype=torch.bfloat16, device=device)
    for i in range(n_chunks):
        out[i * rows:(i + 1) * rows] = make_chunk(seed, i, rows, geometry,
                                                  device)
    return out


def make_queries(seed: int, tag: int, batch: int, geometry,
                 device) -> torch.Tensor:
    """(batch, dim) fp32 queries from the same geometry, stream `tag`."""
    return geometry.sample(generator(device, seed, QUERIES, tag), batch)


def perturbed(queries: torch.Tensor, seed: int, reps: int,
              scale: float = 0.01) -> list:
    """`reps` distinct copies of the queries, each moved by scale * N(0, 1):
    every timed batch is new to the device."""
    return [queries + scale * torch.randn(
        queries.shape, generator=generator(queries.device, seed, PERTURB, r),
        device=queries.device) for r in range(reps)]


# --- a configuration's data ------------------------------------------------

def geometry_of(spec: dict, seed: int, dim: int, device):
    """The geometry a configuration's data block names, drawn from `seed`."""
    kind = spec["kind"]
    if kind == "unit_clustered":
        return unit_clustered(seed, spec["centres"], dim, spec["spread"],
                              device)
    if kind == "low_rank":
        return low_rank(seed, spec["centres"], dim, spec["rank"],
                        spec["sigma"], device)
    if kind == "clustered":
        return clustered(seed, spec["centres"], dim, spec["sigma"], device)
    if kind == "gaussian":
        return Gaussian(dim)
    raise ValueError(f"unknown geometry {kind!r}")


class Data:
    """A configuration's corpus and queries for one seed on one device.

    data block keys: rows, dim, chunks (rows divide into them), geometry
    ({"kind": ..., its sizes}), query_dtype ("float32", or "bfloat16": the
    queries are bf16 embeddings handed over as fp32 values, as the rows
    are)."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rows = int(spec["rows"])
        self.dim = int(spec["dim"])
        self.n_chunks = int(spec["chunks"])
        if self.rows % self.n_chunks:
            raise ValueError(f"rows ({self.rows}) must divide into "
                             f"{self.n_chunks} chunks")
        self.chunk_rows = self.rows // self.n_chunks
        self.geometry = geometry_of(spec["geometry"], self.seed, self.dim,
                                    self.device)
        self.query_dtype = DTYPES[spec.get("query_dtype", "float32")]

    def chunk(self, i: int) -> torch.Tensor:
        """Chunk i, (chunk_rows, dim) bf16 on the device."""
        return make_chunk(self.seed, i, self.chunk_rows, self.geometry,
                          self.device)

    def corpus(self) -> torch.Tensor:
        """The whole (rows, dim) bf16 corpus in one buffer."""
        return make_corpus(self.seed, self.rows, self.geometry, self.device,
                           self.n_chunks)

    def queries(self, tag: int, n: int) -> torch.Tensor:
        """(n, dim) fp32 queries of stream `tag`, in the configuration's
        query precision."""
        q = make_queries(self.seed, tag, n, self.geometry, self.device)
        return q.to(self.query_dtype).float()
