"""RAG retrieval pipeline: encode → search → assemble context.

The counterpart of the JAX package's `rag/pipeline.py` for the four index
families (flat, IVF-Flat, IVF-PQ, CAGRA) and three placements: query texts
are encoded on the index's device, the embeddings go to the family's
`search` without leaving it (through a filtered view when `allow=` is
given, or CAGRA's post-filter), and the returned ids become passages. An
IVF-PQ index without a raw store refines out of core, from the corpus'
embedding store on the host. placement="shard" splits the rows over a
parallel/mesh.DeviceMesh and "replicate" copies the index to every mesh
position (parallel/search.py); both encode an unembedded corpus with
`encode_sharded`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.index import io as index_io
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.rag import corpus as corpus_mod
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.host_store import MemmapStore
from cuvs_rag_tpu_torch.utils import config as config_mod
from cuvs_rag_tpu_torch.utils.metrics import default_registry as metrics

FAMILIES = psearch.FAMILIES
PLACEMENTS = ("single", "shard", "replicate")

_PARAM_CLASSES = (
    "FlatParams", "FlatSearchParams",
    "IVFFlatParams", "IVFFlatSearchParams",
    "IVFPQParams", "IVFPQSearchParams",
    "CagraParams", "CagraSearchParams",
)


def _params_to_meta(p):
    """Typed param dataclasses <-> JSON (Retriever.save/load)."""
    if p is None:
        return None
    return {"cls": type(p).__name__, "fields": dataclasses.asdict(p)}


def _params_from_meta(meta):
    if meta is None:
        return None
    # explicit allowlist: retriever.json is data, and resolving arbitrary
    # names via getattr would make every callable in utils.config reachable
    if meta["cls"] not in _PARAM_CLASSES:
        raise ValueError(f"unknown params class {meta['cls']!r}")
    return getattr(config_mod, meta["cls"])(**meta["fields"])


def _check(family: str, placement: str = "single") -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}")


def encode_sharded(encoder, texts: Sequence[str],
                   dmesh: Optional[DeviceMesh] = None, *,
                   batch_size: int = 256,
                   workers: Optional[int] = None) -> np.ndarray:
    """Data-parallel corpus encode for any encoder -> host fp32 (N, D).

    An encoder with its own `encode_sharded` (TorchSentenceEncoder,
    QwenEmbeddingEncoder) splits each batch over the mesh's positions.
    Any other encoder gets threads: `workers` (default the mesh size, else
    4) each encode a contiguous slice, joined in order; inputs no longer
    than one batch stay serial."""
    texts = list(texts)
    own = getattr(encoder, "encode_sharded", None)
    if own is not None:
        return np.asarray(own(texts, dmesh or DeviceMesh(),
                              batch_size=batch_size), np.float32)
    n_workers = workers or (dmesh.num_devices if dmesh is not None else 4)
    if n_workers <= 1 or len(texts) <= batch_size:
        return np.asarray(encoder.encode(texts, batch_size=batch_size),
                          np.float32)
    from concurrent.futures import ThreadPoolExecutor

    chunk = -(-len(texts) // n_workers)
    slices = [texts[i:i + chunk] for i in range(0, len(texts), chunk)]
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        parts = list(ex.map(
            lambda sl: np.asarray(encoder.encode(sl, batch_size=batch_size),
                                  np.float32), slices))
    return np.concatenate(parts, axis=0)


def _index_device(device, encoder, embeddings=None) -> torch.device:
    """Where the index lives: `device` if given, else a tensor's own device,
    else the encoder's `device`, else the card (`base.resolve_device`: an
    encoder without a device, such as the hashing encoder, says nothing
    about where to search). There is no fallback to the CPU: a caller that
    wants it says device="cpu"."""
    if device is None and not isinstance(embeddings, torch.Tensor):
        device = getattr(encoder, "device", None)
    return base.resolve_device(device, embeddings)


def encode_on_device(encoder, texts: List[str], device) -> torch.Tensor:
    """Query embeddings as a tensor on `device`. Encoders with
    `encode_device` (models.bert_encoder) keep them on their own device;
    numpy encoders (hashing, transformers) take one host -> device copy."""
    fn = getattr(encoder, "encode_device", None)
    if fn is not None:
        return fn(texts).to(device)
    return torch.as_tensor(encoder.encode(texts), device=device)


@dataclasses.dataclass
class RetrievedPassage:
    text: str
    index: int
    distance: float
    title: Optional[str] = None


@dataclasses.dataclass
class RetrievalResult:
    """Per-query retrieval output."""

    passages: List[RetrievedPassage]
    query_time_s: float


class Retriever:
    """encoder + index + passages. Build via `Retriever.build(...)`."""

    def __init__(self, encoder, index: Any, corpus: Corpus, *, family: str,
                 dmesh: Optional[DeviceMesh] = None,
                 search_params: Any = None, params: Any = None):
        self.encoder = encoder
        self.index = index
        self.corpus = corpus
        self.family = family
        self.dmesh = dmesh
        self.search_params = search_params
        # kept for what rebuilds: a sharded extend re-shards, and indexes
        # do not carry their build params
        self.params = params

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, corpus: Corpus, encoder, *, family: str = "flat",
              params: Any = None, placement: str = "single",
              dmesh: Optional[DeviceMesh] = None,
              search_params: Any = None, encode_batch_size: int = 64,
              device=None) -> "Retriever":
        """Build over `corpus`, encoding its passages when it carries no
        embeddings. Embeddings may be a numpy array (stored as fp32, as the
        JAX package does) or a tensor (kept in its own float dtype).

        placement "single": the index lives on `device`; None means the
        embeddings' own device for a tensor, else the encoder's `device`,
        else the card. "shard" / "replicate": the index spreads over
        `dmesh` (None: every visible card), and an unembedded corpus is
        encoded with `encode_sharded` over it."""
        _check(family, placement)
        if placement != "single":
            dmesh = dmesh or DeviceMesh()
        if corpus.embeddings is None:
            if placement == "single":
                corpus.embeddings = encoder.encode(
                    corpus.passages, batch_size=encode_batch_size)
            else:
                corpus.embeddings = encode_sharded(
                    encoder, corpus.passages, dmesh,
                    batch_size=max(encode_batch_size, 1))
        emb = corpus.embeddings
        if not isinstance(emb, torch.Tensor):
            # a host array, or a row store (rag/host_store.MemmapStore)
            # read whole, as the JAX package reads it
            emb = np.asarray(emb, dtype=np.float32)
        params = params if params is not None else _default_params(family)
        if placement == "shard":
            index = psearch.build_sharded(family, params, emb, dmesh)
        elif placement == "replicate":
            index = psearch.build_replicated(family, params, emb, dmesh)
        else:
            index = FAMILIES[family].build(
                params, emb, device=_index_device(device, encoder, emb))
        return cls(encoder, index, corpus, family=family, dmesh=dmesh,
                   search_params=search_params, params=params)

    # -- retrieval -------------------------------------------------------

    def retrieve(self, query: str, k: int = 5, allow=None) -> RetrievalResult:
        return self.retrieve_batch([query], k, allow=allow)[0]

    def retrieve_ids(self, queries: Sequence[str], k: int = 5, allow=None, *,
                     index=None):
        """Raw-array retrieval: (distances, ids) as (Q, k) numpy arrays with
        no passage assembly (what rag/fusion.HybridRetriever reads)."""
        dists, idx, _ = self._search_arrays(queries, k, allow, index)
        return dists, idx

    def retrieve_batch(self, queries: Sequence[str], k: int = 5,
                       allow=None, *, index=None) -> List[RetrievalResult]:
        """`allow` (optional): an (n_passages,) bool mask, numpy or tensor —
        metadata-filtered retrieval through a filtered view of the index
        (parallel/search.search). Results are always ⊆ allow.

        `index` (optional): search this index instead of `self.index`: a
        view of the same corpus baked beforehand (`parallel/search.view`),
        as the serving daemon's named views are, so a request pays no bake."""
        dists, idx, dt = self._search_arrays(queries, k, allow, index)
        results = []
        per_query = dt / max(len(queries), 1)
        for row in range(len(queries)):
            passages = [
                RetrievedPassage(
                    text=self.corpus.passages[j],
                    index=int(j),
                    distance=float(dists[row, c]),
                    title=self.corpus.titles[j] if self.corpus.titles else None,
                )
                for c, j in enumerate(idx[row])
                if j >= 0
            ]
            results.append(RetrievalResult(passages=passages,
                                            query_time_s=per_query))
        return results

    def _search_arrays(self, queries, k, allow=None, index=None):
        metrics.inc("retriever.queries", len(queries))
        t0 = time.perf_counter()
        base_index = self.index if index is None else index
        q = encode_on_device(self.encoder, list(queries), base_index.device)
        dists, idx = psearch.search(
            self.search_params, base_index, q, k, self.dmesh, allow=allow,
            **self._out_of_core_refine(FAMILIES[self.family]))
        if isinstance(dists, torch.Tensor):  # a host re-rank returns numpy
            dists, idx = dists.cpu().numpy(), idx.cpu().numpy()
        dt = time.perf_counter() - t0
        metrics.observe("retriever.batch_seconds", dt)
        return dists, idx, dt

    def _out_of_core_refine(self, mod) -> dict:
        """Search kwargs of the out-of-core refine: an IVF-PQ index that
        holds only codes (store_raw=False) re-ranks against the corpus'
        embedding store. A store with `fetch_rows` (MemmapStore) re-ranks
        on the host, so only candidate ids leave the device; a host array
        is sliced and re-ranked on the device. The family's default search
        params are resolved first, so the gate sees the refine_ratio the
        search will use."""
        sp = self.search_params or mod.default_search_params()
        emb = self.corpus.embeddings
        if (self.family != "ivf_pq" or self.index.has_raw or emb is None
                or getattr(sp, "refine_ratio", 0) <= 0):
            return {}
        if hasattr(emb, "fetch_rows"):
            return {"fetch_rows": emb.fetch_rows, "host_rerank": True}
        if isinstance(emb, torch.Tensor):
            return {"fetch_rows": lambda ids: emb[
                torch.from_numpy(ids).to(emb.device)].float().cpu().numpy()}
        emb = np.asarray(emb)
        return {"fetch_rows": lambda ids: emb[ids]}

    # -- persistence (warm restart) --------------------------------------

    def save(self, directory: str) -> None:
        """Index + corpus text/titles + embeddings + build/search params, in
        the JAX package's layout (either package loads the other's): a
        sharded index as index_part{i}.npz + index.json (io.save_sharded),
        a replicated one as its single index. A disk-backed embedding store
        (MemmapStore) is recorded by path, not copied."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "corpus.jsonl"), "w") as f:
            for i, p in enumerate(self.corpus.passages):
                rec = {"text": p}
                if self.corpus.titles:
                    rec["title"] = self.corpus.titles[i]
                f.write(json.dumps(rec) + "\n")
        emb, emb_meta = self.corpus.embeddings, None
        if emb is not None and hasattr(emb, "fetch_rows") \
                and hasattr(emb, "path"):
            emb_meta = {"kind": "memmap", "path": os.path.abspath(emb.path)}
        elif emb is not None:
            if isinstance(emb, torch.Tensor):
                emb = emb.float().cpu().numpy()
            corpus_mod.save_embeddings(
                os.path.join(directory, "embeddings"), np.asarray(emb)
            )
            emb_meta = {"kind": "npy"}
        if isinstance(self.index, psearch.ShardedIndex):
            placement = "shard"
            index_io.save_sharded(os.path.join(directory, "index"),
                                  self.index)
        elif isinstance(self.index, psearch.ReplicatedIndex):
            placement = "replicate"
            index_io.save_index(os.path.join(directory, "index.npz"),
                                self.index.index)
        else:
            placement = "single"
            index_io.save_index(os.path.join(directory, "index.npz"),
                                self.index)
        with open(os.path.join(directory, "retriever.json"), "w") as f:
            json.dump({
                "format": 1,
                "family": self.family,
                "placement": placement,
                "params": _params_to_meta(self.params),
                "search_params": _params_to_meta(self.search_params),
                "embeddings": emb_meta,
            }, f)

    @classmethod
    def load(cls, directory: str, encoder, *, device=None,
             dmesh: Optional[DeviceMesh] = None) -> "Retriever":
        """Restore a `save()`d retriever with a caller-supplied encoder. A
        single index goes onto `device` (None: the encoder's `device`, else
        the card); a sharded or replicated one onto `dmesh` (None: every
        visible card). A sharded index restores exactly on a mesh of its
        size and is REBUILT from its rows with the saved build params on
        another (io.load_sharded)."""
        with open(os.path.join(directory, "retriever.json")) as f:
            meta = json.load(f)
        placement = meta["placement"]
        _check(meta["family"], placement)
        passages, titles = [], []
        with open(os.path.join(directory, "corpus.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                passages.append(rec["text"])
                titles.append(rec.get("title", ""))
        if not any(titles):
            titles = None
        emb = None
        emb_meta = meta.get("embeddings")
        if emb_meta is not None and emb_meta["kind"] == "memmap":
            emb = MemmapStore.open(emb_meta["path"])
        elif emb_meta is not None:
            emb = corpus_mod.load_embeddings(os.path.join(directory, "embeddings"))
        params = _params_from_meta(meta["params"])
        if placement == "shard":
            dmesh = dmesh or DeviceMesh()
            index = index_io.load_sharded(os.path.join(directory, "index"),
                                          dmesh, params)
        elif placement == "replicate":
            dmesh = dmesh or DeviceMesh()
            ix = index_io.load_index(os.path.join(directory, "index.npz"),
                                     device=dmesh.first)
            index = psearch.ReplicatedIndex(
                replicas=psearch.replicate(ix, dmesh.devices),
                family=meta["family"])
        else:
            index = index_io.load_index(
                os.path.join(directory, "index.npz"),
                device=_index_device(device, encoder))
        return cls(
            encoder, index,
            Corpus(passages=passages, embeddings=emb, titles=titles),
            family=meta["family"], dmesh=dmesh,
            search_params=_params_from_meta(meta["search_params"]),
            params=params,
        )

    def extend(self, texts: Optional[Sequence[str]] = None, *, vectors=None,
               titles: Optional[Sequence[str]] = None) -> range:
        """Append passages; they get ids total..total+B-1, existing ids stay
        stable and prior deletions survive. Returns the new ids as a range.

        Provide `texts` (encoded with the retriever's encoder), or `vectors`
        (raw rows; `texts` then optionally supplies the aligned passages,
        else they default to "").
        """
        if texts is None and vectors is None:
            raise ValueError("provide texts and/or vectors")
        if texts is not None:
            texts = list(texts)
            if not texts or not all(isinstance(t, str) for t in texts):
                raise ValueError("texts must be a non-empty list of strings")
        if vectors is None:
            vectors = np.asarray(self.encoder.encode(texts), np.float32)
        vectors = base.as_tensor(vectors, self.index.device)
        if vectors.ndim != 2 or vectors.shape[0] == 0:
            raise ValueError(f"vectors must be (B, dim), got {tuple(vectors.shape)}")
        if texts is None:
            texts = [""] * len(vectors)
        if len(texts) != len(vectors):
            raise ValueError(
                f"texts ({len(texts)}) and vectors ({len(vectors)}) must be "
                "row-aligned"
            )
        if titles is not None and len(titles) != len(texts):
            raise ValueError("titles must align with texts")
        if hasattr(self.corpus.embeddings, "fetch_rows"):
            raise ValueError(
                "corpus embeddings live in a read-only host store "
                f"({type(self.corpus.embeddings).__name__}): rebuild the "
                "store with the new rows (MemmapStore.create/append_chunk), "
                "then rebuild the retriever")

        # Build the new index first: if it rejects the rows, the corpus must
        # not have grown. The index is swapped last, so a reader that sees
        # the new index finds the passages already appended.
        new_index = self._build_extended_index(vectors)
        start = len(self.corpus.passages)
        if titles is not None and self.corpus.titles is None:
            self.corpus.titles = [""] * start
        self.corpus.passages.extend(texts)
        if self.corpus.titles is not None:
            self.corpus.titles.extend(
                list(titles) if titles is not None else [""] * len(texts)
            )
        emb = self.corpus.embeddings
        if isinstance(emb, torch.Tensor):
            self.corpus.embeddings = torch.cat(
                [emb, vectors.to(emb.device, emb.dtype)], dim=0
            )
        elif emb is not None:
            self.corpus.embeddings = np.concatenate(
                [emb, vectors.float().cpu().numpy().astype(emb.dtype)], axis=0
            )
        self.index = new_index
        metrics.inc("retriever.extended_rows", len(texts))
        return range(start, start + len(texts))

    def _build_extended_index(self, vectors) -> Any:
        """The index-growth step of `extend`, without touching the corpus:
        rag/fusion.HybridRetriever grows engines that share one corpus
        object through it. As `extend`, it consumes `self.index` (an
        IVF-Flat layout may be grown in place): the caller swaps the result
        in. A sharded index re-shards and rebuilds with `self.params`
        (parallel/search.extend_sharded)."""
        vectors = base.as_tensor(vectors, self.index.device)
        if isinstance(self.index, psearch.ShardedIndex):
            if self.params is None:
                raise ValueError(
                    "sharded extend rebuilds the index and needs its build "
                    "params: build through Retriever.build (which keeps "
                    "them) or set retriever.params first")
            return psearch.extend_sharded(self.index, vectors, self.dmesh,
                                          self.params)
        if isinstance(self.index, psearch.ReplicatedIndex):
            return psearch.extend_replicated(self.index, vectors)
        return FAMILIES[self.family].extend(self.index, vectors)

    def delete(self, ids) -> None:
        """Remove passages by corpus index (tombstone; id-stable), in every
        placement."""
        if isinstance(self.index, psearch.ShardedIndex):
            self.index = psearch.delete_sharded(self.index, ids)
        elif isinstance(self.index, psearch.ReplicatedIndex):
            self.index = psearch.delete_replicated(self.index, ids)
        else:
            self.index = FAMILIES[self.family].delete(self.index, ids)

    def assemble_context(self, query: str, k: int = 5,
                         separator: str = "\n\n") -> str:
        """The RAG 'retrieve + assemble' step: top-k passages joined into a
        prompt context block."""
        res = self.retrieve(query, k)
        return separator.join(p.text for p in res.passages)


def _default_params(family: str):
    return {
        "flat": config_mod.FlatParams(),
        "ivf_flat": config_mod.IVFFlatParams(),
        "ivf_pq": config_mod.IVFPQParams(),
        "cagra": config_mod.CagraParams(),
    }[family]
