"""Host-side lexical retrieval: a real inverted-index BM25 engine.

VERDICT r4 #4: the hybrid stack's "lexical" legs were hashed TF-IDF
vectors pushed through the DENSE index path — no inverted index, no BM25
saturation, lexical quality bounded by hashing collisions. This module is
the real thing: an Okapi BM25 scorer over CSR postings, vectorized numpy
scoring (no per-document Python), live extend/delete, and a Retriever
duck-type adapter so it plugs into HybridRetriever and the serving
daemon unchanged.

Engine placement: lexical scoring is HOST work by design. The corpus
text lives on the host, postings are integer-sparse gathers and
scatters, and a query touches only the postings of its few terms: the
arithmetic intensity is ~0, so the card stays on the dense path while
BM25 runs concurrently on the host's cores (the fusion model —
rag/fusion.py).

Reference analogue: none — the reference retrieves from exactly one
dense index at a time (SURVEY.md §0); hybrid dense+lexical is
beyond-parity surface.

The port of the JAX package's `rag/lexical.py`: the same postings, scores,
tie order and `.npz` file (either package loads the other's). The native
scorers come from `cuvs_rag_tpu_torch.native`, whose build raises where it
fails; the numpy scorer runs where CUVS_RAG_TPU_BM25_NATIVE=0 turns native
off, and, as in the reference, while a small uncompacted delta (< 4,096
postings) is live, which the native scorers cannot see. `_bulk_add` skips
the tokenizer for empty texts, which have no tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from cuvs_rag_tpu_torch import native as native_mod
from cuvs_rag_tpu_torch.models.encoder import WORD_RE as _TOKEN_RE


def tokenize(text: str) -> List[str]:
    """Lowercase word tokens (the TfidfHashingEncoder convention, minus
    bigrams — BM25 is classically a unigram model; the regex is shared
    with models/encoder.py so the two can never desynchronize)."""
    return _TOKEN_RE.findall(text.lower())


@dataclasses.dataclass
class BM25Params:
    """Okapi BM25 constants (Robertson et al.): k1 saturates term
    frequency, b scales doc-length normalization.

    max_df_frac < 1 drops query terms whose document frequency exceeds
    that fraction of the corpus (classic stopword pruning): such terms
    carry near-zero idf but dominate postings-walk cost, while the
    ranking is driven by the informative terms anyway. 1.0 (default)
    scores every term."""

    k1: float = 1.2
    b: float = 0.75
    max_df_frac: float = 1.0


class BM25Index:
    """Inverted-index BM25 over CSR postings.

    Build once with `build(texts)`; search is vectorized numpy per query
    (gather the query terms' postings slices, one bincount scatter-add,
    one argpartition). Live mutation mirrors the dense families:
    `extend(texts)` appends documents into a small delta store that is
    compacted into the CSR automatically; `delete(ids)` tombstones.

    idf = ln(1 + (N - df + .5)/(df + .5)) is recomputed from df counts on
    demand, so extends keep scoring consistent. Deletes do NOT decrement
    df (standard practice — Lucene keeps deleted docs' stats until merge);
    the tombstone mask guarantees deleted ids never surface.
    """

    def __init__(self, params: Optional[BM25Params] = None):
        import threading

        self.params = params or BM25Params()
        self.vocab: Dict[str, int] = {}
        self.df = np.zeros((0,), np.int64)
        # CSR: postings of term t are docs/tfs[indptr[t]:indptr[t+1]]
        self.indptr = np.zeros((1,), np.int64)
        self.post_docs = np.zeros((0,), np.int64)
        self.post_tfs = np.zeros((0,), np.float32)
        self.doc_len = np.zeros((0,), np.float32)
        self.alive = np.zeros((0,), bool)
        # delta store for extend(): term id -> ([doc ids], [tfs]).
        # Concurrency contract (the serving daemon searches from several
        # threads while extend/delete mutate): every mutation is
        # copy-on-write (new arrays / new dict+lists, assigned under
        # _lock); search takes _lock only to snapshot references and
        # resolve query terms, then scores lock-free on the snapshot —
        # an in-flight search sees a consistent pre- or post-mutation
        # state, mirroring the dense families' index-swap-last contract.
        self._delta: Dict[int, List[List]] = {}
        self._delta_nnz = 0
        self._lock = threading.RLock()
        self.metric = "bm25"  # similarity: higher = better (fusion.py)

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, texts: Sequence[str],
              params: Optional[BM25Params] = None) -> "BM25Index":
        ix = cls(params)
        ix._bulk_add(texts)
        return ix

    def _bulk_add(self, texts: Sequence[str]) -> None:
        """Append `texts` as docs n..n+B-1 directly into a rebuilt CSR
        (build path and delta compaction share this via _rebuild)."""
        start = len(self.doc_len)
        term_ids: List[np.ndarray] = []
        term_tfs: List[np.ndarray] = []
        doc_of: List[int] = []  # the doc of each term_ids entry
        lens = np.zeros((len(texts),), np.float32)
        for i, t in enumerate(texts):
            if not t:
                continue  # no tokens, no postings: a million empty texts
                # (a corpus of vectors without passages) cost no tokenizer
            toks = tokenize(t)
            lens[i] = len(toks)
            counts: Dict[int, int] = {}
            for w in toks:
                tid = self.vocab.get(w)
                if tid is None:
                    tid = self.vocab[w] = len(self.vocab)
                counts[tid] = counts.get(tid, 0) + 1
            tids = np.fromiter(counts.keys(), np.int64, len(counts))
            doc_of.append(i)
            term_ids.append(tids)
            term_tfs.append(
                np.fromiter(counts.values(), np.float32, len(counts))
            )
        n_terms = len(self.vocab)
        # grow df
        df = np.zeros((n_terms,), np.int64)
        df[: len(self.df)] = self.df
        all_tids = (np.concatenate(term_ids)
                    if term_ids else np.zeros((0,), np.int64))
        np.add.at(df, all_tids, 1)
        self.df = df
        # rebuild the CSR from COO: old postings (term ids recovered from
        # the old indptr) + the new ones, lexsorted by (term, doc)
        old_tids = np.repeat(
            np.arange(len(self.indptr) - 1, dtype=np.int64),
            np.diff(self.indptr),
        )
        new_docs = np.repeat(
            start + np.asarray(doc_of, np.int64),
            np.asarray([len(t) for t in term_ids], np.int64),
        )
        new_tfs = (np.concatenate(term_tfs)
                   if term_tfs else np.zeros((0,), np.float32))
        coo_t = np.concatenate([old_tids, all_tids])
        coo_d = np.concatenate([self.post_docs, new_docs])
        coo_f = np.concatenate([self.post_tfs, new_tfs])
        order = np.lexsort((coo_d, coo_t))
        counts = np.bincount(coo_t, minlength=n_terms)
        indptr = np.zeros((n_terms + 1,), np.int64)
        np.cumsum(counts, out=indptr[1:])
        self.indptr = indptr
        self.post_docs = coo_d[order]
        self.post_tfs = coo_f[order]
        self.doc_len = np.concatenate([self.doc_len, lens])
        self.alive = np.concatenate(
            [self.alive, np.ones((len(texts),), bool)]
        )

    # -- mutation ---------------------------------------------------------

    def extend(self, texts: Sequence[str]) -> range:
        """Append docs live. New postings land in a delta store scored
        alongside the CSR; when the delta outgrows 25% of the CSR it is
        compacted (amortized O(nnz)). Copy-on-write: concurrent readers
        keep scoring their snapshot."""
        with self._lock:
            start = len(self.doc_len)
            lens = np.zeros((len(texts),), np.float32)
            new_delta = dict(self._delta)
            touched: set = set()
            per_doc_tids = []
            for i, t in enumerate(texts):
                toks = tokenize(t)
                lens[i] = len(toks)
                counts: Dict[int, int] = {}
                for w in toks:
                    tid = self.vocab.get(w)
                    if tid is None:
                        tid = self.vocab[w] = len(self.vocab)
                    counts[tid] = counts.get(tid, 0) + 1
                per_doc_tids.append(counts)
                for tid, c in counts.items():
                    slot = new_delta.get(tid)
                    if tid not in touched:
                        # copy-on-write: never append to a list a reader
                        # snapshot may be iterating
                        slot = ([list(slot[0]), list(slot[1])]
                                if slot else [[], []])
                        new_delta[tid] = slot
                        touched.add(tid)
                    slot[0].append(start + i)
                    slot[1].append(float(c))
                    self._delta_nnz += 1
            df = np.zeros((len(self.vocab),), np.int64)
            df[: len(self.df)] = self.df
            for counts in per_doc_tids:
                for tid in counts:
                    df[tid] += 1
            # assignment order is irrelevant to readers (they snapshot
            # under the lock), but keep arrays fully built before binding
            self.df = df
            self._delta = new_delta
            self.doc_len = np.concatenate([self.doc_len, lens])
            self.alive = np.concatenate(
                [self.alive, np.ones((len(texts),), bool)]
            )
            if self._delta_nnz > 0.25 * max(len(self.post_docs), 64):
                self._compact()
            return range(start, start + len(texts))

    def _compact(self) -> None:
        with self._lock:
            n_terms = len(self.vocab)
            counts = np.diff(self.indptr)
            counts = np.pad(counts, (0, n_terms - len(counts)))
            add = np.zeros((n_terms,), np.int64)
            for tid, (d, _) in self._delta.items():
                add[tid] = len(d)
            indptr = np.zeros((n_terms + 1,), np.int64)
            np.cumsum(counts + add, out=indptr[1:])
            docs = np.empty((int(indptr[-1]),), np.int64)
            tfs = np.empty((int(indptr[-1]),), np.float32)
            for tid in range(n_terms):
                s, e = indptr[tid], indptr[tid] + counts[tid]
                if tid < len(self.indptr) - 1:
                    os_, oe = self.indptr[tid], self.indptr[tid + 1]
                    docs[s:e] = self.post_docs[os_:oe]
                    tfs[s:e] = self.post_tfs[os_:oe]
                if add[tid]:
                    d, f = self._delta[tid]
                    docs[e:e + add[tid]] = d
                    tfs[e:e + add[tid]] = f
            self.indptr, self.post_docs, self.post_tfs = indptr, docs, tfs
            self._delta, self._delta_nnz = {}, 0

    def delete(self, ids) -> None:
        with self._lock:
            ids = np.asarray(ids, np.int64)
            if ids.size and (
                ids.min() < 0 or ids.max() >= len(self.doc_len)
            ):
                raise ValueError(
                    f"ids outside corpus [0, {len(self.doc_len)})"
                )
            alive = self.alive.copy()  # copy-on-write for lock-free readers
            alive[ids] = False
            self.alive = alive

    # -- persistence (warm restart, mirrors index/io.py for dense) --------

    def save(self, path: str) -> None:
        """One .npz file: CSR postings + stats + vocabulary (terms are
        newline-joined — tokens can't contain whitespace by construction
        of `tokenize`). Compacts the delta store first so the file is
        always a pure CSR."""
        with self._lock:
            self._save_locked(path)

    def _save_locked(self, path: str) -> None:
        self._compact()
        terms = [None] * len(self.vocab)
        for w, tid in self.vocab.items():
            terms[tid] = w
        np.savez(
            path,
            format=np.int64(1),
            k1=np.float32(self.params.k1),
            b=np.float32(self.params.b),
            max_df_frac=np.float32(self.params.max_df_frac),
            terms=np.frombuffer(
                "\n".join(terms).encode("utf-8"), dtype=np.uint8
            ),
            df=self.df,
            indptr=self.indptr,
            post_docs=self.post_docs,
            post_tfs=self.post_tfs,
            doc_len=self.doc_len,
            alive=self.alive,
        )

    @classmethod
    def load(cls, path: str) -> "BM25Index":
        with np.load(path) as z:
            if int(z["format"]) != 1:
                raise ValueError(f"unknown BM25 file format {z['format']}")
            ix = cls(BM25Params(
                k1=float(z["k1"]), b=float(z["b"]),
                max_df_frac=(float(z["max_df_frac"])
                             if "max_df_frac" in z else 1.0),
            ))
            blob = bytes(z["terms"].tobytes()).decode("utf-8")
            ix.vocab = ({w: i for i, w in enumerate(blob.split("\n"))}
                        if blob else {})
            ix.df = z["df"]
            ix.indptr = z["indptr"]
            ix.post_docs = z["post_docs"]
            ix.post_tfs = z["post_tfs"]
            ix.doc_len = z["doc_len"]
            ix.alive = z["alive"]
        return ix

    # -- search -----------------------------------------------------------

    @property
    def n_docs(self) -> int:
        return len(self.doc_len)

    def _idf(self, tids: np.ndarray) -> np.ndarray:
        n = float(len(self.doc_len))
        df = self.df[tids].astype(np.float64)
        return np.log1p((n - df + 0.5) / (df + 0.5)).astype(np.float32)

    def _tfmax(self) -> np.ndarray:
        """Per-term max tf over the CSR (for MaxScore upper bounds).
        Cached; invalidated by _compact/_bulk_add (which reassign
        self.indptr). Call only with an empty delta."""
        cached = getattr(self, "_tfmax_cache", None)
        if cached is not None and cached[0] is self.indptr:
            return cached[1]
        nt = len(self.indptr) - 1
        tfmax = np.zeros((nt,), np.float32)
        nonempty = np.flatnonzero(np.diff(self.indptr) > 0)
        if nonempty.size:
            # reduceat segments between consecutive non-empty starts span
            # exactly that term's postings (intervening terms are empty)
            tfmax[nonempty] = np.maximum.reduceat(
                self.post_tfs, self.indptr[:-1][nonempty]
            )
        self._tfmax_cache = (self.indptr, tfmax)
        return tfmax

    def _query_tids(self, q: str) -> np.ndarray:
        return self._tids_from_tokens(tokenize(q))

    def _tids_from_tokens(self, toks: List[str]) -> np.ndarray:
        """Vocab/df lookups only — callers tokenize OUTSIDE the writer
        lock (regex work must not serialize concurrent searches)."""
        tids = np.asarray(
            sorted({self.vocab[w] for w in toks if w in self.vocab}),
            np.int64,
        )
        frac = self.params.max_df_frac
        if frac < 1.0 and tids.size and len(self.doc_len):
            keep = self.df[tids] < frac * len(self.doc_len)
            if keep.any():  # never drop ALL terms of a query
                tids = tids[keep]
        return tids

    def search(
        self,
        queries: Sequence[str],
        k: int,
        allow: Optional[np.ndarray] = None,
    ) -> "tuple[np.ndarray, np.ndarray]":
        """Batch BM25 top-k. Returns (scores, ids), both (Q, k), ids = -1
        past the matched count, HIGHER score = better (a similarity — the
        opposite orientation from the dense families' distances; fusion
        handles both via the metric tag).

        Thread-safe vs concurrent extend/delete: state is snapshotted
        under the writer lock, then scored lock-free (mutations are
        copy-on-write). An `allow` mask sized for a different corpus
        generation is aligned to the snapshot — rows beyond its length
        are EXCLUDED (conservative: a filter can briefly hide rows added
        mid-flight, never leak them)."""
        import os as _os

        want_native = _os.environ.get(
            "CUVS_RAG_TPU_BM25_NATIVE", "1") != "0"
        toks_list = [tokenize(q) for q in queries]  # outside the lock
        with self._lock:
            # native scorers need a pure CSR; compact a LARGE delta here
            # (amortized), but keep small deltas on the numpy path so an
            # extend(1 doc) doesn't force an O(nnz) rebuild per search
            if want_native and self._delta_nnz >= 4096:
                self._compact()
            use_native = want_native and self._delta_nnz == 0
            indptr, post_docs = self.indptr, self.post_docs
            post_tfs, doc_len = self.post_tfs, self.doc_len
            alive, delta = self.alive, self._delta
            n = len(doc_len)
            k1, b = self.params.k1, self.params.b
            tid_parts, idf_parts, offsets = [], [], [0]
            for toks in toks_list:
                tids = self._tids_from_tokens(toks)
                tid_parts.append(tids)
                idf_parts.append(self._idf(tids))
                offsets.append(offsets[-1] + len(tids))
            tfmax = (self._tfmax() if use_native and n else None)
        avgdl = float(doc_len.mean()) if n else 1.0
        if allow is None:
            mask = alive
        else:
            a = np.asarray(allow, bool)
            if len(a) < n:
                a = np.concatenate([a, np.zeros((n - len(a),), bool)])
            mask = alive & a[:n]
        out_s = np.zeros((len(queries), k), np.float32)
        out_i = np.full((len(queries), k), -1, np.int64)
        norm_cache = 1.0 - b + b * doc_len / max(avgdl, 1e-9)

        if n and use_native:
            all_tids = (np.concatenate(tid_parts) if tid_parts
                        else np.zeros((0,), np.int64))
            all_idf = (np.concatenate(idf_parts) if idf_parts
                       else np.zeros((0,), np.float32))
            offs = np.asarray(offsets, np.int64)
            mask8 = mask.astype(np.uint8)
            nc32 = norm_cache.astype(np.float32)
            # each worker of the dense scorer holds an (n_docs,)
            # float buffer: cap the thread count so the buffers stay
            # under ~2 GB total (60M docs -> 8 threads x 240 MB)
            nthreads = min(
                _os.cpu_count() or 4,
                max(1, int(2e9 / max(n * 4, 1))),
            )
            # routing: DAAT MaxScore skips head-term postings but
            # pays a sort/probe overhead per pivot — worth it once
            # the batch would walk a lot of postings; the dense
            # accumulate scorer wins on small walks
            walk = int(
                (indptr[all_tids + 1] - indptr[all_tids]).sum()
            ) if all_tids.size else 0
            if walk > 200_000:
                tfm = tfmax[all_tids] if all_tids.size \
                    else np.zeros((0,), np.float32)
                min_norm = (float(nc32.min()) if len(nc32) else 1.0)
                bounds = np.where(
                    tfm > 0,
                    all_idf * tfm * (k1 + 1.0)
                    / (tfm + k1 * min_norm),
                    0.0,
                ).astype(np.float32)
                return native_mod.bm25_maxscore_topk(
                    indptr, post_docs, post_tfs,
                    nc32, k1, all_tids, all_idf, bounds, offs,
                    mask8, k, nthreads=nthreads,
                )
            return native_mod.bm25_score_topk(
                indptr, post_docs, post_tfs,
                nc32, k1, all_tids, all_idf, offs,
                mask8, k, nthreads=nthreads,
            )
        for qi in range(len(queries)):
            tids = tid_parts[qi]
            if tids.size == 0:
                continue
            idf = idf_parts[qi]
            scores = np.zeros((n,), np.float32)
            # CSR postings of the query's terms
            in_csr = tids[tids < len(indptr) - 1]
            if in_csr.size:
                starts, ends = indptr[in_csr], indptr[in_csr + 1]
                lens = ends - starts
                gather = np.repeat(
                    starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                    lens,
                ) + np.arange(int(lens.sum()))
                docs = post_docs[gather]
                tf = post_tfs[gather]
                idf_rep = np.repeat(
                    idf[np.searchsorted(tids, in_csr)], lens
                )
                contrib = idf_rep * tf * (k1 + 1.0) / (
                    tf + k1 * norm_cache[docs]
                )
                scores += np.bincount(
                    docs, weights=contrib, minlength=n
                ).astype(np.float32)[:n]
            # delta postings (recent extends, not yet compacted). The
            # snapshot dict's lists are immutable (extend copies on
            # write), so lock-free iteration is safe.
            for pos, tid in enumerate(tids):
                slot = delta.get(int(tid))
                if not slot:
                    continue
                d = np.asarray(slot[0], np.int64)
                tf = np.asarray(slot[1], np.float32)
                # a delta slot written after our snapshot of doc_len
                # could reference docs beyond n — not in this snapshot
                live_rows = d < n
                if not live_rows.all():
                    d, tf = d[live_rows], tf[live_rows]
                scores[d] += idf[pos] * tf * (k1 + 1.0) / (
                    tf + k1 * norm_cache[d]
                )
            scores[~mask] = -np.inf
            kk = min(k, n)
            # (score desc, doc id asc) — the same deterministic tie-break
            # as the native scorers, including at the rank-k boundary
            # (argpartition alone keeps an arbitrary member of a tie
            # straddling k). Full lexsort is fine on the fallback path.
            top = np.lexsort((np.arange(n), -scores))[:kk]
            good = scores[top] > 0
            top, sc = top[good], scores[top][good]
            out_i[qi, : len(top)] = top
            out_s[qi, : len(top)] = sc
        return out_s, out_i


class LexicalRetriever:
    """Retriever duck-type over a BM25Index + Corpus: plugs into
    HybridRetriever (rag/fusion.py) and the serving daemon's text path.
    Higher-is-better scores are reported in `RetrievedPassage.distance`
    with the engine tagged metric='bm25' so z-score fusion orients them
    correctly (fusion._engine_higher_better)."""

    params = None
    search_params = None
    family = "bm25"
    encoder = None  # text-native: no vector encoder
    dmesh = None

    def __init__(self, corpus, bm25: Optional[BM25Index] = None,
                 bm25_params: Optional[BM25Params] = None):
        self.corpus = corpus
        self.bm25 = bm25 or BM25Index.build(corpus.passages, bm25_params)
        self.metric = self.bm25.metric

    def retrieve(self, query: str, k: int = 5, allow=None):
        return self.retrieve_batch([query], k, allow=allow)[0]

    def retrieve_ids(self, queries: Sequence[str], k: int = 5, allow=None):
        """Raw-array retrieval (scores, ids) — the HybridRetriever hot
        path; scores are similarities (higher = better)."""
        return self.bm25.search(list(queries), k, allow=allow)

    def retrieve_batch(self, queries: Sequence[str], k: int = 5,
                       allow=None, *, index=None):
        from cuvs_rag_tpu_torch.rag.pipeline import (
            RetrievalResult,
            RetrievedPassage,
        )

        if index is not None:
            raise ValueError("LexicalRetriever has no alternate indexes")
        t0 = time.time()
        scores, ids = self.bm25.search(list(queries), k, allow=allow)
        per_q = (time.time() - t0) / max(len(queries), 1)
        out = []
        for qi in range(len(queries)):
            passages = [
                RetrievedPassage(
                    text=self.corpus.passages[j],
                    index=int(j),
                    distance=float(scores[qi, c]),
                    title=(self.corpus.titles[j]
                           if self.corpus.titles else None),
                )
                for c, j in enumerate(ids[qi])
                if j >= 0
            ]
            out.append(RetrievalResult(passages=passages,
                                       query_time_s=per_q))
        return out

    def extend(self, texts=None, *, vectors=None, titles=None) -> range:
        if texts is None:
            raise ValueError("LexicalRetriever.extend needs texts")
        if vectors is not None:
            raise ValueError(
                "LexicalRetriever indexes text, not vectors"
            )
        texts = list(texts)
        if titles is not None and len(titles) != len(texts):
            raise ValueError("titles must align with texts")
        # corpus FIRST, index LAST: BM25Index is safe for concurrent
        # search-during-extend, so the moment the new ids are searchable
        # their passages must already exist (mirrors the dense
        # Retriever.extend index-swap-last contract)
        start = len(self.corpus.passages)
        if titles is not None and self.corpus.titles is None:
            self.corpus.titles = [""] * len(self.corpus.passages)
        self.corpus.passages.extend(texts)
        if self.corpus.titles is not None:
            self.corpus.titles.extend(
                list(titles) if titles is not None else [""] * len(texts)
            )
        new_ids = self.bm25.extend(texts)
        if new_ids.start != start:
            raise RuntimeError(
                "lexical extend id drift: corpus and BM25 index disagree"
            )
        return new_ids

    def delete(self, ids) -> None:
        self.bm25.delete(ids)

    # -- persistence (mirrors rag/pipeline.Retriever.save/load) ----------

    def save(self, directory: str) -> None:
        import json
        import os

        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "corpus.jsonl"), "w") as f:
            for i, p in enumerate(self.corpus.passages):
                rec = {"text": p}
                if self.corpus.titles:
                    rec["title"] = self.corpus.titles[i]
                f.write(json.dumps(rec) + "\n")
        self.bm25.save(os.path.join(directory, "bm25.npz"))
        with open(os.path.join(directory, "retriever.json"), "w") as f:
            json.dump({"format": 1, "family": "bm25"}, f)

    @classmethod
    def load(cls, directory: str) -> "LexicalRetriever":
        import json
        import os

        from cuvs_rag_tpu_torch.rag.corpus import Corpus

        with open(os.path.join(directory, "retriever.json")) as f:
            meta = json.load(f)
        if meta.get("family") != "bm25":
            raise ValueError(f"not a lexical retriever dir: {meta}")
        passages, titles = [], []
        with open(os.path.join(directory, "corpus.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                passages.append(rec["text"])
                titles.append(rec.get("title", ""))
        if not any(titles):
            titles = None
        bm25 = BM25Index.load(os.path.join(directory, "bm25.npz"))
        return cls(Corpus(passages=passages, titles=titles), bm25=bm25)
