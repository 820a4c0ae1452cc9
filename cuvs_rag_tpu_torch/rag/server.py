"""Minimal production serving daemon — JSON-over-HTTP search service.

The reference stops at notebooks ("no serving daemon, no RPC", SURVEY.md §0);
this closes the deployment gap: a dependency-free stdlib HTTP server fronting
any retriever (text queries via the encoder) or raw-vector index, with
health, stats and metrics endpoints.

Concurrent requests are micro-batched: a flat search streams the whole
corpus once whatever its query count, so the service coalesces whatever
requests are waiting while a search is in flight into ONE batched search
(continuous batching — no added latency for a lone request, near-batched
throughput under load).

The port of the JAX package's `rag/server.py`: the same endpoints, request
and reply formats. Where it differs: a coalesced batch is searched at its
own query count and at max(k + |deny|) of its requests, with no padding to
a power of two (the reference padded both so that XLA compiled one program
per bucket; here a shape costs nothing to change); query tensors go to the
index's own device (a mesh's first, for a sharded or replicated index);
/healthz and /stats name every device of the index and the card.

Endpoints:
  POST /v1/search   {"texts": [...], "k": 5}            — encode + retrieve
                    {"vectors": [[...], ...], "k": 5}    — raw vector search
                    + optional "deny_ids": [...]         — per-request exact
                      exclusion (≤1024 ids; over-fetch k+|deny| then drop)
                    + optional "view": "name"            — search a named
                      persistent filter view (see /v1/views); combinable
                      with deny_ids
  POST /v1/views    {"name": ..., "allow_ids": [...]} or {"deny_ids": [...]}
                    — bake a persistent filtered VIEW once (FAISS
                    IDSelector-parity, index/filters.py: vector storage is
                    shared, one bookkeeping leaf changes); per-request
                    search overhead vs the base index is ~0 and the
                    1024-id deny cap does not apply. Multi-tenant: one
                    view per tenant, "view" per request.
  GET  /v1/views    list views; DELETE /v1/views/{name} drops one
  POST /v1/extend   {"texts": [...]} and/or {"vectors": [[...], ...]}
                    (+"titles") — append passages to the LIVE index without
                    a restart (FAISS add-flow at the serving layer). New
                    rows get ids corpus_size..corpus_size+B-1; named views
                    re-bake (allow-views exclude rows added after the view
                    was created; deny-views include them)
  POST /v1/delete   {"ids": [...]} — tombstone passages live; deleted ids
                    never return from any search or view, surviving ids
                    stay stable
  GET  /healthz     liveness + device check
  GET  /stats       index/corpus/device info (+ view count)
  GET  /metrics     metrics registry snapshot (see utils/metrics.py)

Run:  python -m cuvs_rag_tpu_torch.rag.server --port 8080   (demo corpus,
      on the card; --device cpu asks for the CPU)
"""

from __future__ import annotations

import json
import platform
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

import torch

from cuvs_rag_tpu_torch.utils.metrics import default_registry as metrics


class ServerStalledError(RuntimeError):
    """Every dispatcher has been stuck in one device call past the stall
    budget (a wedged device, not ordinary load): new work is refused
    fast with a 503 instead of queuing behind a dispatch that may never
    return (VERDICT r4 #7 — queue collapse under a hung device)."""


class MicroBatcher:
    """Coalesce concurrent submissions into one batched callable invocation.

    Continuous batching with pipelining: `pipeline_depth` dispatcher
    threads each pick up whatever requests are queued and run them as one
    batch. An idle dispatcher takes a lone request immediately (idle
    latency = single-dispatch latency); once all dispatchers are in
    flight, arrivals coalesce into the next free dispatcher's batch.
    Depth > 1 lets one batch's host work (encoding, passage assembly,
    the device -> host copy of its results) overlap another batch's
    search, while batching still caps the number of searches.
    An optional `window_s` sleep after wakeup trades a fixed latency bump
    for larger batches (off by default).

    `run_batch(items) -> results` must return one result per item, in
    order. An exception in run_batch is re-raised in EVERY waiting
    submitter of that batch — validate per-item inputs before submit().
    """

    def __init__(self, run_batch, max_items: int = 256,
                 window_s: float = 0.0, name: str = "batch",
                 pipeline_depth: int = 4, stall_s: float = 60.0):
        self._run = run_batch
        self._max = max_items
        self._window = window_s
        self._name = name
        self._stall_s = stall_s
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        # dispatcher index -> wall time its current run_batch started;
        # the stall watchdog reads this in submit()
        self._busy_since: dict = {}
        self._closed = False
        self._threads = [
            threading.Thread(
                target=self._loop, daemon=True, name=f"microbatch-{name}-{i}"
            )
            for i in range(max(1, pipeline_depth))
        ]
        for t in self._threads:
            t.start()

    def submit(self, item, timeout: float = 120.0):
        slot = {"item": item, "done": threading.Event(),
                "result": None, "error": None, "dead": False}
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            # stall watchdog: refuse fast when EVERY dispatcher has been
            # inside one run_batch longer than the stall budget — the
            # device is wedged and queued work would only pile up behind
            # it (each submitter holding an HTTP thread for its full
            # timeout). Ordinary load never trips this: a healthy
            # dispatch finishes in ms-to-seconds, resetting its entry.
            if len(self._busy_since) >= len(self._threads):
                now = time.time()
                # EVERY dispatcher stuck past the budget <=> even the
                # NEWEST dispatch started > stall_s ago (min() here would
                # trip on one wedged thread while the others drain fine)
                newest = max(self._busy_since.values())
                if now - newest > self._stall_s:
                    metrics.inc(f"server.stalled_rejects.{self._name}")
                    raise ServerStalledError(
                        f"all {len(self._threads)} dispatchers stuck in a "
                        f"device call for > {self._stall_s:.0f}s — device "
                        "wedged; retry later"
                    )
            self._queue.append(slot)
            self._cv.notify()
        if not slot["done"].wait(timeout):
            # Mark the slot cancelled so a dispatcher assembling a later
            # batch skips it instead of spending a device dispatch on work
            # nobody will read. Under the cv so the check in _loop is atomic
            # with batch assembly.
            with self._cv:
                slot["dead"] = True
            raise TimeoutError(f"micro-batch {self._name} dispatch timed out")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def _loop(self):
        import time

        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
            if self._window > 0:
                time.sleep(self._window)
            with self._cv:
                batch = [s for s in self._queue[: self._max] if not s["dead"]]
                del self._queue[: self._max]
            if not batch:
                continue
            metrics.observe(f"server.microbatch_size.{self._name}",
                            float(len(batch)))
            me = threading.get_ident()
            with self._cv:
                self._busy_since[me] = time.time()
            try:
                results = self._run([s["item"] for s in batch])
                for s, r in zip(batch, results):
                    s["result"] = r
            except Exception as e:  # noqa: BLE001 — delivered to submitters
                for s in batch:
                    s["error"] = e
            finally:
                with self._cv:
                    self._busy_since.pop(me, None)
            for s in batch:
                s["done"].set()


class SearchService:
    """Wraps a Retriever for the HTTP layer; thread-safe (the kernels'
    launches are, and index swaps are plain reference assignments).

    micro_batch=True routes text and vector searches through MicroBatchers
    so concurrent HTTP requests share one device dispatch: requests are
    concatenated along the query axis, searched once at max(k) over the
    batch, and each reply sliced back out (top-k at smaller k is a prefix
    of top-k at larger k, so slicing is exact).
    """

    MAX_VIEWS = 64

    def __init__(self, retriever, micro_batch: bool = True,
                 max_batch: int = 256, window_s: float = 0.0,
                 pipeline_depth: int = 4, stall_s: float = 60.0):
        self.retriever = retriever
        self.dim = self._index_dim(retriever)
        # name -> immutable view entry {"kind": "index"|"mask", "obj", ...}
        # Entries are resolved at submit() time and carried INTO the batch
        # items, so a concurrent DELETE can never fail an in-flight search.
        self._views: dict = {}
        self._views_lock = threading.Lock()
        # serializes corpus mutations (extend/delete): the index swap is an
        # atomic reference replace — in-flight batches keep searching the
        # snapshot they resolved at submit time
        self._update_lock = threading.Lock()
        self._text_batcher = None
        self._vec_batcher = None
        if micro_batch:
            self._text_batcher = MicroBatcher(
                self._run_texts, max_items=max_batch, window_s=window_s,
                name="texts", pipeline_depth=pipeline_depth,
                stall_s=stall_s,
            )
            self._vec_batcher = MicroBatcher(
                self._run_vectors, max_items=max_batch, window_s=window_s,
                name="vectors", pipeline_depth=pipeline_depth,
                stall_s=stall_s,
            )

    @staticmethod
    def _index_dim(r):
        emb = getattr(r.corpus, "embeddings", None)
        if emb is not None:
            return int(emb.shape[1])
        return getattr(r.encoder, "dim", None)

    def close(self):
        for b in (self._text_batcher, self._vec_batcher):
            if b is not None:
                b.close()

    # -- batched runners (one device dispatch per coalesced batch) --------

    @staticmethod
    def _by_view(items):
        """Group batch item indices by their (submit-time-resolved) view
        entry. Viewless traffic stays ONE group = one device dispatch;
        mixed-view batches dispatch once per distinct view."""
        groups: dict = {}
        for pos, it in enumerate(items):
            groups.setdefault(id(it[3]) if it[3] is not None else None,
                              []).append(pos)
        return groups

    def _run_texts(self, items):
        """items: [(texts, k, deny, view_entry)]; one retrieve_batch per
        distinct view at max(k + |deny|), sliced back. Per-request deny
        lists are EXACT by over-fetch: at most |deny| of the k + |deny|
        fetched candidates can be denied, so k always survive (or the
        corpus ran out)."""
        out = [None] * len(items)
        for positions in self._by_view(items).values():
            sub = [items[p] for p in positions]
            entry = sub[0][3]
            kmax = max(k + len(deny) for _, k, deny, _ in sub)
            flat: list[str] = []
            for texts, _, _, _ in sub:
                flat.extend(texts)
            kwargs = {}
            if entry is not None:
                if entry["kind"] == "index":
                    kwargs["index"] = entry["obj"]
                else:  # post-filter family (cagra): mask rides allow=
                    kwargs["allow"] = entry["obj"]
            results = self.retriever.retrieve_batch(flat, kmax, **kwargs)
            off = 0
            for pos, (texts, k, deny, _) in zip(positions, sub):
                rs = results[off:off + len(texts)]
                off += len(texts)
                out[pos] = [
                    {
                        "passages": [
                            {"text": p.text, "index": p.index,
                             "distance": p.distance, "title": p.title}
                            for p in r.passages if p.index not in deny
                        ][:k],
                        "query_time_s": r.query_time_s,
                    }
                    for r in rs
                ]
        return out

    def _search_one_index(self, index, q, kmax, allow=None):
        """A raw-vector search of `index`, in any placement; `allow` is the
        mask of a post-filter family (cagra)."""
        from cuvs_rag_tpu_torch.parallel import search as psearch

        r = self.retriever
        return psearch.search(r.search_params, index, q, kmax, r.dmesh,
                              allow=allow)

    def _run_vectors(self, items):
        """items: [(q_array, k, deny, view_entry)]; one search per distinct
        view at max(k + |deny|), sliced back (see _run_texts)."""
        out = [None] * len(items)
        for positions in self._by_view(items).values():
            sub = [items[p] for p in positions]
            entry = sub[0][3]
            kmax = max(k + len(deny) for _, k, deny, _ in sub)
            qh = np.concatenate([v for v, _, _, _ in sub], axis=0)
            index, allow = self.retriever.index, None
            if entry is not None:
                if entry["kind"] == "index":
                    index = entry["obj"]
                else:
                    allow = entry["obj"]
            q = torch.from_numpy(qh).to(index.device)
            d, i = self._search_one_index(index, q, kmax, allow=allow)
            d, i = _host(d), _host(i)
            off = 0
            for pos, (v, k, deny, _) in zip(positions, sub):
                n = len(v)
                dd, ii = d[off:off + n], i[off:off + n]
                if deny:
                    keep = ~np.isin(ii, list(deny))
                    # stable left-compaction of surviving candidates per row
                    order = np.argsort(~keep, axis=1, kind="stable")
                    ks = np.take_along_axis(keep, order, 1)
                    dd = np.where(
                        ks, np.take_along_axis(dd, order, 1), np.inf
                    )
                    ii = np.where(ks, np.take_along_axis(ii, order, 1), -1)
                out[pos] = {
                    "distances": dd[:, :k].tolist(),
                    "indices": ii[:, :k].tolist(),
                }
                off += n
        return out

    # -- per-request entry points ------------------------------------------

    # Bound per-request deny lists: the batch over-fetches k + |deny|, so
    # an unbounded list would let one request inflate every co-batched
    # request's device work. Persistent/large filters belong in a filtered
    # VIEW (index/filters.py) baked into the Retriever instead.
    MAX_DENY = 1024

    def _check_deny(self, deny_ids) -> frozenset:
        # Strict validation (a malformed filter silently no-op'ing is
        # worse than a 400), delegated to _validate_ids — one policy for
        # every id-list endpoint. The cap is checked FIRST on the raw
        # length so a huge list is rejected before any per-element work.
        ids = list(deny_ids or ())
        if not ids:
            return frozenset()
        if len(ids) > self.MAX_DENY:
            raise ValueError(
                f"deny_ids is capped at {self.MAX_DENY} per request; bake "
                "larger/persistent filters into a filtered view "
                "(index/filters.py)"
            )
        return frozenset(
            self._validate_ids(ids, len(self.retriever.corpus)).tolist()
        )

    def _check_k_budget(self, k: int, n_deny: int, entry) -> None:
        """Reject, BEFORE submit(), any request whose over-fetched device
        k would raise inside the batch runner (a bad item reaching the
        runner fails every co-batched request — MicroBatcher contract).
        Only cagra's mask-kind view path has a hard candidate cap: the
        post-filter masks AFTER the beam, so the device k (k + |deny|)
        must stay within
        itopk_size (index/filters.py raises past it). Unfiltered cagra
        has no cap — the beam widens to max(itopk, k). Mask-kind entries
        on hybrid/lexical retrievers (which pre-filter via allow=) have
        no cap either."""
        if entry is None or entry.get("kind") != "mask":
            return
        if getattr(self.retriever, "family", None) != "cagra":
            return
        sp = self.retriever.search_params
        if sp is None:
            from cuvs_rag_tpu_torch.index import cagra as cagra_mod

            sp = cagra_mod.default_search_params()
        cap = sp.itopk_size
        kmax = k + n_deny
        if kmax > cap:
            raise ValueError(
                f"cagra serves k + |deny_ids| = {kmax}, beyond "
                f"itopk_size={cap} — lower k or deny_ids, raise "
                "CagraSearchParams.itopk_size, or bake the filter into a "
                "named view"
            )

    # -- named persistent filter views (VERDICT r3 #5) ---------------------

    def _resolve_view(self, view):
        if view is None:
            return None
        if not isinstance(view, str):
            raise ValueError(f"view must be a string name, got {view!r}")
        with self._views_lock:
            entry = self._views.get(view)
        if entry is None:
            raise ValueError(f"unknown view {view!r} — POST /v1/views first")
        return entry

    def create_view(self, name, allow_ids=None, deny_ids=None) -> dict:
        """Bake a persistent filtered view. Exactly one of allow_ids /
        deny_ids. No size cap: the view is built ONCE (a (n,) bool mask +
        one bookkeeping leaf; vector storage is shared), so searches
        against it cost the same as the unfiltered index. Multi-engine
        (hybrid) and lexical retrievers get mask-kind views: the mask
        rides allow= into every engine at search time."""
        if not isinstance(name, str) or not name or len(name) > 64 or \
                not all(c.isalnum() or c in "_.-" for c in name):
            raise ValueError(
                "view name must be 1-64 chars of [A-Za-z0-9_.-]"
            )
        if (allow_ids is None) == (deny_ids is None):
            raise ValueError("provide exactly one of allow_ids / deny_ids")
        is_allow = allow_ids is not None
        # serialize with extend/delete: the mask must be sized to — and the
        # bake run against — one consistent corpus snapshot, or a racing
        # index swap could persist a stale/short-mask bake that misses the
        # mutation's re-bake snapshot
        with self._update_lock:
            n = len(self.retriever.corpus)
            idx = self._validate_ids(allow_ids if is_allow else deny_ids, n)
            mask = np.full((n,), not is_allow, bool)
            mask[idx] = is_allow
            if not mask.any():
                raise ValueError("view would allow zero passages")
            with self._views_lock:
                exists = name in self._views
                if not exists and len(self._views) >= self.MAX_VIEWS:
                    raise ValueError(
                        f"view limit {self.MAX_VIEWS} reached — DELETE "
                        "unused views first"
                    )
            t0 = time.perf_counter()
            entry = dict(self._bake_view(mask))
            entry.update(
                allowed=int(mask.sum()),
                build_ms=round((time.perf_counter() - t0) * 1e3, 1),
                # retained so corpus mutations can re-bake: on extend the
                # mask grows (allow-view: new rows excluded; deny: included)
                mask=mask,
                is_allow=is_allow,
            )
            with self._views_lock:
                self._views[name] = entry
        metrics.inc("server.views_created")
        return {"name": name, "allowed": entry["allowed"],
                "build_ms": entry["build_ms"], "replaced": exists}

    def _bake_view(self, mask):
        from cuvs_rag_tpu_torch.parallel import search as psearch

        r = self.retriever
        if not hasattr(r, "index") or getattr(r, "family", None) in (
            "cagra", "hybrid", "bm25",
        ):
            # mask-kind view: cagra post-filters after the beam; hybrid and
            # lexical retrievers pre-filter every engine via allow= — in
            # all three cases the mask rides allow= at search time
            return {"kind": "mask", "obj": mask}
        return {"kind": "index",
                "obj": psearch.view(r.index, mask)}

    def drop_view(self, name: str) -> bool:
        with self._views_lock:
            return self._views.pop(name, None) is not None

    def list_views(self) -> dict:
        with self._views_lock:
            return {
                nm: {"allowed": e["allowed"], "kind": e["kind"],
                     "build_ms": e["build_ms"]}
                for nm, e in self._views.items()
            }

    @staticmethod
    def _validate_ids(ids, n_corpus) -> np.ndarray:
        out = []
        for x in (ids or ()):
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                raise ValueError(f"ids must be integers, got {x!r}")
            if isinstance(x, float) and not x.is_integer():
                raise ValueError(f"ids must be integral, got {x!r}")
            xi = int(x)
            if not 0 <= xi < n_corpus:
                raise ValueError(
                    f"id {xi} outside corpus [0, {n_corpus})"
                )
            out.append(xi)
        if not out:
            raise ValueError("id list must be non-empty")
        return np.asarray(out, np.int64)

    def search_texts(self, texts, k: int, deny_ids=(), view=None):
        # Validate BEFORE submit(): a bad item reaching the batch runner
        # fails every co-batched request (MicroBatcher contract).
        texts = list(texts)
        if not texts:
            raise ValueError("texts must be a non-empty list")
        if not all(isinstance(t, str) for t in texts):
            raise ValueError("texts must all be strings")
        deny = self._check_deny(deny_ids)
        entry = self._resolve_view(view)
        self._check_k_budget(k, len(deny), entry)
        with metrics.time_block("server.search_texts_seconds"):
            if self._text_batcher is not None:
                return self._text_batcher.submit((texts, k, deny, entry))
            return self._run_texts([(texts, k, deny, entry)])[0]

    def _require_single_engine(self, op: str) -> None:
        """Multi-engine (hybrid) and text-native (lexical) retrievers have
        no single `.index`/vector space: raw VECTOR search is rejected
        with a 400 instead of an opaque AttributeError deep in a batch
        runner. (Text search, views, extend and delete all serve hybrid —
        VERDICT r4 #4.)"""
        if not hasattr(self.retriever, "index"):
            raise ValueError(
                f"{op} requires a single-engine retriever; this service "
                "wraps a multi-engine/lexical retriever — use text "
                "search, views, extend or delete"
            )

    def search_vectors(self, vectors, k: int, deny_ids=(), view=None):
        self._require_single_engine("vector search")
        q = np.asarray(vectors, np.float32)
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(
                f"vectors must be a non-empty 2D array, got shape {q.shape}"
            )
        if self.dim is not None and q.shape[1] != self.dim:
            raise ValueError(
                f"vector dim {q.shape[1]} != index dim {self.dim}"
            )
        deny = self._check_deny(deny_ids)
        entry = self._resolve_view(view)
        self._check_k_budget(k, len(deny), entry)
        with metrics.time_block("server.search_vectors_seconds"):
            if self._vec_batcher is not None:
                return self._vec_batcher.submit((q, k, deny, entry))
            return self._run_vectors([(q, k, deny, entry)])[0]

    # -- live corpus mutation (no-restart extend/delete) --------------------
    #
    # The reference rebuilt its indexes every run (SURVEY.md §5 "no ANN-index
    # serialization") and had no serving at all; FAISS serving deployments
    # add/remove while live. Updates serialize on _update_lock; each one
    # swaps self.retriever.index by plain reference assignment, so searches
    # already dispatched keep their snapshot and new submissions see the new
    # index — no read lock on the hot path. Named views are re-baked from
    # their retained masks against the post-update index (a baked view
    # shares the OLD index's bookkeeping, so without the re-bake a deleted
    # row could resurface through a stale view).

    def extend_corpus(self, texts=None, vectors=None, titles=None) -> dict:
        """Append passages/vectors to the live index (POST /v1/extend).
        Multi-engine/lexical retrievers take texts only (each engine
        encodes/tokenizes its own)."""
        if vectors is not None and not hasattr(self.retriever, "index"):
            raise ValueError(
                "this service wraps a multi-engine/lexical retriever — "
                "extend with texts (each engine encodes its own)"
            )
        if vectors is not None:
            vectors = np.asarray(vectors, np.float32)
            if vectors.ndim != 2 or vectors.shape[0] == 0:
                raise ValueError(
                    f"vectors must be a non-empty 2D array, got "
                    f"{vectors.shape}"
                )
            if self.dim is not None and vectors.shape[1] != self.dim:
                raise ValueError(
                    f"vector dim {vectors.shape[1]} != index dim {self.dim}"
                )
        with self._update_lock:
            t0 = time.perf_counter()
            new_ids = self.retriever.extend(
                texts, vectors=vectors, titles=titles
            )
            self._rebake_views()
            metrics.inc("server.extended_rows", len(new_ids))
            return {
                "added": len(new_ids),
                "ids": [new_ids.start, new_ids.stop],
                "corpus_size": len(self.retriever.corpus),
                "update_ms": round((time.perf_counter() - t0) * 1e3, 1),
            }

    def delete_ids(self, ids) -> dict:
        """Tombstone passages by id on the live index (POST /v1/delete).
        Ids never come back from any search (views included); surviving
        ids stay stable."""
        idx = self._validate_ids(ids, len(self.retriever.corpus))
        with self._update_lock:
            t0 = time.perf_counter()
            self.retriever.delete(idx)
            self._rebake_views()
            metrics.inc("server.deleted_rows", len(idx))
            return {
                "deleted": len(set(idx.tolist())),
                "update_ms": round((time.perf_counter() - t0) * 1e3, 1),
            }

    def _rebake_views(self):
        """Re-bake every named view against the CURRENT index, growing
        retained masks to the current corpus size (allow-views exclude
        rows added later; deny-views include them). Called under
        _update_lock; the per-name swap is atomic under _views_lock."""
        with self._views_lock:
            names = list(self._views.items())
        n = len(self.retriever.corpus)
        for name, old in names:
            mask = old["mask"]
            if len(mask) < n:
                grown = np.full((n,), not old["is_allow"], bool)
                grown[: len(mask)] = mask
                mask = grown
            entry = dict(self._bake_view(mask))
            entry.update(
                allowed=int(mask.sum()), build_ms=old["build_ms"],
                mask=mask, is_allow=old["is_allow"],
            )
            with self._views_lock:
                # a concurrent DELETE of this view wins: don't resurrect
                if name in self._views:
                    self._views[name] = entry

    def device(self) -> dict:
        """Where the searches run: the (first dense) index's device (a
        mesh's first, where the candidates merge) and the card's name; the
        host for a lexical-only retriever."""
        dev = _service_devices(self.retriever)[0]
        if dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
        else:
            name = platform.processor() or platform.machine() or "cpu"
        return {"device": str(dev), "device_name": name}

    def stats(self):
        r = self.retriever
        with self._views_lock:
            n_views = len(self._views)
        out = {
            "family": getattr(r, "family", "unknown"),
            "corpus_size": len(r.corpus),
            "devices": [str(d) for d in _service_devices(r)],
            **self.device(),
            "placement": type(getattr(r, "index", r)).__name__,
            "views": n_views,
        }
        engines = getattr(r, "retrievers", None)
        if engines is not None:
            out["engines"] = [getattr(e, "family", "?") for e in engines]
        return out


def _service_devices(r) -> list:
    """The (first dense) index's devices: every mesh position of a sharded
    or replicated index, else its one device; the host for a lexical-only
    retriever."""
    for e in getattr(r, "retrievers", [r]):
        ix = getattr(e, "index", None)
        if ix is not None:
            return list(getattr(ix, "devices", [ix.device]))
    return [torch.device("cpu")]


def _host(x) -> np.ndarray:
    """A search output as a host array (a host re-rank already is one)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: clients reuse connections instead of paying
        # a TCP handshake per query (Content-Length is always sent)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to metrics, not stderr
            metrics.inc("server.requests")

        def _reply(self, code: int, payload: Any):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    self._reply(200, {
                        "status": "ok",
                        "devices": len(_service_devices(service.retriever)),
                        **service.device()})
                elif self.path == "/stats":
                    self._reply(200, service.stats())
                elif self.path == "/metrics":
                    self._reply(200, metrics.snapshot())
                elif self.path == "/v1/views":
                    self._reply(200, {"views": service.list_views()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001
                metrics.inc("server.errors")
                self._reply(500, {"error": str(e)})

        def do_DELETE(self):
            try:
                if self.path.startswith("/v1/views/"):
                    name = self.path[len("/v1/views/"):]
                    if service.drop_view(name):
                        self._reply(200, {"deleted": name})
                    else:
                        self._reply(404, {"error": f"unknown view {name!r}"})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001
                metrics.inc("server.errors")
                self._reply(500, {"error": str(e)})

        def do_POST(self):
            try:
                # Drain the body FIRST, on every POST path: under HTTP/1.1
                # keep-alive, replying without consuming Content-Length
                # bytes desyncs the connection (the next request would be
                # parsed from body garbage).
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path == "/v1/views":
                    req = json.loads(raw or b"{}")
                    self._reply(200, service.create_view(
                        req.get("name"),
                        allow_ids=req.get("allow_ids"),
                        deny_ids=req.get("deny_ids"),
                    ))
                    return
                if self.path == "/v1/extend":
                    req = json.loads(raw or b"{}")
                    if "texts" not in req and "vectors" not in req:
                        self._reply(
                            400, {"error": "provide 'texts' and/or 'vectors'"}
                        )
                        return
                    self._reply(200, service.extend_corpus(
                        texts=req.get("texts"),
                        vectors=req.get("vectors"),
                        titles=req.get("titles"),
                    ))
                    return
                if self.path == "/v1/delete":
                    req = json.loads(raw or b"{}")
                    self._reply(200, service.delete_ids(req.get("ids")))
                    return
                if self.path != "/v1/search":
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                req = json.loads(raw or b"{}")
                k = int(req.get("k", 10))
                if k <= 0:
                    self._reply(400, {"error": "k must be positive"})
                    return
                deny = req.get("deny_ids", ())
                view = req.get("view")
                if "texts" in req:
                    if not req["texts"]:
                        self._reply(400, {"error": "texts must be non-empty"})
                        return
                    self._reply(200, {"results": service.search_texts(
                        req["texts"], k, deny_ids=deny, view=view)})
                elif "vectors" in req:
                    self._reply(200, service.search_vectors(
                        req["vectors"], k, deny_ids=deny, view=view))
                else:
                    self._reply(400, {"error": "provide 'texts' or 'vectors'"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                metrics.inc("server.errors")
                self._reply(400, {"error": str(e)})
            except (TimeoutError, ServerStalledError) as e:
                # hung/wedged device: degrade to 503 (retryable) instead
                # of a generic 500 — load balancers understand the former
                metrics.inc("server.unavailable")
                self._reply(503, {"error": str(e), "retry": True})
            except Exception as e:  # noqa: BLE001
                metrics.inc("server.errors")
                self._reply(500, {"error": str(e)})

    return Handler


def serve(
    retriever,
    host: str = "0.0.0.0",
    port: int = 8080,
    *,
    micro_batch: bool = True,
    max_batch: int = 256,
    window_s: float = 0.0,
    pipeline_depth: int = 4,
    stall_s: float = 60.0,
) -> ThreadingHTTPServer:
    """Start the daemon (returns the server; call .serve_forever()).

    The returned server carries its SearchService as `.service`; call
    `.service.close()` after `.shutdown()` to stop the batcher threads
    (they are daemons, so skipping this only matters for long-lived hosts).
    """
    service = SearchService(
        retriever, micro_batch=micro_batch, max_batch=max_batch,
        window_s=window_s, pipeline_depth=pipeline_depth, stall_s=stall_s,
    )

    class Server(ThreadingHTTPServer):
        # default backlog of 5 drops connections under bursty many-client
        # load (measured: resets at 128 concurrent connects)
        request_queue_size = 1024
        daemon_threads = True

    srv = Server((host, port), make_handler(service))
    srv.service = service
    return srv


def load_retriever_dir(directory: str, *, default_encoder=None,
                       encoders=None, device=None):
    """Detect and load any persisted retriever kind from `directory`:
    a HybridRetriever (hybrid.json), a LexicalRetriever
    (retriever.json family=bm25), or a dense Retriever. Dense engines
    need an encoder: pass `encoders` (hybrid, aligned per engine) or a
    `default_encoder` factory used for every dense slot. Dense indexes go
    to `device` (None: the encoder's device, else the card). Every dense
    engine's encoder must give vectors of its index's width, else this
    raises naming both."""
    import json as json_mod
    import os

    from cuvs_rag_tpu_torch.rag.lexical import LexicalRetriever
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever

    hybrid_meta = os.path.join(directory, "hybrid.json")
    if os.path.exists(hybrid_meta):
        from cuvs_rag_tpu_torch.rag.fusion import HybridRetriever

        if encoders is None:
            with open(hybrid_meta) as f:
                kinds = json_mod.load(f)["engines"]
            if default_encoder is None:
                raise ValueError(
                    "hybrid dir needs `encoders` or `default_encoder`"
                )
            encoders = [None if k == "bm25" else default_encoder()
                        for k in kinds]
        out = HybridRetriever.load(directory, encoders, device=device)
        check_encoder_dims(out)
        return out
    with open(os.path.join(directory, "retriever.json")) as f:
        meta = json_mod.load(f)
    if meta.get("family") == "bm25":
        return LexicalRetriever.load(directory)
    if encoders:
        enc = encoders[0]
    elif default_encoder is not None:
        enc = default_encoder()
    else:
        raise ValueError("dense dir needs an encoder")
    out = Retriever.load(directory, enc, device=device)
    check_encoder_dims(out)
    return out


def check_encoder_dims(retriever) -> None:
    """Raise ValueError where a dense engine's encoder gives vectors of
    another width than its index holds: its searches would fail at the
    first request, or answer meaningless results."""
    for i, r in enumerate(getattr(retriever, "retrievers", [retriever])):
        ix, enc = getattr(r, "index", None), getattr(r, "encoder", None)
        if ix is None or enc is None:
            continue
        dim = getattr(enc, "dim", None)
        if dim is None:
            dim = np.asarray(enc.encode(["dimension probe"])).shape[-1]
        if int(dim) != ix.dim:
            raise ValueError(
                f"engine {i} ({getattr(r, 'family', '?')}): the encoder "
                f"gives {dim}-d vectors but the loaded index holds "
                f"{ix.dim}-d rows — load it with the encoder it was built "
                "with"
            )


def main(argv=None):
    import argparse

    from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
    from cuvs_rag_tpu_torch.rag import datasets
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--placement", default="single")
    p.add_argument("--device", default=None,
                   help="where the index lives (default: the card)")
    p.add_argument("--hybrid", action="store_true",
                   help="serve a dense + BM25 hybrid retriever")
    p.add_argument("--load", default=None, metavar="DIR",
                   help="serve a Retriever.save()d / LexicalRetriever / "
                        "HybridRetriever directory (warm restart — no "
                        "rebuild); dense engines re-encode queries with "
                        "the demo hashing encoder (384-d), and a saved "
                        "index of another width is refused at startup")
    args = p.parse_args(argv)

    if args.load:
        retriever = load_retriever_dir(
            args.load, default_encoder=lambda: HashingEncoder(dim=384),
            device=args.device,
        )
    else:
        qa, _ = datasets.load_medical_qa(1000)
        corpus = Corpus(passages=[f"{r.input} {r.output}" for r in qa],
                        titles=[r.topic for r in qa])
        retriever = Retriever.build(
            corpus, HashingEncoder(dim=384), family="flat",
            params=FlatParams(metric=Metric.COSINE),
            placement=args.placement, device=args.device,
        )
        if args.hybrid:
            from cuvs_rag_tpu_torch.rag.fusion import HybridRetriever
            from cuvs_rag_tpu_torch.rag.lexical import LexicalRetriever

            retriever = HybridRetriever(
                [retriever, LexicalRetriever(corpus)]
            )
    srv = serve(retriever, args.host, args.port)
    print(f"serving on {args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
