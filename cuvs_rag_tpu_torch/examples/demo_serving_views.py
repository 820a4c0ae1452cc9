"""Multi-tenant serving demo: named persistent filter views + a
disk-backed embedding store.

The counterpart of the JAX package's `examples/demo_serving_views.py`.
Flow: build a corpus with two "tenants", persist its embeddings to a
MemmapStore (the beyond-memory refine tier), serve it, bake one named view
per tenant, and show that (a) each tenant's searches never leak the other
tenant's passages, (b) view searches run without a per-request over-fetch,
(c) ad-hoc per-request deny_ids compose on top, (d) a live delete reaches
the baked views.

    python cuvs_rag_tpu_torch/examples/demo_serving_views.py          # the card
    python cuvs_rag_tpu_torch/examples/demo_serving_views.py --device cpu
"""

import argparse
import json
import os
import sys
import tempfile
import threading
from http.client import HTTPConnection

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
from cuvs_rag_tpu_torch.rag import server as server_mod
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.host_store import materialize_from_chunks
from cuvs_rag_tpu_torch.rag.pipeline import Retriever
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric


def req(addr, method, path, body=None):
    c = HTTPConnection(*addr, timeout=120)
    try:
        c.request(method, path, body=json.dumps(body) if body else None,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    n_per = 50
    passages = [f"[tenant-a] contract clause {i}: payment terms net {i}"
                for i in range(n_per)]
    passages += [f"[tenant-b] support ticket {i}: printer jam level {i}"
                 for i in range(n_per)]
    tenant_a = list(range(n_per))
    tenant_b = list(range(n_per, 2 * n_per))

    enc = HashingEncoder(dim=128)
    emb = np.asarray(enc.encode(passages), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        # persist embeddings to a disk-backed store (np.memmap + sidecar):
        # on a beyond-device deployment this is the refine source
        # fetch_rows reads from — here it shows the API end to end
        store = materialize_from_chunks(
            os.path.join(tmp, "emb.bin"), lambda i: emb[i * 25:(i + 1) * 25],
            len(passages), 128, len(passages) // 25, dtype="float32",
        )
        print(f"embedding store on disk: {store.path} "
              f"({store._mm.nbytes / 1e3:.0f} KB, {store.shape})")
        serve_tenants(store, enc, passages, tenant_a, tenant_b, n_per,
                      args.device)


def serve_tenants(store, enc, passages, tenant_a, tenant_b, n_per, device):
    corpus = Corpus(passages=passages, embeddings=store)
    r = Retriever.build(
        corpus, enc, family="flat",
        params=FlatParams(metric=Metric.COSINE, tile_n=32), device=device,
    )
    srv = server_mod.serve(r, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    addr = srv.server_address
    print(f"serving on {addr}")
    try:
        # one persistent view per tenant — baked once, searched at full speed
        for name, ids in (("tenant-a", tenant_a), ("tenant-b", tenant_b)):
            code, body = req(addr, "POST", "/v1/views",
                             {"name": name, "allow_ids": ids})
            assert code == 200, body
            print(f"baked view {name}: {body}")

        q = "payment terms of the contract"
        for view in ("tenant-a", "tenant-b"):
            code, body = req(addr, "POST", "/v1/search",
                             {"texts": [q], "k": 3, "view": view})
            assert code == 200, body
            hits = body["results"][0]["passages"]
            print(f"\n[{view}] query: {q!r}")
            for h in hits:
                print(f"  #{h['index']:3d} d={h['distance']:.3f} {h['text']}")
            lo, hi = (0, n_per) if view == "tenant-a" else (n_per, 2 * n_per)
            assert all(lo <= h["index"] < hi for h in hits), "tenant leak!"

        # ad-hoc exclusion composes on top of the persistent view
        top = req(addr, "POST", "/v1/search",
                  {"texts": [q], "k": 1, "view": "tenant-a"})[1]
        top_id = top["results"][0]["passages"][0]["index"]
        code, body = req(addr, "POST", "/v1/search",
                         {"texts": [q], "k": 1, "view": "tenant-a",
                          "deny_ids": [top_id]})
        nxt = body["results"][0]["passages"][0]["index"]
        print(f"\ndeny top hit {top_id} within tenant-a -> next: {nxt}")
        assert nxt != top_id and nxt < n_per

        # live corpus mutation: tenant-b retracts a ticket — no restart, and
        # the baked views re-bake so the id vanishes from the tenant's view
        gone = n_per  # "[tenant-b] support ticket 0"
        code, body = req(addr, "POST", "/v1/delete", {"ids": [gone]})
        assert code == 200, body
        print(f"\nlive-deleted id {gone}: {body}")
        code, body = req(addr, "POST", "/v1/search",
                         {"texts": ["support ticket 0 printer jam"], "k": 5,
                          "view": "tenant-b"})
        hits = [h["index"] for h in body["results"][0]["passages"]]
        assert gone not in hits, hits
        print(f"tenant-b top-5 after retraction: {hits} (no {gone})")

        # appending requires an appendable embedding source — the disk
        # store is read-only, and the daemon says so instead of silently
        # desyncing
        code, body = req(addr, "POST", "/v1/extend",
                         {"texts": ["[tenant-b] new ticket"]})
        assert code == 400 and "read-only" in body["error"], (code, body)
        print(f"extend against the read-only store -> 400: "
              f"{body['error'][:64]}…")

        code, body = req(addr, "GET", "/v1/views")
        print(f"\nviews: {body['views']}")
    finally:
        srv.shutdown()
        srv.service.close()
        th.join(timeout=30)
    print("OK")


if __name__ == "__main__":
    main()
