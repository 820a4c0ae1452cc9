"""cuvs_rag_tpu_torch.rag.server against the JAX package's rag/server.py:
both daemons run here on the CPU over the same corpus (the same passages,
embeddings and hashing encoder) and answer the same requests on every
endpoint: search by texts and by vectors (with deny lists and named
views), views, live extend and delete, health, stats and metrics, and the
error codes. Also concurrency, searches beside live updates, the flat,
lexical and hybrid kinds, and load_retriever_dir both ways (the port's
refuses an encoder of another width, as `--load` does at startup).

Tolerances: ids equal up to ties at the k-th and distances within rtol
1e-5 / atol 1e-4 (utils/compare.py; the two packages sum fp32 products in
another order); hybrid replies carry fused ranks, held exactly. The port
searches a coalesced batch at its requests' own k + |deny| (no power-of-two
padding), so its replies equal a direct retrieve_batch exactly. A hybrid's
fused list depends on the k it is asked for (each engine fetches 4k), and
the JAX daemon asks at k + |deny| rounded up to a power of two: the two
daemons' hybrid replies are compared where that sum is a power of two.
"""

import json
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.models.encoder import HashingEncoder as JHashingEncoder
from cuvs_rag_tpu.rag import fusion as jfusion
from cuvs_rag_tpu.rag import lexical as jlex
from cuvs_rag_tpu.rag import server as jserver
from cuvs_rag_tpu.rag.corpus import Corpus as JCorpus
from cuvs_rag_tpu.rag.pipeline import Retriever as JRetriever
from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
from cuvs_rag_tpu_torch.rag import fusion
from cuvs_rag_tpu_torch.rag import lexical as tlex
from cuvs_rag_tpu_torch.rag import server
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.pipeline import Retriever
from torch_parity import compare_topk

torch.set_num_threads(1)

DIM = 64
N = 300
TOL = dict(rtol=1e-5, atol=1e-4)
TIMEOUT = 60.0


def _passages(n=N, seed=3):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(150)]
    return [f"doc {i} " + " ".join(rng.choice(words, int(rng.integers(3, 15))))
            for i in range(n)]


def _embeddings(passages, seed=4):
    rng = np.random.default_rng(seed)
    emb = HashingEncoder(dim=DIM).encode(passages)
    return (emb + 1e-3 * rng.standard_normal(emb.shape)).astype(np.float32)


QUERIES = ["doc 3 t1 t2", "t40 t41 t42", "t7", "doc 100 t9", "nothing at all",
           "t1 t2 t3 t4 t5 t6"]


def _retrievers(kind):
    """(JAX retriever, port retriever) of `kind` over one corpus each."""
    passages = _passages()
    emb = _embeddings(passages)
    titles = [f"title {i}" for i in range(len(passages))]
    jc = JCorpus(passages=list(passages), embeddings=emb.copy(),
                 titles=list(titles))
    tc = Corpus(passages=list(passages), embeddings=emb.copy(),
                titles=list(titles))
    if kind == "bm25":
        return jlex.LexicalRetriever(jc), tlex.LexicalRetriever(tc)
    jr = JRetriever.build(jc, JHashingEncoder(dim=DIM))
    tr = Retriever.build(tc, HashingEncoder(dim=DIM), device="cpu")
    if kind == "flat":
        return jr, tr
    return (jfusion.HybridRetriever([jr, jlex.LexicalRetriever(jc)]),
            fusion.HybridRetriever([tr, tlex.LexicalRetriever(tc)]))


class Daemon:
    """A daemon on 127.0.0.1 at a free port, served from a thread."""

    def __init__(self, module, retriever, **kw):
        self.srv = module.serve(retriever, host="127.0.0.1", port=0, **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, method, path, body=None):
        c = HTTPConnection(*self.srv.server_address, timeout=TIMEOUT)
        try:
            c.request(method, path,
                      body=None if body is None else json.dumps(body),
                      headers={"Content-Type": "application/json"})
            resp = c.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            c.close()

    def ok(self, method, path, body=None):
        code, out = self.call(method, path, body)
        assert code == 200, (path, body, out)
        return out

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.service.close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture
def daemons(request):
    """(JAX daemon, port daemon, JAX retriever, port retriever) of the
    parametrized kind."""
    jr, tr = _retrievers(request.param)
    jd, td = Daemon(jserver, jr), Daemon(server, tr)
    yield jd, td, jr, tr
    jd.close()
    td.close()


def _same_texts(jrep, trep, fused=False):
    assert len(jrep["results"]) == len(trep["results"])
    for a, b in zip(jrep["results"], trep["results"]):
        pa, pb = a["passages"], b["passages"]
        assert len(pa) == len(pb)
        for p, q in zip(pa, pb):
            assert (p["index"] == q["index"]) or not fused
        ia = np.array([[p["index"] for p in pa]])
        ib = np.array([[p["index"] for p in pb]])
        if fused:
            np.testing.assert_array_equal(ia, ib)
            continue
        da = -np.array([[p["distance"] for p in pa]])
        db = -np.array([[p["distance"] for p in pb]])
        if ia.size:
            compare_topk(db, ib, da, ia, **TOL)
        texts = {p["index"]: (p["text"], p["title"]) for p in pa}
        assert all(texts.get(p["index"], (p["text"], p["title"]))
                   == (p["text"], p["title"]) for p in pb)


def _same_vectors(jrep, trep):
    ia, ib = np.array(jrep["indices"]), np.array(trep["indices"])
    da, db = np.array(jrep["distances"]), np.array(trep["distances"])
    assert ia.shape == ib.shape
    compare_topk(-db, ib, -da, ia, **TOL)


@pytest.mark.parametrize("daemons", ["flat"], indirect=True)
def test_read_endpoints_answer_as_the_jax_daemon(daemons):
    jd, td, _, _ = daemons
    for path in ("/healthz", "/stats", "/metrics", "/v1/views"):
        a, b = jd.ok("GET", path), td.ok("GET", path)
        assert set(a) <= set(b), path
    h = td.ok("GET", "/healthz")
    assert h["status"] == "ok" and h["device"] == "cpu" and h["device_name"]
    a, b = jd.ok("GET", "/stats"), td.ok("GET", "/stats")
    for key in ("family", "corpus_size", "placement", "views"):
        assert a[key] == b[key], key
    assert b["devices"] == ["cpu"] and b["device"] == "cpu"
    for method in ("GET", "POST", "DELETE"):
        assert jd.call(method, "/nowhere", {} if method == "POST" else None)[0] \
            == td.call(method, "/nowhere", {} if method == "POST" else None)[0] \
            == 404


@pytest.mark.parametrize("daemons", ["flat"], indirect=True)
@pytest.mark.parametrize("k", [1, 5, 40])
def test_searches_equal_the_jax_daemon(daemons, k):
    """Texts and vectors, alone and with a deny list (the over-fetch)."""
    jd, td, _, _ = daemons
    body = {"texts": QUERIES, "k": k}
    _same_texts(jd.ok("POST", "/v1/search", body),
                td.ok("POST", "/v1/search", body))
    deny = list(range(0, N, 7))
    body["deny_ids"] = deny
    b = td.ok("POST", "/v1/search", body)
    _same_texts(jd.ok("POST", "/v1/search", body), b)
    assert not {p["index"] for r in b["results"] for p in r["passages"]} \
        & set(deny)
    vecs = HashingEncoder(dim=DIM).encode(QUERIES).tolist()
    for extra in ({}, {"deny_ids": deny}):
        body = {"vectors": vecs, "k": k, **extra}
        _same_vectors(jd.ok("POST", "/v1/search", body),
                      td.ok("POST", "/v1/search", body))


@pytest.mark.parametrize("daemons", ["flat"], indirect=True)
def test_replies_equal_a_direct_retrieve_batch_at_their_own_k(daemons):
    """No bucket padding: the reply is retrieve_batch at the request's k."""
    _, td, _, tr = daemons
    for k in (3, 7, 33):
        rep = td.ok("POST", "/v1/search", {"texts": QUERIES, "k": k})
        want = tr.retrieve_batch(QUERIES, k)
        assert [[(p["index"], p["distance"]) for p in r["passages"]]
                for r in rep["results"]] == \
            [[(p.index, p.distance) for p in r.passages] for r in want]


@pytest.mark.parametrize("daemons", ["flat"], indirect=True)
def test_bad_requests_answer_as_the_jax_daemon(daemons):
    jd, td, _, _ = daemons
    cases = [
        ("POST", "/v1/search", {"texts": ["a"], "k": 0}),
        ("POST", "/v1/search", {"texts": [], "k": 2}),
        ("POST", "/v1/search", {"texts": [3], "k": 2}),
        ("POST", "/v1/search", {"k": 2}),
        ("POST", "/v1/search", {"texts": ["a"], "deny_ids": list(range(1025))}),
        ("POST", "/v1/search", {"texts": ["a"], "deny_ids": [N + 5]}),
        ("POST", "/v1/search", {"texts": ["a"], "deny_ids": [1.5]}),
        ("POST", "/v1/search", {"texts": ["a"], "view": "missing"}),
        ("POST", "/v1/search", {"vectors": [[0.0] * (DIM + 1)], "k": 2}),
        ("POST", "/v1/search", {"vectors": [], "k": 2}),
        ("POST", "/v1/views", {"name": "bad name!", "allow_ids": [1]}),
        ("POST", "/v1/views", {"name": "v", "allow_ids": [1],
                               "deny_ids": [2]}),
        ("POST", "/v1/views", {"name": "v", "deny_ids": list(range(N))}),
        ("POST", "/v1/extend", {}),
        ("POST", "/v1/extend", {"vectors": [[0.0] * 3]}),
        ("POST", "/v1/delete", {"ids": []}),
        ("POST", "/v1/delete", {"ids": [-1]}),
        ("DELETE", "/v1/views/missing", None),
    ]
    for method, path, body in cases:
        a, b = jd.call(method, path, body), td.call(method, path, body)
        assert a[0] == b[0] and a[0] in (400, 404), (path, body, a, b)


@pytest.mark.parametrize("daemons", ["flat", "hybrid", "bm25"], indirect=True)
def test_views_equal_the_jax_daemon(daemons):
    jd, td, _, _ = daemons
    fused = td.ok("GET", "/stats")["family"] != "flat"
    allow = list(range(0, N, 2))
    for d in (jd, td):
        d.ok("POST", "/v1/views", {"name": "even", "allow_ids": allow})
        d.ok("POST", "/v1/views", {"name": "no_low", "deny_ids": list(range(50))})
    va, vb = jd.ok("GET", "/v1/views")["views"], td.ok("GET", "/v1/views")["views"]
    assert {n: (v["allowed"], v["kind"]) for n, v in va.items()} == \
        {n: (v["allowed"], v["kind"]) for n, v in vb.items()}
    for view, ok in (("even", lambda i: i % 2 == 0), ("no_low", lambda i: i >= 50)):
        for k in (2, 14):  # k + |deny| = 4, 16
            body = {"texts": QUERIES, "k": k, "view": view, "deny_ids": [2, 52]}
            b = td.ok("POST", "/v1/search", body)
            _same_texts(jd.ok("POST", "/v1/search", body), b, fused)
            got = [p["index"] for r in b["results"] for p in r["passages"]]
            assert all(ok(i) and i not in (2, 52) for i in got)
    if not fused:
        body = {"vectors": HashingEncoder(dim=DIM).encode(QUERIES).tolist(),
                "k": 6, "view": "even"}
        _same_vectors(jd.ok("POST", "/v1/search", body),
                      td.ok("POST", "/v1/search", body))
    assert td.ok("DELETE", "/v1/views/even") == jd.ok("DELETE", "/v1/views/even")
    assert td.call("POST", "/v1/search", {"texts": ["a"], "view": "even"})[0] == 400


@pytest.mark.parametrize("daemons", ["flat", "hybrid", "bm25"], indirect=True)
def test_live_extend_and_delete_equal_the_jax_daemon(daemons):
    jd, td, _, _ = daemons
    fused = td.ok("GET", "/stats")["family"] != "flat"
    for d in (jd, td):
        d.ok("POST", "/v1/views", {"name": "even", "allow_ids": list(range(0, N, 2))})
        d.ok("POST", "/v1/views", {"name": "no3", "deny_ids": [3]})
    new = ["doc new t1 t2 t3 t4", "a second added passage t88"]
    a = jd.ok("POST", "/v1/extend", {"texts": new, "titles": ["n1", "n2"]})
    b = td.ok("POST", "/v1/extend", {"texts": new, "titles": ["n1", "n2"]})
    assert (a["added"], a["ids"], a["corpus_size"]) == \
        (b["added"], b["ids"], b["corpus_size"]) == (2, [N, N + 2], N + 2)
    if not fused:
        vec = HashingEncoder(dim=DIM).encode(["vector only t5"]).tolist()
        a = jd.ok("POST", "/v1/extend", {"vectors": vec})
        b = td.ok("POST", "/v1/extend", {"vectors": vec})
        assert a["ids"] == b["ids"]
    else:  # a hybrid or lexical daemon takes texts only
        assert td.call("POST", "/v1/extend", {"vectors": [[0.0] * DIM]})[0] \
            == jd.call("POST", "/v1/extend", {"vectors": [[0.0] * DIM]})[0] \
            == 400
    for d in (jd, td):
        d.ok("POST", "/v1/delete", {"ids": [1, N, 3]})
    for view in (None, "even", "no3"):
        body = {"texts": QUERIES + new, "k": 8, "view": view}
        b = td.ok("POST", "/v1/search", body)
        _same_texts(jd.ok("POST", "/v1/search", body), b, fused)
        got = {p["index"] for r in b["results"] for p in r["passages"]}
        assert not got & {1, N, 3}
        if view == "even":  # rows added after an allow view stay outside it
            assert all(i % 2 == 0 and i < N for i in got)
    rep = td.ok("POST", "/v1/search", {"texts": [new[1]], "k": 1})
    assert rep["results"][0]["passages"][0]["index"] == N + 1
    assert rep["results"][0]["passages"][0]["title"] == "n2"
    assert td.ok("GET", "/stats")["corpus_size"] == \
        jd.ok("GET", "/stats")["corpus_size"]


@pytest.mark.parametrize("daemons", ["hybrid", "bm25"], indirect=True)
def test_text_native_daemons_refuse_vectors_as_the_jax_daemon(daemons):
    jd, td, _, _ = daemons
    body = {"vectors": [[0.0] * DIM], "k": 2}
    a, b = jd.call("POST", "/v1/search", body), td.call("POST", "/v1/search", body)
    assert a[0] == b[0] == 400
    for k in (2, 6):  # k + |deny| = 4, 8
        body = {"texts": QUERIES, "k": k, "deny_ids": [0, 3]}
        _same_texts(jd.ok("POST", "/v1/search", body),
                    td.ok("POST", "/v1/search", body), fused=True)


def test_concurrent_clients_each_get_their_answer():
    """16 clients at once (coalesced into shared batches of mixed k and deny
    lists) each get what the same request gets alone."""
    _, tr = _retrievers("flat")
    d = Daemon(server, tr, window_s=0.01)
    try:
        reqs = [{"texts": [QUERIES[i % 6], QUERIES[(i + 1) % 6]],
                 "k": 1 + i % 9, "deny_ids": [i % 5] if i % 3 else []}
                for i in range(32)]
        want = [d.ok("POST", "/v1/search", r) for r in reqs]
        got, errors = [None] * len(reqs), []

        def run(c):
            try:
                for j in range(c, len(reqs), 16):
                    got[j] = d.ok("POST", "/v1/search", reqs[j])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for a, b in zip(want, got):
            assert [[p["index"] for p in r["passages"]] for r in a["results"]] \
                == [[p["index"] for p in r["passages"]] for r in b["results"]]
        h = d.ok("GET", "/metrics")["histograms"]["server.microbatch_size.texts"]
        assert h["max"] > 1  # some requests shared a batch
    finally:
        d.close()


def test_searches_beside_live_updates_stay_valid():
    """Four clients search while extends and deletes land: no request
    fails, every id lies in the corpus, a deleted row never comes back
    from a search sent after its delete returned."""
    _, tr = _retrievers("flat")
    d = Daemon(server, tr)
    stop, seen, errors, gone = threading.Event(), [], [], {}

    def searcher(c):
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                rep = d.ok("POST", "/v1/search", {"texts": QUERIES[c:c + 2], "k": 10})
                seen.append((t0, [p["index"] for r in rep["results"]
                                  for p in r["passages"]]))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=searcher, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for j in range(6):
            d.ok("POST", "/v1/extend", {"texts": [f"doc added {j} t1 t2"]})
            rep = d.ok("POST", "/v1/search", {"texts": QUERIES[:1], "k": 1})
            row = rep["results"][0]["passages"][0]["index"]
            d.ok("POST", "/v1/delete", {"ids": [row]})
            gone[row] = time.perf_counter()
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        d.close()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert seen
    for t0, ids in seen:
        assert all(0 <= i < N + 6 for i in ids)
        assert not any(i in gone and t0 > gone[i] for i in ids)


def test_microbatcher_orders_results_and_reports_errors():
    calls = []

    def run(items):
        calls.append(list(items))
        if "boom" in items:
            raise ValueError("boom")
        return [x * 2 for x in items]

    b = server.MicroBatcher(run, pipeline_depth=2)
    try:
        assert [b.submit(i, timeout=TIMEOUT) for i in range(5)] == \
            [0, 2, 4, 6, 8]
        with pytest.raises(ValueError):
            b.submit("boom", timeout=TIMEOUT)
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit(1)


def test_a_wedged_dispatcher_is_refused_fast():
    """Every dispatcher stuck past stall_s: new work raises
    ServerStalledError (the daemon's 503) instead of queuing."""
    release = threading.Event()

    def run(items):
        release.wait(TIMEOUT)
        return items

    b = server.MicroBatcher(run, pipeline_depth=1, stall_s=0.05)
    t = threading.Thread(target=lambda: b.submit(1, timeout=TIMEOUT))
    t.start()
    try:
        time.sleep(0.3)
        with pytest.raises(server.ServerStalledError):
            b.submit(2, timeout=TIMEOUT)
    finally:
        release.set()
        t.join(timeout=TIMEOUT)
        b.close()
    assert not t.is_alive()


def _save_all(pkg, jr_tr, root):
    """Save a dense, a lexical and a hybrid retriever of one package."""
    (jr, tr) = jr_tr
    r = jr if pkg == "jax" else tr
    lexmod = jlex if pkg == "jax" else tlex
    fusmod = jfusion if pkg == "jax" else fusion
    r.save(str(root / f"{pkg}_dense"))
    lex = lexmod.LexicalRetriever(r.corpus)
    lex.save(str(root / f"{pkg}_lex"))
    fusmod.HybridRetriever([r, lex]).save(str(root / f"{pkg}_hyb"))


def test_load_retriever_dir_all_kinds_both_ways(tmp_path):
    """Each package's load_retriever_dir restores every kind the other
    saved, and the two answer alike."""
    pair = _retrievers("flat")
    _save_all("jax", pair, tmp_path)
    _save_all("port", pair, tmp_path)
    for kind in ("dense", "lex", "hyb"):
        t = server.load_retriever_dir(
            str(tmp_path / f"jax_{kind}"),
            default_encoder=lambda: HashingEncoder(dim=DIM), device="cpu")
        j = jserver.load_retriever_dir(
            str(tmp_path / f"port_{kind}"),
            default_encoder=lambda: JHashingEncoder(dim=DIM))
        assert t.family == j.family == {"dense": "flat", "lex": "bm25",
                                        "hyb": "hybrid"}[kind]
        a, b = j.retrieve_batch(QUERIES, 6), t.retrieve_batch(QUERIES, 6)
        assert [[p.index for p in r.passages] for r in a] == \
            [[p.index for p in r.passages] for r in b]
        if kind == "dense":
            assert t.index.device.type == "cpu"


def test_load_refuses_an_encoder_of_another_width(tmp_path):
    """A saved 64-d index with the demo's 384-d encoder: load_retriever_dir
    and `--load` fail at startup, naming both widths, for a dense and a
    hybrid directory."""
    pair = _retrievers("flat")
    _save_all("port", pair, tmp_path)
    for kind in ("dense", "hyb"):
        with pytest.raises(ValueError, match="384-d vectors .* 64-d rows"):
            server.load_retriever_dir(
                str(tmp_path / f"port_{kind}"),
                default_encoder=lambda: HashingEncoder(dim=384), device="cpu")
        with pytest.raises(ValueError, match="384-d vectors .* 64-d rows"):
            server.main(["--load", str(tmp_path / f"port_{kind}"),
                         "--device", "cpu", "--host", "127.0.0.1",
                         "--port", "0"])


def test_cagra_daemon_views_post_filter_within_itopk():
    """A CAGRA retriever's views are masks (the post-filter): results stay
    inside the view, and a request whose k + |deny| passes itopk_size is a
    400 before it reaches a batch (unpadded: k + |deny| itself is held)."""
    from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams

    passages = _passages()
    tr = Retriever.build(
        Corpus(passages=list(passages), embeddings=_embeddings(passages)),
        HashingEncoder(dim=DIM), family="cagra",
        params=CagraParams(graph_degree=16, intermediate_graph_degree=32),
        search_params=CagraSearchParams(itopk_size=32), device="cpu")
    d = Daemon(server, tr)
    try:
        assert d.ok("POST", "/v1/views", {"name": "even", "allow_ids": list(
            range(0, N, 2))})["allowed"] == N // 2
        assert d.ok("GET", "/v1/views")["views"]["even"]["kind"] == "mask"
        rep = d.ok("POST", "/v1/search", {"texts": QUERIES, "k": 20,
                                          "view": "even", "deny_ids": [0]})
        got = [p["index"] for r in rep["results"] for p in r["passages"]]
        assert got and all(i % 2 == 0 and i != 0 for i in got)
        for k, deny, code in ((31, [1], 200), (32, [1], 400), (30, [1, 2, 3], 400)):
            assert d.call("POST", "/v1/search", {
                "texts": ["t1"], "k": k, "view": "even", "deny_ids": deny})[0] \
                == code
    finally:
        d.close()


def test_a_wedged_search_is_answered_503_over_http():
    """The daemon's stall path end to end: with its one dispatcher stuck in
    a search past stall_s, the next request is a 503 marked retryable, and
    the stuck one completes once the search returns."""
    _, tr = _retrievers("flat")
    release, inner = threading.Event(), tr.retrieve_batch

    def stuck(*args, **kw):
        release.wait(TIMEOUT)
        return inner(*args, **kw)

    tr.retrieve_batch = stuck
    d = Daemon(server, tr, pipeline_depth=1, stall_s=0.05)
    first = []
    t = threading.Thread(target=lambda: first.append(
        d.call("POST", "/v1/search", {"texts": ["t1"], "k": 2})))
    try:
        t.start()
        time.sleep(0.3)
        code, body = d.call("POST", "/v1/search", {"texts": ["t2"], "k": 2})
        assert code == 503 and body["retry"] is True
    finally:
        release.set()
        t.join(timeout=TIMEOUT)
        d.close()
    assert not t.is_alive() and first[0][0] == 200
