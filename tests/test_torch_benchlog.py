"""eval/benchlog.py of the port: a byte copy of the JAX package's (held
here), and the JAX package's tests/test_benchlog.py (7 tests) on it."""

import json
import os

from cuvs_rag_tpu_torch.eval import benchlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payload(v):
    return {"metric": "exact_search_ms_per_query_x", "value": v,
            "unit": "ms/query", "vs_baseline": 1.0, "extra": {}}


def test_benchlog_is_a_byte_copy():
    with open(os.path.join(REPO, "cuvs_rag_tpu", "eval", "benchlog.py"),
              "rb") as a, open(benchlog.__file__, "rb") as b:
        assert a.read() == b.read()
    assert benchlog.repo_root() == REPO


def test_append_and_read_roundtrip(tmp_path):
    p = str(tmp_path / "log.jsonl")
    rec = benchlog.append_row(_payload(0.1), script="test", path=p)
    assert rec["payload"]["value"] == 0.1
    assert rec["script"] == "test"
    assert "ts" in rec and "unix" in rec and "sha" in rec
    rows = benchlog.read_rows(p)
    assert len(rows) == 1
    assert rows[0]["payload"]["value"] == 0.1


def test_read_skips_corrupt_lines(tmp_path):
    p = tmp_path / "log.jsonl"
    benchlog.append_row(_payload(0.1), path=str(p))
    with open(p, "a") as f:
        f.write("{not json\n\n")
    benchlog.append_row(_payload(0.2), path=str(p))
    assert [r["payload"]["value"] for r in benchlog.read_rows(str(p))] == \
        [0.1, 0.2]


def test_latest_prefers_same_sha_then_newest(tmp_path):
    p = str(tmp_path / "log.jsonl")
    with open(p, "w") as f:
        for unix, sha, v in [(1, "aaa", 0.1), (3, "bbb", 0.3),
                             (2, "aaa", 0.2)]:
            f.write(json.dumps({"ts": "t", "unix": unix, "sha": sha,
                                "dirty": False, "script": "s",
                                "payload": _payload(v)}) + "\n")
    assert benchlog.latest(sha="aaa", path=p)["payload"]["value"] == 0.2
    assert benchlog.latest(path=p)["payload"]["value"] == 0.3
    assert benchlog.latest(sha="zzz", path=p)["payload"]["value"] == 0.3


def test_latest_metric_prefix_filter(tmp_path):
    p = str(tmp_path / "log.jsonl")
    benchlog.append_row(_payload(0.1), path=p)
    other = dict(_payload(9.9), metric="server_p99_ms")
    benchlog.append_row(other, path=p)
    got = benchlog.latest(metric_prefix="exact_search", path=p)
    assert got["payload"]["value"] == 0.1


def test_latest_missing_file(tmp_path):
    assert benchlog.latest(path=str(tmp_path / "nope.jsonl")) is None


def test_append_survives_unwritable_path(tmp_path):
    target = str(tmp_path / "missing_dir" / "x.jsonl")
    rec = benchlog.append_row(_payload(0.1), path=target)
    assert rec["payload"]["value"] == 0.1  # best-effort: no raise
    assert not os.path.exists(target)


def test_git_state_shape():
    st = benchlog.git_state()
    assert set(st) == {"sha", "dirty"}
    assert st["sha"] is None or len(st["sha"]) == 40
