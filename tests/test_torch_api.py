"""The reference's API-level tests run against the port's Engine and HTTP
server on the CPU, in the fused mode (the library default, which the
reference's tests run) and in sparse mode: every case of tests/test_api.py
and tests/test_api_hybrid.py, the cases of tests/test_degraded.py, and the
Engine cases of tests/test_pipeline_serving.py. Their bodies are the
reference's, over the port's modules."""

import http.client
import json
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

from nextsearch_tpu_torch import native
from nextsearch_tpu_torch.api.ai import AzureOpenAIConfig
from nextsearch_tpu_torch.api.batching import SearchBatcher
from nextsearch_tpu_torch.api.feedback import FeedbackManager
from nextsearch_tpu_torch.api.server import ServerContext, make_server
from nextsearch_tpu_torch.api.stats import StatsTracker
from nextsearch_tpu_torch.config import BatchingConfig, DeviceConfig, EngineConfig
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment

from test_engine import DOCS_SEG1, DOCS_SEG2, METADATA_CSV

torch.set_num_threads(1)

MODES = ["fused", "sparse"]


def _config(mode: str) -> EngineConfig:
    return EngineConfig(device=DeviceConfig(mode=mode))


def _engine(index_dir, mode, cache_dir):
    return Engine(index_dir, config=_config(mode), cache_dir=cache_dir,
                  device="cpu")


def _fake_transport(host, path, headers, body):
    req = json.loads(body)
    assert req["messages"][0]["role"] == "system"
    return json.dumps(
        {
            "choices": [{"message": {"content": "## Overview\nmocked"}}],
            "usage": {"total_tokens": 42},
        }
    )


def _two_segment_index(d):
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(DOCS_SEG1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(DOCS_SEG2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(METADATA_CSV)


def _start(ctx):
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv, ctx):
    srv.shutdown()
    srv.server_close()
    ctx.batcher.shutdown()
    ctx.suggest_batcher.shutdown()


@pytest.fixture(scope="module", params=MODES)
def server(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"api_{request.param}")
    d = tmp / "index"
    _two_segment_index(d)
    engine = _engine(d, request.param, tmp)
    assert engine.reload()
    assert engine.index.config.device.mode == request.param
    azure = AzureOpenAIConfig("https://fake.example", "key", "gpt-test")
    ctx = ServerContext(
        engine,
        StatsTracker(tmp / "stats.json"),
        FeedbackManager(tmp / "feedback.json"),
        azure,
        transport=_fake_transport,
    )
    srv = _start(ctx)
    yield srv, ctx
    _stop(srv, ctx)


def _get(server, path):
    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r, (json.loads(body) if body else None)


def _post(server, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=30)
    body = json.dumps(payload) if payload is not None else ""
    conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r, (json.loads(data) if data else None)


# ------------------------------------------------------- tests/test_api.py


def test_health(server):
    r, j = _get(server, "/api/health")
    assert r.status == 200
    assert j == {"ok": True, "segments": 2}
    assert r.getheader("Access-Control-Allow-Origin") == "*"


def test_search_contract(server):
    r, j = _get(server, "/api/search?q=covid+vaccine&k=5")
    assert r.status == 200
    assert j["query"] == "covid vaccine"
    assert j["k"] == 5 and j["segments"] == 2 and j["found"] == 3
    assert j["cached"] is False
    assert j["search_time_ms"] > 0 and j["total_time_ms"] >= j["search_time_ms"]
    assert "cache_lookup_ms" not in j
    assert j["results"][0]["cord_uid"] == "uid01"

    r2, j2 = _get(server, "/api/search?q=covid+vaccine&k=5")
    assert j2["cached"] is True
    assert j2["search_time_ms"] == 0.0
    assert j2["cache_lookup_ms"] >= 0
    assert "from_cache" not in j2


def test_search_missing_q(server):
    r, j = _get(server, "/api/search")
    assert r.status == 400 and j == {"error": "missing q param"}


def test_search_bad_k_is_500(server):
    r, j = _get(server, "/api/search?q=covid&k=abc")
    assert r.status == 500 and j == {"error": "internal server error"}
    r2, j2 = _get(server, "/api/search?q=covid&k=3abc")
    assert r2.status == 200 and j2["k"] == 3


def test_suggest_contract(server):
    r, j = _get(server, "/api/suggest?q=cov&k=3")
    assert r.status == 200
    assert j["query"] == "cov" and j["limit"] == 3
    assert j["suggestions"][0] == "covid"
    r2, j2 = _get(server, "/api/suggest")
    assert r2.status == 400 and j2 == {"error": "missing q param"}


def test_reload(server):
    r, j = _post(server, "/api/reload")
    assert r.status == 200
    assert j == {"reloaded": True, "segments": 2}


def test_feedback_validation(server):
    r, j = _post(server, "/api/feedback", {"message": "great", "type": "anonymous"})
    assert r.status == 200 and j["success"] is True and j["total_count"] >= 1

    r, j = _post(server, "/api/feedback", {"type": "anonymous"})
    assert r.status == 400 and j["error"] == "missing or invalid 'message' field"

    r, j = _post(server, "/api/feedback", {"message": "x"})
    assert r.status == 400 and j["error"] == "missing or invalid 'type' field"

    r, j = _post(server, "/api/feedback", {"message": "x", "type": "positive"})
    assert r.status == 400 and j["error"] == "type must be 'anonymous' or 'replyable'"

    r, j = _post(server, "/api/feedback", {"message": "x", "type": "replyable"})
    assert r.status == 400
    assert j["error"] == "email is required for 'replyable' type feedback"

    r, j = _post(
        server, "/api/feedback",
        {"message": "x", "type": "replyable", "email": "a@b.c"},
    )
    assert r.status == 200

    conn = http.client.HTTPConnection(
        "127.0.0.1", server[0].server_port, timeout=10
    )
    conn.request("POST", "/api/feedback", body="{not json",
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    j = json.loads(resp.read())
    conn.close()
    assert resp.status == 400 and j["error"] == "invalid JSON in request body"


def test_stats_contract(server):
    r, j = _get(server, "/api/stats")
    assert r.status == 200
    for key in (
        "total_searches", "search_cache_hits", "search_cache_hit_rate",
        "ai_overview_calls", "ai_overview_cache_hit_rate",
        "ai_summary_calls", "ai_summary_cache_hit_rate",
        "ai_api_calls_remaining", "ai_api_calls_used",
        "last_10_feedback", "total_feedback_count",
    ):
        assert key in j, key
    assert j["total_searches"] >= 1


def test_ai_overview(server):
    r, j = _get(server, "/api/ai_overview?q=covid&k=5")
    assert r.status == 200
    assert j["query"] == "covid"
    assert j["overview"].startswith("## Overview")
    assert j["model"] == "gpt-test"
    assert j["usage"] == {"total_tokens": 42}

    remaining1 = server[1].stats.get_ai_api_calls_remaining()
    r2, j2 = _get(server, "/api/ai_overview?q=covid&k=5")
    assert r2.status == 200
    assert server[1].stats.get_ai_api_calls_remaining() == remaining1

    r3, j3 = _get(server, "/api/ai_overview")
    assert r3.status == 400 and j3 == {"error": "missing q param"}

    r4, j4 = _get(server, "/api/ai_overview?q=zzznothing")
    assert r4.status == 404
    assert j4["error"] == "No search results found for the query"


def test_ai_summary(server):
    r, j = _get(server, "/api/ai_summary?cord_uid=uid01")
    assert r.status == 200
    assert j["cord_uid"] == "uid01" and j["summary"].startswith("## Overview")
    assert j["cached"] is False
    r2, j2 = _get(server, "/api/ai_summary?cord_uid=uid01")
    assert r2.status == 200 and j2["cached"] is True

    r3, j3 = _get(server, "/api/ai_summary?cord_uid=nosuch")
    assert r3.status == 404
    assert j3["error"] == "cord_uid not found in metadata"

    r4, j4 = _get(server, "/api/ai_summary")
    assert r4.status == 400 and j4 == {"error": "missing cord_uid param"}


def test_add_document_disabled(server):
    r, j = _post(server, "/api/add_document", {})
    assert r.status == 503
    assert j == {"error": '"Add Document" is disabled for the current version'}


def test_options_preflight(server):
    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=10)
    conn.request(
        "OPTIONS", "/api/search",
        headers={"Access-Control-Request-Method": "GET",
                 "Access-Control-Request-Headers": "X-Custom"},
    )
    r = conn.getresponse()
    r.read()
    conn.close()
    assert r.status == 204
    assert "GET, OPTIONS" in r.getheader("Access-Control-Allow-Methods")
    assert r.getheader("Access-Control-Allow-Headers") == "X-Custom"


def test_unknown_route(server):
    r, j = _get(server, "/api/nope")
    assert r.status == 404


def test_concurrent_searches_batched(server):
    """Concurrent distinct queries must all succeed (batcher coalesces)."""
    results = {}

    def hit(q):
        conn = http.client.HTTPConnection(
            "127.0.0.1", server[0].server_port, timeout=30
        )
        conn.request("GET", f"/api/search?q={q}&k=3")
        r = conn.getresponse()
        results[q] = json.loads(r.read())
        conn.close()

    qs = ["trial", "immunity", "transmission", "efficacy", "study", "dynamics"]
    threads = [threading.Thread(target=hit, args=(q,)) for q in qs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for q in qs:
        assert results[q]["query"] == q
        assert results[q]["found"] >= 1, q


def test_stats_timings_extension(server):
    r, j = _get(server, "/api/stats?timings=1")
    assert r.status == 200
    assert "engine_timings" in j
    assert j["index"]["segments"] == 2
    assert j["index"]["docs"] == 3
    r2, j2 = _get(server, "/api/stats")
    assert "engine_timings" not in j2 and "index" not in j2


def test_search_hybrid_param_without_embeddings_falls_back(server):
    r, j = _get(server, "/api/search?q=covid&k=3&hybrid=1")
    assert r.status == 200
    assert "hybrid" not in j


def test_search_batch_endpoint(server):
    payload = {"queries": [{"q": "covid", "k": 3}, {"q": "vaccine trial", "k": 2}]}
    r, j = _post(server, "/api/search_batch", payload)
    assert r.status == 200
    assert len(j["results"]) == 2
    assert j["results"][0]["query"] == "covid"
    assert j["results"][1]["query"] == "vaccine trial"
    for res in j["results"]:
        assert "cached" in res and isinstance(res["results"], list)
    assert j["search_time_ms"] >= 0
    r2, j2 = _get(server, "/api/search?q=covid&k=3")
    assert j2["found"] == j["results"][0]["found"]


def test_search_batch_endpoint_validation(server):
    r, j = _post(server, "/api/search_batch", {"queries": []})
    assert r.status == 400
    r, j = _post(server, "/api/search_batch", {})
    assert r.status == 400
    r, j = _post(server, "/api/search_batch", {"queries": [{"k": 3}]})
    assert r.status == 200
    assert j["results"][0]["error"] == "each query needs q"


def test_search_batch_k_stoi_parity(server):
    payload = {
        "queries": [
            {"q": "covid", "k": "2abc"},
            {"q": "covid", "k": 2.9},
            {"q": "covid", "k": "xyz"},
            {"q": "vaccine trial", "k": 2},
        ]
    }
    r, j = _post(server, "/api/search_batch", payload)
    assert r.status == 200
    res = j["results"]
    assert res[0]["k"] == 2 and res[1]["k"] == 2
    assert res[2]["error"] == "invalid k param"
    assert res[3]["query"] == "vaccine trial" and "error" not in res[3]
    r2, _ = _get(server, "/api/search?q=covid&k=2abc")
    assert r2.status == 200


@pytest.mark.parametrize("mode", MODES)
def test_search_batch_native_render(tmp_path, mode):
    """With config.native_render the batch route streams pre-rendered
    fragments, the single route converts to the reference dict shape, and
    the values match the Python render."""
    if not native.available():
        pytest.skip("native library unavailable")

    d = tmp_path / "index"
    _two_segment_index(d)
    engine = Engine(d, config=replace(_config(mode), native_render=True),
                    cache_dir=tmp_path, device="cpu")
    assert engine.reload()
    ctx = ServerContext(
        engine,
        StatsTracker(tmp_path / "stats.json"),
        FeedbackManager(tmp_path / "feedback.json"),
        AzureOpenAIConfig("", "", ""),
    )
    srv = _start(ctx)
    try:
        sv = (srv, ctx)
        payload = {"queries": [{"q": "covid vaccine", "k": 3},
                               {"q": "influenza", "k": 2}]}
        r, j = _post(sv, "/api/search_batch", payload)
        assert r.status == 200
        assert [x["query"] for x in j["results"]] == ["covid vaccine", "influenza"]
        first = j["results"][0]
        assert first["cached"] is False and first["found"] >= 1
        assert first["results"][0]["cord_uid"] == "uid01"
        assert first["results"][0]["title"] == "COVID Vaccine Trial"
        assert first["results"][0]["url"] == "https://a.example/1"
        assert first["results"][0]["author"] == "Smith et al."
        r2, j2 = _post(sv, "/api/search_batch", payload)
        second = j2["results"][0]
        assert second["cached"] is True
        assert second["results"] == first["results"]
        r3, j3 = _get(sv, "/api/search?q=covid+vaccine&k=3")
        assert r3.status == 200 and j3["cached"] is True
        assert j3["results"] == first["results"]
        assert "search_time_ms" in j3 and "total_time_ms" in j3
    finally:
        _stop(srv, ctx)


# ------------------------------------------------ tests/test_api_hybrid.py


@pytest.fixture(scope="module", params=MODES)
def hybrid_server(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"apihy_{request.param}")
    d = tmp / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": "h1", "text": "covid vaccine trial"},
        {"cord_uid": "h2", "text": "covid corona outbreak"},
        {"cord_uid": "h3", "text": "banana bread recipe"},
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nh1,One\nh2,Two\nh3,Three\n")
    rng = np.random.default_rng(2)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak", "banana",
             "bread", "recipe"]
    lines = [t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
             for t in terms]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    engine = _engine(d, request.param, tmp)
    assert engine.reload() and engine.sem.enabled
    ctx = ServerContext(
        engine, StatsTracker(tmp / "stats.json"),
        FeedbackManager(tmp / "feedback.json"), AzureOpenAIConfig(),
    )
    srv = _start(ctx)
    yield srv, ctx
    _stop(srv, ctx)


def test_hybrid_param_served(hybrid_server):
    r, j = _get(hybrid_server, "/api/search?q=covid&k=3&hybrid=1")
    assert r.status == 200
    assert j["hybrid"] is True
    assert j["cached"] is False and j["search_time_ms"] >= 0
    assert all("hybrid_score" in x for x in j["results"])
    r2, j2 = _get(hybrid_server, "/api/search?q=covid&k=3&hybrid=1")
    assert j2["cached"] is True and j2["hybrid"] is True


def test_hybrid_and_plain_caches_are_separate(hybrid_server):
    _get(hybrid_server, "/api/search?q=vaccine&k=3")
    r, j = _get(hybrid_server, "/api/search?q=vaccine&k=3&hybrid=1")
    assert j["cached"] is False and j.get("hybrid") is True
    r, j2 = _get(hybrid_server, "/api/search?q=vaccine&k=3")
    assert j2["cached"] is True and "hybrid" not in j2
    assert hybrid_server[1].engine.cache.get("vaccine|3|hybrid") is not None


# --------------------------------------------------- tests/test_degraded.py


def _small_index(tmp_path, name="index"):
    d = tmp_path / name
    (d / "segments").mkdir(parents=True)
    docs = [{"cord_uid": "u1", "text": "covid vaccine"}]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nu1,T\n")
    return d


@pytest.mark.parametrize("mode", MODES)
def test_semantic_silently_disabled_without_embeddings(tmp_path, monkeypatch, mode):
    monkeypatch.delenv("EMBEDDINGS_PATH", raising=False)
    e = _engine(_small_index(tmp_path), mode, tmp_path)
    assert e.reload()
    assert not e.sem.enabled
    assert e.search("covid", 10)["found"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_bad_embeddings_file_disables_semantic(tmp_path, monkeypatch, mode):
    monkeypatch.delenv("EMBEDDINGS_PATH", raising=False)
    d = _small_index(tmp_path)
    (d / "embeddings.vec").write_text("garbage no vectors here\n")
    e = _engine(d, mode, tmp_path)
    assert e.reload()
    assert not e.sem.enabled
    assert e.search("covid", 10)["found"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_reload_failure_keeps_previous_index(tmp_path, mode):
    d = _small_index(tmp_path)
    e = _engine(d, mode, tmp_path)
    assert e.reload()
    assert e.search("covid", 10)["found"] == 1
    save_manifest(d / "manifest.bin", ["seg_999999"])
    assert not e.reload()
    j = e.search("vaccine", 10)
    assert j["found"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_missing_metadata_csv_searches_without_fields(tmp_path, mode):
    d = _small_index(tmp_path)
    (d / "metadata.csv").unlink()
    e = _engine(d, mode, tmp_path)
    assert e.reload()
    j = e.search("covid", 10)
    assert j["found"] == 1
    r = j["results"][0]
    assert "title" not in r and "url" not in r


def test_structured_logging(capsys, monkeypatch):
    from nextsearch_tpu_torch.utils import logging as nslog

    monkeypatch.setenv("NEXTSEARCH_LOG_JSON", "1")
    nslog.log("reload", "loaded", segments=3)
    err = capsys.readouterr().err
    rec = json.loads(err.strip())
    assert rec["tag"] == "reload" and rec["segments"] == 3

    monkeypatch.delenv("NEXTSEARCH_LOG_JSON")
    monkeypatch.setenv("NEXTSEARCH_LOG_LEVEL", "error")
    nslog.log("cache", "hidden info")
    assert capsys.readouterr().err == ""
    nslog.error("cache", "shown")
    assert "[cache] shown" in capsys.readouterr().err


# ---------------------------------- the Engine cases of test_pipeline_serving


@pytest.fixture(params=MODES)
def engine(request, tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": f"u{i}", "text": f"covid vaccine term{i % 7} alpha beta study{i % 11}"}
        for i in range(60)
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    e = _engine(d, request.param, tmp_path)
    assert e.reload()
    return e


def test_two_phase_matches_blocking(engine):
    reqs = [(f"covid term{i % 7}", 10) for i in range(8)]
    expect = engine.search_batch(list(reqs))
    state = engine.search_batch_async(list(reqs))
    got = engine.search_batch_gather(state)
    for e_res, g_res in zip(expect, got):
        assert g_res["query"] == e_res["query"]
        assert g_res.get("found") == e_res.get("found")
        assert [r["cord_uid"] for r in g_res["results"]] == [
            r["cord_uid"] for r in e_res["results"]
        ]


def test_overlapping_launches_in_flight(engine):
    a = [(f"covid term{i % 7}", 5) for i in range(4)]
    b = [(f"vaccine study{i % 11}", 5) for i in range(6)]
    expect_a = [r["query"] for r in engine.search_batch(list(a))]
    expect_b = [r["query"] for r in engine.search_batch(list(b))]
    a2 = [(q, 4) for q, _ in a]
    b2 = [(q, 4) for q, _ in b]
    sa = engine.search_batch_async(a2)
    sb = engine.search_batch_async(b2)
    ra = engine.search_batch_gather(sa)
    rb = engine.search_batch_gather(sb)
    assert [r["query"] for r in ra] == expect_a
    assert [r["query"] for r in rb] == expect_b
    for r in ra + rb:
        if r["results"]:
            assert r["results"][0]["score"] > 0


def test_pipelined_batcher_correct_routing(engine):
    cfg = BatchingConfig(max_batch=16, window_ms=5.0, pipeline_depth=2)
    batcher = SearchBatcher(engine, cfg)
    try:
        queries = [f"covid term{i % 7} study{i % 11}" for i in range(50)]
        results = {}
        errs = []

        def worker(q):
            try:
                results[q] = batcher.search(q, 10)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(q,)) for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs
        assert len(results) == len(set(queries))
        for q, res in results.items():
            assert res["query"] == q
            direct = engine.search(q, 10)
            assert res.get("found") == direct.get("found")
    finally:
        batcher.shutdown()


def test_submit_many_slices_results(engine):
    cfg = BatchingConfig(max_batch=8, window_ms=2.0, pipeline_depth=2)
    batcher = SearchBatcher(engine, cfg)
    try:
        reqs = [(f"covid term{i % 7}", 3) for i in range(20)]
        out = batcher.search_many(reqs)
        assert len(out) == 20
        for (q, _k), res in zip(reqs, out):
            assert res["query"] == q
    finally:
        batcher.shutdown()


@pytest.mark.parametrize("mode", MODES)
def test_warmup_terminates_on_tiny_lexicon(tmp_path, mode):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [{"cord_uid": f"u{i}", "text": "covid covid vaccines"} for i in range(4)]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    e = _engine(d, mode, tmp_path)
    assert e.reload()
    assert e.warmup(sizes=[2]) > 0
