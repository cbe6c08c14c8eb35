"""The port's tracer (utils/profiling.Tracer, GLOBAL_TRACER) and the spans
and counters on its served path, on the CPU: totals and counters always,
records only while it records (start/stop, or a torch.profiler session,
whose Chrome trace then holds the spans), the ring's bound, parents and
batch ids; a SearchBatcher over a small Engine, whose launches each give
one span of every layer, nested as the layers are, under one batch id;
the LRU cache's counters; and /api/stats?timings=1."""

import http.client
import json
import threading

import pytest
import torch

from nextsearch_tpu_torch.api.ai import AzureOpenAIConfig
from nextsearch_tpu_torch.api.batching import SearchBatcher
from nextsearch_tpu_torch.api.caches import LRUCache
from nextsearch_tpu_torch.api.feedback import FeedbackManager
from nextsearch_tpu_torch.api.server import ServerContext, make_server
from nextsearch_tpu_torch.api.stats import StatsTracker
from nextsearch_tpu_torch.config import BatchingConfig, DeviceConfig, EngineConfig
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER, Tracer

torch.set_num_threads(1)

WORDS = ["covid", "vaccine", "trial", "flu", "immunity", "transmission",
         "efficacy", "study", "dynamics", "virus", "mask", "dose"]
DOCS = [{"cord_uid": f"u{i}",
         "text": " ".join(WORDS[(i * j) % len(WORDS)] for j in range(1, 9))}
        for i in range(40)]
# the spans of one launch and its gather, each with the span around it
LAYERS = {
    "engine.launch": None,
    "engine.prepare": "engine.launch",
    "index.launch": "engine.launch",
    "index.plan": "index.launch",
    "index.enqueue": "index.launch",
    "engine.gather": None,
    "index.gather": "engine.gather",
    "index.wait": "index.gather",
    "index.unpack": "index.gather",
    "engine.render": "engine.gather",
}


def _named(records, name):
    return [r for r in records if r.name == name]


@pytest.fixture
def tracer():
    """GLOBAL_TRACER, emptied, recording; stopped and emptied after."""
    GLOBAL_TRACER.reset()
    GLOBAL_TRACER.start()
    try:
        yield GLOBAL_TRACER
    finally:
        GLOBAL_TRACER.stop()
        GLOBAL_TRACER.reset()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing") / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(DOCS), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    return d


@pytest.mark.parametrize("n", [1, 3])
def test_off_keeps_totals_and_counters_but_no_records(n):
    tr = Tracer()
    assert not tr.recording()
    for _ in range(n):
        with tr.span("a"):
            with tr.span("b"):
                pass
        tr.count("c", 2)
    tr.add("d", 0, 5_000_000)
    rep = tr.report()
    assert set(rep) == {"spans", "counters"}
    assert rep["spans"]["a"]["count"] == rep["spans"]["b"]["count"] == n
    assert rep["spans"]["a"]["total_ms"] >= rep["spans"]["b"]["total_ms"] >= 0
    assert rep["spans"]["d"] == {"count": 1, "total_ms": 5.0}
    assert rep["counters"] == {"c": 2 * n}
    assert tr.records() == []


def test_records_carry_times_thread_parent_and_batch():
    tr = Tracer()
    tr.start()
    bid = tr.new_batch()
    with tr.batch(bid):
        with tr.span("outer"):
            with tr.span("inner"):
                pass
    with tr.span("alone"):
        pass
    got = {}

    def other_thread():
        got["thread"] = threading.get_ident()
        with tr.span("other"):
            pass

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    tr.stop()
    with tr.span("after"):
        pass
    inner, outer, alone, other = tr.records()
    assert (inner.name, inner.parent, inner.batch) == ("inner", "outer", bid)
    assert (outer.name, outer.parent, outer.batch) == ("outer", None, bid)
    assert (alone.parent, alone.batch) == (None, None)
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert outer.t1_ns < alone.t0_ns
    assert inner.thread == outer.thread == threading.get_ident()
    assert (other.thread, other.parent) == (got["thread"], None)
    assert other.thread != inner.thread
    assert tr.report()["spans"]["after"]["count"] == 1
    assert tr.records(t0_ns=alone.t0_ns) == [alone, other]
    assert tr.records(t1_ns=outer.t1_ns) == [inner, outer]
    assert tr.records(inner.t0_ns, inner.t1_ns) == [inner, outer]


@pytest.mark.parametrize("ring,n", [(4, 10), (8, 8), (3, 1)])
def test_ring_keeps_the_newest_records(ring, n):
    tr = Tracer(ring=ring)
    tr.start()
    for i in range(n):
        with tr.span(f"s{i}"):
            pass
    assert [r.name for r in tr.records()] == [
        f"s{i}" for i in range(max(0, n - ring), n)]
    assert sum(v["count"] for v in tr.report()["spans"].values()) == n


def test_a_span_closes_when_its_body_raises():
    tr = Tracer()
    tr.start()
    with pytest.raises(ValueError):
        with tr.span("outer"):
            with tr.span("fails"):
                raise ValueError("body")
    with tr.span("next"):
        pass
    fails, outer, nxt = tr.records()
    assert (fails.name, fails.parent) == ("fails", "outer")
    assert nxt.parent is None  # the stack was unwound
    assert tr.report()["spans"]["fails"]["count"] == 1


def test_a_profiler_session_records_and_holds_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer()
    with tr.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tr.recording()
        with tr.span("traced.outer"):
            with tr.span("traced.inner"):
                torch.arange(1024, dtype=torch.float32).sum()
    assert not tr.recording()
    assert [r.name for r in tr.records()] == ["traced.inner", "traced.outer"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"traced.outer", "traced.inner"} <= ann
    assert "before" not in ann


def _engine(index_dir, tmp_path, mode="fused"):
    engine = Engine(index_dir, EngineConfig(device=DeviceConfig(mode=mode)),
                    cache_dir=tmp_path, device="cpu")
    assert engine.reload()
    return engine


@pytest.mark.parametrize("mode", ["fused", "sparse"])
def test_batcher_launches_give_one_span_per_layer(index_dir, tmp_path,
                                                  tracer, mode):
    engine = _engine(index_dir, tmp_path, mode)
    batcher = SearchBatcher(engine, BatchingConfig(
        max_batch=8, small_batch=0, window_ms=20.0, pipeline_depth=2))
    try:
        # distinct multi-term texts: no cache hit, no 1-term shortcut
        units = [[(f"{WORDS[i % 12]} {WORDS[(i + 5) % 12]} "
                   f"{WORDS[(i + j + 1) % 12]}", 5) for j in range(3)]
                 for i in range(6)]
        futs = [batcher.submit_many(u) for u in units]
        assert all(len(f.result(timeout=60)) == 3 for f in futs)
    finally:
        batcher.shutdown()
    recs = tracer.records()
    queue = _named(recs, "search-batcher.queue")
    assert len(queue) == len(units)
    bids = {r.batch for r in _named(recs, "engine.launch")}
    assert len(bids) >= 2 and None not in bids  # 18 queries, batches of 8
    assert {r.batch for r in queue} == bids
    assert len(_named(recs, "search-batcher.form")) == len(bids)
    launch_at = {r.batch: r.t0_ns for r in _named(recs, "engine.launch")}
    for r in queue:
        assert r.t0_ns <= r.t1_ns <= launch_at[r.batch]
    for bid in bids:
        mine = [r for r in recs if r.batch == bid]
        for name, parent in LAYERS.items():
            (r,) = _named(mine, name)
            assert r.parent == parent, name
        (launch,) = _named(mine, "engine.launch")
        (plan,) = _named(mine, "index.plan")
        (enq,) = _named(mine, "index.enqueue")
        assert launch.t0_ns <= plan.t0_ns <= plan.t1_ns <= enq.t0_ns
        assert enq.t1_ns <= launch.t1_ns
        assert {r.thread for r in mine if r.name in LAYERS} == {
            launch.thread}
    assert not _named(recs, "device.idle")  # no card


def test_lru_counts_hits_misses_evictions_and_flushes(tmp_path, tracer):
    cache = LRUCache(2, tmp_path / "c.json", save_interval=2, tag="t-cache")
    assert cache.get("a|1") is None
    for key in ("a|1", "b|1", "c|1"):  # c evicts a; the 2nd put flushes
        cache.put(key, {"query": key})
    assert cache.get("a|1") is None
    assert cache.get("c|1")["from_cache"] is True
    cache.put("c|1", {"query": "again"})  # an update: no eviction
    cache.save()
    counters = tracer.report()["counters"]
    assert {k: v for k, v in counters.items() if k.startswith("t-cache.")} == {
        "t-cache.hits": 1, "t-cache.misses": 2, "t-cache.evictions": 1,
        "t-cache.flushes": 2}
    flushes = _named(tracer.records(), "t-cache.flush")
    assert len(flushes) == 2 and (tmp_path / "c.json").exists()


def test_engine_caches_have_their_own_tags(index_dir, tmp_path):
    engine = Engine(index_dir, EngineConfig(), cache_dir=tmp_path,
                    device="cpu")
    assert [engine.cache.tag, engine.ai_overview_cache.tag,
            engine.ai_summary_cache.tag] == [
        "search-cache", "overview-cache", "summary-cache"]


def test_stats_timings_report_spans_counters_and_graphs(index_dir, tmp_path):
    GLOBAL_TRACER.reset()
    engine = _engine(index_dir, tmp_path)
    ctx = ServerContext(engine, StatsTracker(tmp_path / "stats.json"),
                        FeedbackManager(tmp_path / "feedback.json"),
                        AzureOpenAIConfig("https://fake.example", "key", "m"))
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=30)
        conn.request("GET", path)
        body = json.loads(conn.getresponse().read())
        conn.close()
        return body

    try:
        for _ in range(2):
            assert get("/api/search?q=covid+vaccine&k=3")["query"]
        timings = get("/api/stats?timings=1")["engine_timings"]
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.batcher.shutdown()
        ctx.suggest_batcher.shutdown()
    assert set(timings) == {"spans", "counters", "launch_graphs"}
    for name in ("engine.launch", "engine.prepare", "index.plan",
                 "index.enqueue", "index.wait", "engine.render",
                 "search-batcher.queue"):
        assert timings["spans"][name]["count"] >= 1, name
    assert timings["counters"]["search-cache.misses"] >= 1
    assert timings["counters"]["search-cache.hits"] >= 1
    assert set(timings["launch_graphs"]) == {"captures", "replays"}
    assert not any("p50_ms" in v for v in timings["spans"].values())
