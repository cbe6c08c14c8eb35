"""End-to-end HTTP serving from the torch port's Engine over a (2,4) mesh of
CPU entries (a ShardedIndex): the cases of tests/test_api_mesh.py on the
port, ?hybrid=1 over a sparse mesh index (the "hybrid_host" path) against
the JAX Engine's body on the same index, the multi-device dry run on CPU
entries, and a tiny run of the port's sharded_overhead.py."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.engine import Engine as JaxEngine
from nextsearch_tpu.parallel.mesh import make_mesh as jax_mesh
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.api.ai import AzureOpenAIConfig
from nextsearch_tpu_torch.api.feedback import FeedbackManager
from nextsearch_tpu_torch.api.server import ServerContext, make_server
from nextsearch_tpu_torch.api.stats import StatsTracker
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch.models import hybrid as thybrid
from nextsearch_tpu_torch.parallel.mesh import make_mesh
from nextsearch_tpu_torch.parallel.sharded import ShardedIndex

from test_torch_engine import JAX_API, PORT_API, _get as _get_body, _same_body, _serve

torch.set_num_threads(1)


def cpu_mesh(dp=2, seg=4):
    return make_mesh(dp=dp, seg=seg, devices=[torch.device("cpu")] * (dp * seg))


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_apimesh") / "index"
    (d / "segments").mkdir(parents=True)
    docs1 = [
        {"cord_uid": "m1", "text": "covid vaccine trial results"},
        {"cord_uid": "m2", "text": "covid corona outbreak"},
    ]
    docs2 = [
        {"cord_uid": "m3", "text": "vaccine efficacy study"},
        {"cord_uid": "m4", "text": "banana bread recipe"},
        {"cord_uid": "m5", "text": "covid vaccine meta analysis"},
    ]
    write_segment(build_segment_arrays(docs1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(docs2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(
        "cord_uid,title,url\n"
        "m1,Trial,http://a\nm2,Outbreak,http://b\nm3,Efficacy,http://c\n"
        "m4,Bread,http://d\nm5,Meta,http://e\n"
    )
    rng = np.random.default_rng(3)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak", "banana",
             "bread", "recipe", "efficacy", "study", "meta", "analysis",
             "results"]
    lines = [t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
             for t in terms]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")
    return d


@pytest.fixture(scope="module")
def server(index_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_apimesh_srv")
    engine = Engine(index_dir, mesh=cpu_mesh(), cache_dir=tmp)
    assert engine.reload() and engine.sem.enabled
    assert isinstance(engine.index, ShardedIndex)
    assert engine.warmup(n_queries=1) > 0
    ctx = ServerContext(
        engine, StatsTracker(tmp / "stats.json"),
        FeedbackManager(tmp / "feedback.json"), AzureOpenAIConfig(),
    )
    srv = make_server(ctx, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, ctx
    srv.shutdown()
    ctx.batcher.shutdown()
    ctx.suggest_batcher.shutdown()


def _get(server, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port,
                                      timeout=120)
    conn.request("GET", path)
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    return r.status, body


def test_mesh_search_serves_with_metadata(server):
    status, j = _get(server, "/api/search?q=covid+vaccine&k=3")
    assert status == 200
    assert j["segments"] == 2 and j["found"] > 0
    uids = [r["cord_uid"] for r in j["results"]]
    # m1 and m5 contain both terms; results span both segments
    assert "m1" in uids and "m5" in uids
    segs = {r["segment"] for r in j["results"]}
    assert {"seg_000001", "seg_000002"} & segs == segs and len(segs) == 2
    by_uid = {r["cord_uid"]: r for r in j["results"]}
    assert by_uid["m1"]["title"] == "Trial" and by_uid["m1"]["url"] == "http://a"


def test_mesh_search_matches_single_device(server, tmp_path):
    """Same index, same query: mesh and single device agree bit for bit."""
    _srv, ctx = server
    eng1 = Engine(ctx.engine.index_dir, cache_dir=tmp_path, device="cpu")
    assert eng1.reload()
    _status, j = _get(server, "/api/search?q=vaccine&k=5")
    want = eng1.search("vaccine", 5)
    assert j["found"] == want["found"]
    assert [r["cord_uid"] for r in j["results"]] == [
        r["cord_uid"] for r in want["results"]]
    for a, b in zip(j["results"], want["results"]):
        assert np.float32(a["score"]) == np.float32(b["score"])


def test_mesh_suggest(server):
    status, j = _get(server, "/api/suggest?q=co")
    assert status == 200
    assert "covid" in j["suggestions"] and "corona" in j["suggestions"]
    # df summed across segments: covid (3 docs) ranks above corona (1 doc)
    assert j["suggestions"].index("covid") < j["suggestions"].index("corona")


def test_mesh_hybrid(server):
    status, j = _get(server, "/api/search?q=covid&k=3&hybrid=1")
    assert status == 200
    assert j["hybrid"] is True and j["found"] > 0
    assert all("hybrid_score" in r for r in j["results"])


def test_mesh_stats_and_cache(server):
    _get(server, "/api/search?q=outbreak&k=2")
    status, j = _get(server, "/api/search?q=outbreak&k=2")
    assert j["cached"] is True
    status, s = _get(server, "/api/stats")
    assert status == 200 and s["total_searches"] >= 1
    status, s = _get(server, "/api/stats?timings=1")
    assert status == 200 and s["index"]["hbm_bytes"]["total"] > 0


def test_mesh_cli_flag_parsing(capsys):
    """--mesh dp,seg is parsed and stripped from the positional args."""
    from nextsearch_tpu_torch.api import server as srvmod

    assert srvmod.main(["--mesh", "nonsense"]) == 1
    assert "dp,seg" in capsys.readouterr().err
    assert srvmod.main(["--mesh", "2,4"]) == 1  # no INDEX_DIR left: usage
    assert "Usage" in capsys.readouterr().err


def test_mesh_hybrid_host_body_equals_jax_engine(index_dir, tmp_path,
                                                 monkeypatch):
    """A sparse-mode mesh engine: ?hybrid=1 takes the "hybrid_host" path
    (sharded sparse handles are gathered on the host, then reranked) and
    answers the JAX mesh Engine's body on the same index; plain searches
    answer its body too."""
    monkeypatch.delenv("EMBEDDINGS_PATH", raising=False)
    cfg = EngineConfig(device=DeviceConfig(mode="sparse",
                                           dense_df_ratio=1 / 1024))
    port_cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(
        mode="sparse", dense_df_ratio=1 / 1024))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _serve(JaxEngine(index_dir, config=cfg,
                           mesh=jax_mesh(2, 4, devices=jax.devices()[:8]),
                           cache_dir=tmp_path / "jax"), tmp_path / "jax", JAX_API)
    port = _serve(Engine(index_dir, config=port_cfg, mesh=cpu_mesh(),
                         cache_dir=tmp_path / "torch"), tmp_path / "torch",
                  PORT_API)
    tags = []
    real = thybrid.HybridIndex.search_batch_async

    def spy(self, *a, **kw):
        h = real(self, *a, **kw)
        tags.append(h[0])
        return h

    monkeypatch.setattr(thybrid.HybridIndex, "search_batch_async", spy)
    try:
        assert port[1].engine.sem.enabled and ref[1].engine.sem.enabled
        for q in ("covid+vaccine", "banana+bread", "nosuchword"):
            st1, b1 = _get_body(port[0], f"/api/search?q={q}&k=3")
            st2, b2 = _get_body(ref[0], f"/api/search?q={q}&k=3")
            assert st1 == st2 == 200
            _same_body(b1, b2)
            st1, b1 = _get_body(port[0], f"/api/search?q={q}&k=3&hybrid=1")
            st2, b2 = _get_body(ref[0], f"/api/search?q={q}&k=3&hybrid=1")
            assert st1 == st2 == 200
            _same_body(b1, b2)
        assert tags and set(tags) == {"hybrid_host"}, tags
    finally:
        for srv, ctx in (ref, port):
            srv.shutdown()
            ctx.batcher.shutdown()


def test_dryrun_multichip_on_cpu_entries():
    """The multi-device dry run on eight CPU entries: the toy pass in both
    modes and the production pass on (2,4) and (1,8), oracle-exact."""
    from nextsearch_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == (2, 4) and out["meshes"] == ["(2,4)", "(1,8)"]
    assert out["devices"] == ["cpu"] * 8
    fn, args = entry("cpu")
    vals, idx, found = fn(*args)
    assert vals.shape == (8, 10) and int(found[:4].min()) > 0


def test_sharded_overhead_runs_tiny(tmp_path, monkeypatch, capsys):
    """The ported sharded_overhead.py at a tiny size on the CPU prints the
    reference's JSON line."""
    from nextsearch_tpu_torch.benchmarks import sharded_overhead

    for k, v in dict(DOCS=2000, VOCAB=400, BATCH=16, SECS=0.05, MODE="sparse",
                     DEPTH=1).items():
        monkeypatch.setenv(f"NEXTSEARCH_SHOV_{k}", str(v))
    monkeypatch.setenv("NEXTSEARCH_BENCH_CACHE", str(tmp_path))
    assert sharded_overhead.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"mode", "docs", "batch", "qps_single",
                        "qps_sharded_1x1", "overhead_pct"}
    assert out["mode"] == "sparse" and out["qps_sharded_1x1"] > 0
