"""The torch port's Engine and HTTP server on the CPU against the JAX Engine
in sparse mode, the port's independence from jax and from the JAX package,
and the synthetic bench corpus copy against bench.py."""

import ast
import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from nextsearch_tpu.api import ai as jai
from nextsearch_tpu.api import feedback as jfeedback
from nextsearch_tpu.api import server as jserver
from nextsearch_tpu.api import stats as jstats
from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.engine import Engine as JaxEngine
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.api import ai as tai
from nextsearch_tpu_torch.api import feedback as tfeedback
from nextsearch_tpu_torch.api import server as tserver
from nextsearch_tpu_torch.api import stats as tstats
from nextsearch_tpu_torch.engine import Engine as TorchEngine

from test_engine import DOCS_SEG1, DOCS_SEG2, METADATA_CSV

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# df >= 2 terms get dense rows at this ratio, so both kernel paths run
SPARSE_CFG = EngineConfig(device=DeviceConfig(mode="sparse",
                                              dense_df_ratio=1 / 1024))
PORT_CFG = tconfig.EngineConfig(device=tconfig.DeviceConfig(
    mode="sparse", dense_df_ratio=1 / 1024))
QUERIES = ["covid", "covid+vaccine", "flu", "coronavirus+covid",
           "vaccine+trial+results", "nosuchword", "covid+flu+dynamics"]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_api") / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(DOCS_SEG1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(DOCS_SEG2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(METADATA_CSV)
    return d


def _serve(engine, cache, api):
    """Serve engine through one package's HTTP front: api is (server, stats,
    feedback, ai) of the JAX package or of the port."""
    server, stats, feedback, ai = api
    assert engine.reload()
    ctx = server.ServerContext(engine, stats.StatsTracker(cache / "stats.json"),
                               feedback.FeedbackManager(cache / "feedback.json"),
                               ai.AzureOpenAIConfig("", "", ""))
    srv = server.make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, ctx


JAX_API = (jserver, jstats, jfeedback, jai)
PORT_API = (tserver, tstats, tfeedback, tai)


def _get(srv, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    for key in ("search_time_ms", "total_time_ms"):
        body.pop(key, None)
    return r.status, body


def test_http_search_bodies_equal_jax_engine(index_dir, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _serve(JaxEngine(index_dir, config=SPARSE_CFG,
                           cache_dir=tmp_path / "jax"), tmp_path / "jax",
                 JAX_API)
    port = _serve(TorchEngine(index_dir, config=PORT_CFG,
                              cache_dir=tmp_path / "torch", device="cpu"),
                  tmp_path / "torch", PORT_API)
    try:
        assert port[1].engine.index.n_dense > 0
        assert _get(port[0], "/api/health") == _get(ref[0], "/api/health")
        hits = 0
        for q in QUERIES:
            st1, b1 = _get(port[0], f"/api/search?q={q}&k=5")
            st2, b2 = _get(ref[0], f"/api/search?q={q}&k=5")
            assert st1 == st2 == 200
            assert b1 == b2, q
            hits += len(b1["results"])
        assert hits > 10
        for q in ("cov", "vac", "the+co", "influenzas", "zz"):
            st1, b1 = _get(port[0], f"/api/suggest?q={q}&k=3")
            st2, b2 = _get(ref[0], f"/api/suggest?q={q}&k=3")
            assert st1 == st2 == 200 and b1 == b2, q
        assert b1["suggestions"] == [] and _get(
            port[0], "/api/suggest?q=co&k=3")[1]["suggestions"] == [
                "covid", "coronavirus"]
        for path, method, body in (
            ("/api/search", "GET", None),            # 400: missing q
            ("/api/suggest", "GET", None),           # 400: missing q
            ("/api/nosuchroute", "GET", None),       # 404
            ("/api/nosuchroute", "POST", b"{}"),     # 404
            ("/api/search?q=covid&k=abc", "GET", None),  # 500: stoi
            ("/api/feedback", "POST", b"{not json"),
            ("/api/feedback", "POST", b'{"type": "anonymous"}'),
            ("/api/feedback", "POST",
             b'{"message": "x", "type": "replyable"}'),
            ("/api/feedback", "POST",
             b'{"message": "great", "type": "anonymous"}'),
        ):
            got = _get(port[0], path, method, body)
            assert got == _get(ref[0], path, method, body), (path, body)
        st1, b1 = _get(port[0], "/api/stats")
        st2, b2 = _get(ref[0], "/api/stats")
        assert st1 == st2 == 200 and sorted(b1) == sorted(b2)
        assert b1["total_feedback_count"] == b2["total_feedback_count"] == 1
    finally:
        for srv, ctx in (ref, port):
            srv.shutdown()
            ctx.batcher.shutdown()


def _write_embeddings(path):
    """Clustered 16-dim vectors for the index's terms (and one it lacks):
    in-cluster cosines about 0.7, so queries expand."""
    clusters = [["covid", "coronavirus", "transmission", "dynamics"],
                ["vaccine", "immunity", "efficacy", "influenza"],
                ["trial", "results", "study", "absent"]]
    r = np.random.default_rng(21)
    lines = []
    for terms in clusters:
        centre = r.normal(size=16)
        for t in terms:
            v = centre + 0.65 * r.normal(size=16)
            lines.append(t + " " + " ".join(f"{x:.6f}" for x in v))
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def _same_body(got, want):
    """Equal bodies, scores within rtol 1e-5: the expansion weights come
    from similarities that the two packages sum in different orders."""
    got, want = dict(got), dict(want)
    for body in (got, want):
        body.pop("cache_lookup_ms", None)  # a time
    gr, wr = got.pop("results"), want.pop("results")
    assert got == want
    assert [{**r, "score": 0, "hybrid_score": 0} for r in gr] == [
        {**r, "score": 0, "hybrid_score": 0} for r in wr]
    for a, b in zip(gr, wr):
        assert a["score"] == pytest.approx(b["score"], rel=1e-5, abs=0)
        if "hybrid_score" in b:
            assert a["hybrid_score"] == a["score"]


@pytest.mark.parametrize("embeddings", [False, True])
def test_hybrid_param_answers_the_reference_body(index_dir, tmp_path,
                                                 embeddings, monkeypatch):
    """?hybrid=1 reaches search_hybrid. With no embeddings file it answers
    200 with the plain BM25 result, as the reference does when it has no
    semantic index. With one, both packages expand every query and
    ?hybrid=1 answers 200 with the reference's body ("hybrid": true,
    hybrid_score), cached under "{q}|{K}|hybrid"."""
    monkeypatch.delenv("EMBEDDINGS_PATH", raising=False)
    if embeddings:
        emb = tmp_path / "glove.txt"
        _write_embeddings(emb)
        monkeypatch.setenv("EMBEDDINGS_PATH", str(emb))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _serve(JaxEngine(index_dir, config=SPARSE_CFG,
                           cache_dir=tmp_path / "jax"), tmp_path / "jax",
                 JAX_API)
    eng = TorchEngine(index_dir, config=PORT_CFG, cache_dir=tmp_path / "torch",
                      device="cpu")
    srv, ctx = _serve(eng, tmp_path / "torch", PORT_API)
    try:
        assert eng.sem.enabled == ref[1].engine.sem.enabled == embeddings
        for q in QUERIES:
            st, plain = _get(srv, f"/api/search?q={q}&k=5")
            st2, plain_ref = _get(ref[0], f"/api/search?q={q}&k=5")
            assert st == st2 == 200
            _same_body(plain, plain_ref)
            st, body = _get(srv, f"/api/search?q={q}&k=5&hybrid=1")
            st2, body_ref = _get(ref[0], f"/api/search?q={q}&k=5&hybrid=1")
            assert st == st2 == 200
            _same_body(body, body_ref)
            if embeddings:
                assert body["hybrid"] is True
                assert eng.cache.get(f"{q.replace('+', ' ')}|5|hybrid") is not None
            else:
                assert "hybrid" not in body and body["results"] == plain["results"]
        if embeddings:
            # expansion adds terms: "covid" alone finds uid03 through
            # "coronavirus"
            st, b = _get(srv, "/api/search?q=covid&k=5")
            assert {r["cord_uid"] for r in b["results"]} == {"uid01", "uid03"}
            assert eng._weighted_terms(["covid"])[0] == ("covid", 1.0)
            assert len(eng._weighted_terms(["covid"])) > 1
    finally:
        for s, c in ((srv, ctx), ref):
            s.shutdown()
            c.batcher.shutdown()


def test_engine_rejects_mesh_and_other_modes(index_dir, tmp_path):
    """A mesh is no longer refused: it serves from a ShardedIndex (its
    device defaults to the mesh's first); an Engine with neither a device
    nor a mesh is."""
    from nextsearch_tpu_torch.parallel import ShardedIndex, make_mesh

    with pytest.raises(TypeError, match="device or a mesh"):
        TorchEngine(index_dir, cache_dir=tmp_path)
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    eng = TorchEngine(index_dir, cache_dir=tmp_path, mesh=mesh)
    assert eng.device == torch.device("cpu")
    assert eng.reload() and isinstance(eng.index, ShardedIndex)
    assert eng.search("covid", 5)["found"] > 0
    # every mode of the reference loads; an unknown one is refused
    eng = TorchEngine(index_dir, config=tconfig.EngineConfig(),
                      cache_dir=tmp_path, device="cpu")
    assert eng.reload() and eng.index.config.device.mode == "fused"
    bad = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode="dense"))
    with pytest.raises(ValueError, match="unknown device mode"):
        TorchEngine(index_dir, config=bad, cache_dir=tmp_path,
                    device="cpu").reload()


def test_server_main_refuses_bad_arguments_with_usage(capsys):
    """The server's main refuses an unknown --mode (naming the four it
    takes), a --mode without a value, a --mesh that is not dp,seg, and a
    missing index directory (usage)."""
    from nextsearch_tpu_torch.api.server import main

    assert main(["--mode", "dense", "x"]) == 1
    assert "fused|sparse|exact|fast" in capsys.readouterr().err
    assert main(["--mode"]) == 1
    assert main(["--mesh", "1x1", "x"]) == 1
    assert "dp,seg" in capsys.readouterr().err
    assert main([]) == 1
    assert "Usage" in capsys.readouterr().err


_NO_JAX = r"""
import sys
# any `import jax` or `import nextsearch_tpu...` now raises ImportError
sys.modules["jax"] = None
sys.modules["nextsearch_tpu"] = None
from pathlib import Path
import importlib
import pkgutil
import numpy as np
import nextsearch_tpu_torch
from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

names = [m.name for m in pkgutil.walk_packages(nextsearch_tpu_torch.__path__,
                                               "nextsearch_tpu_torch.")]
assert {"nextsearch_tpu_torch.benchmarks.kernel_probe",
        "nextsearch_tpu_torch.benchmarks.sharded_overhead",
        "nextsearch_tpu_torch.index.planner",
        "nextsearch_tpu_torch.api.server",
        "nextsearch_tpu_torch.parallel.mesh",
        "nextsearch_tpu_torch.parallel.sharded",
        "nextsearch_tpu_torch.parallel.dryrun",
        "nextsearch_tpu_torch.native"} <= set(names), names
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
importlib.import_module("profile_paths")

seg, probs = build_corpus(3000, 400)
cfg = EngineConfig(device=DeviceConfig(mode="sparse", posting_block=64,
                                       dense_df_ratio=1 / 64))
ti = TorchIndex([seg], config=cfg, device="cpu")
assert ti.n_dense > 0
res = ti.search_batch(sample_queries(probs, 32, 32)[0], k=10)
assert sum(r.found for r in res) > 0
import torch
from nextsearch_tpu_torch.parallel import ShardedIndex, make_mesh
si = ShardedIndex([seg, seg], make_mesh(1, 2, devices=["cpu", "cpu"]),
                  config=cfg)
assert [r.found for r in si.search_batch(sample_queries(probs, 32, 32)[0],
                                         k=10)] == [2 * r.found for r in res]

d = Path(sys.argv[1]) / "index"
(d / "segments").mkdir(parents=True)
docs = [{"cord_uid": f"u{i}", "text": "covid vaccine trial " * (i % 3 + 1)
         + f"word{i}"} for i in range(40)]
write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
save_manifest(d / "manifest.bin", ["seg_000001"])
eng = Engine(d, cache_dir=Path(sys.argv[1]), device="cpu")
assert eng.reload()
out = eng.search("covid trial", 5)
assert out["found"] == 40 and len(out["results"]) == 5
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "nextsearch_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("NO_JAX_OK")
"""

# The port's program files: its package, chip_smoke.py and profile_paths.py.
PORT_FILES = sorted((REPO / "nextsearch_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_paths.py"]


def _imported_roots(path):
    """The top-level package of every import in a file, relative imports
    resolved against its own package."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel = path.relative_to(REPO).parts
                roots.add(rel[0] if len(rel) > 1 else node.module or "")
            else:
                roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_jax_package():
    """No file of the port imports jax or nextsearch_tpu, at any depth of
    the file (function-level imports included)."""
    assert len(PORT_FILES) > 40
    bad = {str(p.relative_to(REPO)): sorted(r & {"jax", "jaxlib", "nextsearch_tpu"})
           for p in PORT_FILES
           if _imported_roots(p) & {"jax", "jaxlib", "nextsearch_tpu"}}
    assert not bad, bad


def test_port_runs_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


_BENCH = r"""
import sys
import numpy as np
import bench
seg, probs = bench.build_corpus(2000, 500)
batches = bench.sample_queries(probs, 48, 16)
np.savez(sys.argv[1], post_doc=seg.post_doc, post_tf=seg.post_tf,
         post_score=seg.post_score, term_df=seg.term_df,
         term_offsets=seg.term_offsets, doc_len=seg.doc_len,
         avgdl=np.float64(seg.avgdl), probs=probs,
         queries=np.array(repr(batches)))
"""


def test_synthetic_corpus_equals_bench(tmp_path):
    """tools/synthetic.py gives bench.py's arrays from the same seeds
    (bench.py runs in a subprocess: importing it configures jax)."""
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    out = tmp_path / "bench.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH, str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    seg, probs = build_corpus(2000, 500)
    for name in ("post_doc", "post_tf", "post_score", "term_df",
                 "term_offsets", "doc_len"):
        assert np.array_equal(getattr(seg, name), ref[name]), name
    assert seg.avgdl == float(ref["avgdl"])
    assert np.array_equal(probs, ref["probs"])
    assert repr(sample_queries(probs, 48, 16)) == str(ref["queries"])
