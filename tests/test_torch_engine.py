"""The torch port's Engine and HTTP server on the CPU against the JAX Engine
in sparse mode, the port's independence from jax, and the synthetic bench
corpus copy against bench.py."""

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

from nextsearch_tpu.api.ai import AzureOpenAIConfig
from nextsearch_tpu.api.feedback import FeedbackManager
from nextsearch_tpu.api.server import ServerContext, make_server
from nextsearch_tpu.api.stats import StatsTracker
from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.engine import Engine as JaxEngine
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch.engine import Engine as TorchEngine

from test_engine import DOCS_SEG1, DOCS_SEG2, METADATA_CSV

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# df >= 2 terms get dense rows at this ratio, so both kernel paths run
SPARSE_CFG = EngineConfig(device=DeviceConfig(mode="sparse",
                                              dense_df_ratio=1 / 1024))
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


def _serve(engine, cache):
    assert engine.reload()
    ctx = ServerContext(engine, StatsTracker(cache / "stats.json"),
                        FeedbackManager(cache / "feedback.json"),
                        AzureOpenAIConfig("", "", ""))
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, ctx


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    conn.request("GET", path)
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
                           cache_dir=tmp_path / "jax"), tmp_path / "jax")
    port = _serve(TorchEngine(index_dir, config=SPARSE_CFG,
                              cache_dir=tmp_path / "torch", device="cpu"),
                  tmp_path / "torch")
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
        st, body = _get(port[0], "/api/suggest?q=cov")
        assert st == 200 and body["suggestions"] == []
    finally:
        for srv, ctx in (ref, port):
            srv.shutdown()
            ctx.batcher.shutdown()


def test_engine_rejects_mesh_and_other_modes(index_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        TorchEngine(index_dir, cache_dir=tmp_path, device="cpu", mesh=object())
    eng = TorchEngine(index_dir, config=EngineConfig(), cache_dir=tmp_path,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        eng.reload()


def test_server_main_requires_sparse_and_usage(capsys):
    from nextsearch_tpu_torch.api.server import main

    assert main(["--mode", "fused", "x"]) == 1
    assert main([]) == 1
    assert "Usage" in capsys.readouterr().err


_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
from pathlib import Path
import numpy as np
from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries
import nextsearch_tpu_torch.api.server
import importlib
import pkgutil
import nextsearch_tpu_torch.benchmarks as probes

names = [m.name for m in pkgutil.iter_modules(probes.__path__)]
assert {"kernel_probe", "profile_sparse", "profile_serving", "probe_fusedmm",
        "probe_bf16h", "probe_candsel"} <= set(names), names
for name in names:
    importlib.import_module(f"nextsearch_tpu_torch.benchmarks.{name}")

seg, probs = build_corpus(3000, 400)
cfg = EngineConfig(device=DeviceConfig(mode="sparse", posting_block=64,
                                       dense_df_ratio=1 / 64))
ti = TorchIndex([seg], config=cfg, device="cpu")
assert ti.n_dense > 0
res = ti.search_batch(sample_queries(probs, 32, 32)[0], k=10)
assert sum(r.found for r in res) > 0

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
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       and sys.modules[m] is not None]
# nextsearch_tpu.models is imported (by the reference Engine module the
# port subclasses) but its jax code runs only in methods the port never calls
bad += [m for m in sys.modules if m.startswith(("nextsearch_tpu.ops",
        "nextsearch_tpu.parallel", "nextsearch_tpu.index.device_build",
        "nextsearch_tpu.utils.compilecache"))]
assert not bad, bad
print("NO_JAX_OK")
"""


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
