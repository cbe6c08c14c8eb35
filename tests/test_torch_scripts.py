"""The port of the reference's remaining benchmark scripts
(nextsearch_tpu_torch/benchmarks/: load_http, probe_depth, profile_unified,
profile_1m, eval_configs, bench_tools with build_tools_index.sh,
probe_group, probe_light, probe_slicegather), each run once small with
--device cpu: it prints its JSON line with the reference's keys (or, where
the reference printed none, the keys of the lines it printed). The two
profile mirrors' "full" variants equal the serving launches bit for bit."""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.benchmarks import (
    bench_tools, eval_configs, load_http, probe_depth, probe_group,
    probe_light, probe_slicegather, profile_1m, profile_unified,
)
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = {"NEXTSEARCH_PROBE_DOCS": "3000", "NEXTSEARCH_PROBE_VOCAB": "2000",
         "NEXTSEARCH_PROF_DOCS": "3000", "NEXTSEARCH_PROF_VOCAB": "2000",
         "NEXTSEARCH_PROBE_SECS": "0.3", "NEXTSEARCH_PROBE_BATCH": "64",
         "NEXTSEARCH_PROF_BATCH": "64"}


@pytest.fixture()
def small(monkeypatch, tmp_path):
    monkeypatch.setenv("NEXTSEARCH_BENCH_CACHE", str(tmp_path / "cache"))
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    return tmp_path


def _json_lines(out: str):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A 400-doc index of w#### terms served over HTTP by a CPU Engine in
    sparse mode (the port's server main needs a card, so the server runs
    in-process as the tests' servers do)."""
    from nextsearch_tpu_torch.api import ai, feedback, server, stats
    from nextsearch_tpu_torch.engine import Engine

    tmp = tmp_path_factory.mktemp("load_http")
    r = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    docs = [{"cord_uid": f"doc{i:05d}",
             "tokens": [f"w{t:04d}" for t in r.choice(300, size=30, p=p)]}
            for i in range(400)]
    d = tmp / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(
        mode="sparse", dense_df_ratio=1 / 64))
    eng = Engine(d, config=cfg, cache_dir=tmp, device="cpu")
    assert eng.reload()
    ctx = server.ServerContext(eng, stats.StatsTracker(tmp / "stats.json"),
                               feedback.FeedbackManager(tmp / "feedback.json"),
                               ai.AzureOpenAIConfig("", "", ""))
    srv = server.make_server(ctx, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield d, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    ctx.batcher.shutdown()
    ctx.suggest_batcher.shutdown()
    th.join(timeout=30)


def test_load_http_reuse_server(served, capsys):
    """Batch and single mode against a running server: the spot-check
    holds 16 answers to the oracle, and each mode prints its line."""
    d, port = served
    assert load_http.main([
        "--reuse-server", "--port", str(port), "--index-dir", str(d),
        "--mode", "both", "--secs", "0.5", "--batch", "16", "--clients", "2",
        "--conns", "4", "--startup-timeout", "30"]) == 0
    out = capsys.readouterr()
    assert "oracle-exact" in out.err
    batch, single = _json_lines(out.out)
    assert set(batch) == {"metric", "value", "unit", "p50_req_ms", "clients",
                          "batch", "errors", "vs_baseline"}
    assert batch["metric"] == "served_qps_http_batch" and batch["value"] > 0
    assert set(single) == {"metric", "value", "unit", "p50_req_ms", "conns",
                           "errors", "vs_baseline"}
    assert single["metric"] == "served_qps_http_single"
    assert batch["errors"] == single["errors"] == 0


def test_load_http_engine_mode_and_refusals(served, capsys):
    d, _port = served
    assert load_http.main(["--mode", "engine", "--device", "cpu",
                           "--index-dir", str(d), "--secs", "0.5",
                           "--batch", "16"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "p50_req_ms", "batch",
                         "vs_baseline"}
    assert line["metric"] == "served_qps_engine_dispatcher"
    # spawning the port's server needs a card; so does engine mode on cuda
    assert load_http.main(["--index-dir", str(d)]) == 2
    assert load_http.main(["--mode", "engine", "--index-dir", str(d)]) == 2


def test_load_http_query_stream_matches_reference():
    """The bench stream is the reference's make_query_texts' strings."""
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "ref_load_http", REPO / "benchmarks" / "load_http.py")
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    finally:
        sys.path.remove(str(REPO / "benchmarks"))
    assert load_http.make_query_texts(2000, 300) == ref.make_query_texts(2000, 300)


def test_probe_depth(small, capsys, monkeypatch):
    monkeypatch.setenv("NEXTSEARCH_PROBE_DEPTHS", "2,4")
    assert probe_depth.main(["--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"probe", "device", "batch", "secs", "points"}
    assert [p["depth"] for p in line["points"]] == [2, 4]
    assert all(set(p) == {"depth", "qps", "p50_ms"} and p["qps"] > 0
               for p in line["points"])


def test_probe_group(small, capsys, monkeypatch):
    monkeypatch.setenv("NEXTSEARCH_PROBE_GROUPS", "2")
    assert probe_group.main(["--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"probe", "device", "points"}
    assert [p["path"] for p in line["points"]] == ["single", "group2"]
    assert [p["batch"] for p in line["points"]] == [512, 1024]


@pytest.mark.parametrize("script,variants", [
    (profile_unified, profile_unified.VARIANTS),
    (profile_1m, profile_1m.VARIANTS),
])
def test_profile_scripts(small, capsys, monkeypatch, script, variants):
    assert script.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    (line,) = _json_lines(out)
    assert set(line) == {"profile", "device", "batch", "ms_per_batch",
                         "device_ms_per_batch"}
    assert list(line["ms_per_batch"]) == list(variants)
    # no card: host ms only, the device column not measured
    assert set(line["device_ms_per_batch"].values()) == {None}
    assert "stage attribution" in out


def _bench_index(mode, **kw):
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(3000, 2000)
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode=mode, **kw))
    return TorchIndex([seg], config=cfg, device="cpu"), \
        sample_queries(probs, n_queries=192, batch=64)


def test_profile_unified_full_is_the_serving_launch():
    """variant_unified's "full" equals unified_impl(fast_heavy=True) bit
    for bit, and "no_entry_sort" (entries sorted before timing) too."""
    from nextsearch_tpu_torch.ops.bm25_sparse import unified_entries, unified_impl

    ti, batches = _bench_index("sparse", posting_block=64,
                               dense_df_ratio=1 / 1024, unified=True)
    plan, U = ti.plan_sparse(ti._shortcut_single_heavy(batches[0], 10)[0])
    plan = torch.from_numpy(plan)
    dcfg = ti.config.device
    st = dict(n_slots=ti.n_slots, K=10, K2=32, C=ti._chunk_budget(plan[1].numpy(), 64),
              block=64, bs_steps=ti._bs_depth, nd=ti.n_dense, nl=ti.n_light,
              U=U, L2=ti._light_budget(plan.numpy()),
              guard_eps=dcfg.fast_heavy_eps)
    args = (ti.post_doc, ti.post_score, ti.dense_rows, ti.light_bucket_pos, plan)
    want = unified_impl(*args, fast_heavy=True, **st).numpy()
    ents = unified_entries(ti.post_doc, ti.post_score, plan, C=st["C"],
                           block=64, n_slots=ti.n_slots)
    for name in ("full", "no_entry_sort"):
        got = profile_unified.variant_unified(
            *args, sorted_entries=ents, **st,
            **profile_unified.VARIANTS[name]).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), name
    assert (want[:, 10] < ti.n_slots).sum() > 32


@pytest.mark.parametrize("bf16", [False, True])
def test_profile_1m_full_is_the_fused_launch(bf16):
    """variant_kernel's "full" equals bm25_search_packed bit for bit."""
    from nextsearch_tpu_torch.ops.bm25 import bm25_search_packed

    ti, batches = _bench_index("fused", posting_block=512,
                               dense_df_ratio=1 / 256, scores_bf16=bf16)
    plans, C = profile_1m.pack_plans(ti, batches[:1], 512)
    (pi, pf), = plans
    st = dict(n_slots=ti.n_slots, K=10, K2=32, C=C, block=512,
              bs_steps=max(2, ti.n_slots.bit_length() + 1))
    args = (ti.post_doc, ti.post_score, ti.dense_rows, torch.from_numpy(pi),
            torch.from_numpy(pf))
    want = bm25_search_packed(*args, scores_bf16=bf16, **st).numpy()
    got = profile_1m.variant_kernel(*args, scores_bf16=bf16, **st).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (want[:, 20] > 0).sum() > 32


def test_eval_configs(small, capsys):
    """Every configuration at a small scale: parity held, one line each,
    written to --out and merged on a second run."""
    out = small / "out" / "eval.json"
    assert eval_configs.main(["--device", "cpu", "--scale", "0.02",
                              "--secs", "0.2", "--out", str(out)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    keys = {1: {"config", "docs", "parity", "qps", "mechanism"},
            2: {"config", "docs", "parity", "qps"},
            3: {"config", "docs", "segments", "parity", "qps"},
            4: {"config", "terms", "qps", "p50_batch64_ms", "target_qps",
                "meets_target"},
            5: {"config", "docs", "dim", "parity", "emb_build_s", "qps"}}
    assert [x["config"] for x in lines] == [1, 2, 3, 4, 5]
    for x in lines:
        assert set(x) == keys[x["config"]] | {"wall_s", "device"}
        assert x.get("parity", True) is True
    assert eval_configs.main(["--device", "cpu", "--scale", "0.02",
                              "--secs", "0.2", "--configs", "4",
                              "--out", str(out)]) == 0
    assert [x["config"] for x in json.loads(out.read_text())] == [1, 2, 3, 4, 5]
    assert eval_configs.main([]) == 2  # no card


def test_bench_tools_on_a_tools_built_index(small, capsys, monkeypatch):
    """build_tools_index.sh runs the port's CLI pipeline; bench_tools holds
    the index to the oracle and prints its line."""
    root = small / "tools"
    r = subprocess.run(
        ["bash", "nextsearch_tpu_torch/benchmarks/build_tools_index.sh",
         str(root), "400"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr
    assert (root / "index" / "segments" / "seg_000001").is_dir()
    monkeypatch.setenv("NEXTSEARCH_TOOLS_ROOT", str(root))
    monkeypatch.setenv("NEXTSEARCH_TOOLS_SECS", "0.3")
    monkeypatch.setenv("NEXTSEARCH_TOOLS_BATCH", "32")
    assert bench_tools.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity: OK" in out and "TOOLS-BUILT" in out
    (line,) = _json_lines(out)
    assert set(line) == {"metric", "value", "unit", "device", "docs",
                         "postings", "load_s", "build_s", "pins", "parity",
                         "batches", "trips", "relaunches",
                         "rescue_ms_per_batch"}
    assert line["docs"] == 400 and line["parity"] is True


@pytest.mark.parametrize("script,env,rows", [
    (probe_light, {"NEXTSEARCH_PROBE_C": "64", "NEXTSEARCH_PROBE_SLOTS": "8192"},
     14),
    (probe_slicegather, {"NEXTSEARCH_PROBE_P": "100000"}, 3),
])
def test_micro_probes(capsys, monkeypatch, script, env, rows):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert script.main(["--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["probe"] in ("light", "slicegather")
    assert len(line["ms"]) == rows and all(v >= 0 for v in line["ms"].values())


@pytest.mark.parametrize("script", [probe_depth, probe_group, profile_unified,
                                    profile_1m, probe_light, probe_slicegather,
                                    bench_tools])
def test_scripts_refuse_without_a_card(script):
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main([])
