"""TorchIndex in the fused (default), exact and fast modes on the CPU against
the JAX DeviceIndex and the oracle; the planner's plan/plan_full against the
JAX package's; the port's Engine and HTTP server in the default mode; and
the port's bench.py and profile_host.py at a small size, with the bench's
parity gate forced to fail.

Fused and exact results (scores, docs, found) are compared bit for bit with
both references. Fast mode's docs and `found` are equal and its scores are
held to rtol 1e-6 (one scatter, any order of adds).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.engine import Engine as JaxEngine
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.oracle import oracle_search
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.benchmarks import bench as tbench
from nextsearch_tpu_torch.benchmarks import profile_host as tprofile_host
from nextsearch_tpu_torch.engine import Engine as TorchEngine
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.ops import heavy_kernels as hk

from conftest import make_synthetic_docs
from test_torch_engine import (JAX_API, PORT_API, QUERIES, _get, _serve,
                               index_dir)  # noqa: F401 (index_dir: fixture)

torch.set_num_threads(1)

WORDS = [f"w{i:04d}" for i in range(220)]


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


@pytest.fixture(scope="module")
def one_seg():
    return [build_segment_arrays(make_synthetic_docs(300, 120, seed=7))]


def _cfg(**kw):
    base = dict(posting_block=64, chunk_buckets=(64, 256, 1024),
                dense_df_ratio=0.02)
    base.update(kw)
    return EngineConfig(device=DeviceConfig(**base))


def _pair(segs, **kw):
    cfg = _cfg(**kw)
    port = tconfig.EngineConfig(
        device=tconfig.DeviceConfig(**dataclasses.asdict(cfg.device)))
    return DeviceIndex(segs, config=cfg), TorchIndex(segs, config=port,
                                                    device="cpu")


def _queries(seed, n=16, max_terms=5):
    r = np.random.default_rng(seed)
    out = [
        [(WORDS[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, max_terms)))]
        for _ in range(n)
    ]
    return out + [
        [("w0000", 1.0)],                      # heaviest term
        [("w0001", 1.0), ("w0180", 0.7)],      # heavy + light
        [("nosuchterm", 1.0)],                 # df 0
        [],                                    # empty query
        [("w0005", 1.0), ("w0005", 0.5)],      # repeated term
        [("w0219", 1.2)],                      # fewer matches than k
    ]


def check(ti, segs, queries, di, k=10, score_rtol=0.0):
    """TorchIndex results against the oracle's and the JAX index's."""
    oracle_segs = [s.to_oracle_segment() for s in segs]
    got = ti.search_batch(queries, k=k)
    ref = di.search_batch(queries, k=k)
    n_hits = 0
    for terms, res, jres in zip(queries, got, ref):
        hits, found = oracle_search(oracle_segs, terms, k=k)
        n_hits += len(hits)
        assert res.found == found == jres.found, terms
        assert len(res.scores) == len(hits), terms
        assert res.scores.dtype == np.float32 and res.doc_slots.dtype == np.int32
        assert [ti.locate(int(d)) for d in res.doc_slots] == [
            (sg, d) for _s, sg, d in hits], terms
        assert np.array_equal(res.doc_slots, jres.doc_slots), terms
        want = np.array([s for s, _sg, _d in hits], np.float32)
        if score_rtol:
            np.testing.assert_allclose(res.scores, want, rtol=score_rtol)
            np.testing.assert_allclose(res.scores, jres.scores, rtol=score_rtol)
        else:
            assert np.array_equal(res.scores, want), terms
            assert np.array_equal(res.scores, jres.scores), terms
    assert n_hits >= len(queries) // 2


MODES = [
    ("fused", {}, 0.0),
    ("fused", {"scores_bf16": True}, 0.0),
    ("fused", {"dense_df_ratio": 0.0}, 0.0),   # no dense rows: scatter only
    ("fused", {"doc_pad": 128}, 0.0),          # n_slots not a tile multiple
    ("exact", {}, 0.0),
    ("fast", {}, 1e-6),
]


@pytest.mark.parametrize("mode,kw,rtol", MODES,
                         ids=[f"{m}-{'-'.join(k) or 'default'}" for m, k, _ in MODES])
@pytest.mark.parametrize("multi", [True, False], ids=["3seg", "1seg"])
def test_modes_match_jax_index_and_oracle(segs, one_seg, multi, mode, kw, rtol):
    ss = segs if multi else one_seg
    di, ti = _pair(ss, mode=mode, **kw)
    for name in ("n_slots", "n_dense", "n_light", "_bs_depth", "dense_threshold",
                 "n_postings"):
        assert getattr(ti, name) == getattr(di, name), name
    assert ti.light_bucket_pos is None and ti._row_topk is None
    assert ti._light_topk is None and not ti._merged_heavy
    assert (ti.n_dense > 0) == (kw.get("dense_df_ratio", 1) > 0)
    check(ti, ss, _queries(41), di, score_rtol=rtol)


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_k100_and_k1(segs, mode):
    di, ti = _pair(segs, mode=mode)
    check(ti, segs, _queries(42, n=8), di, k=100)
    check(ti, segs, _queries(43, n=8), di, k=1)


def test_dense_rows_equal_the_jax_table(segs):
    """Non-sparse modes keep per-(term, segment) rows built on the device:
    the table is bit-equal to the JAX index's, f32 and bf16."""
    for bf16 in (False, True):
        di, ti = _pair(segs, mode="fused", dense_rows_bf16=bf16)
        ref = np.asarray(di.dense_rows.astype(np.float32))
        assert ti.dense_rows.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert np.array_equal(ti.dense_rows.float().numpy(), ref)
        assert ti.bucket_pos is None
        assert ti.hbm_bytes()["total"] == sum(
            v for k, v in ti.hbm_bytes().items() if k != "total")


def test_fused_over_bf16_rows(segs):
    """bf16 dense rows change pass 1 only; the rescore keeps reported
    scores bit-exact."""
    di, ti = _pair(segs, mode="fused", dense_rows_bf16=True)
    check(ti, segs, _queries(44), di)


def test_plan_and_plan_full_equal_jax(segs):
    di, ti = _pair(segs, mode="fused")
    assert np.array_equal(ti._lex_table, di._lex_table)
    assert ti._lex_slices == di._lex_slices
    batches = [_queries(s) for s in (50, 51, 52)]
    for qs in batches:
        for a, b in zip(ti.plan_full(qs), di.plan_full(qs)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(ti.plan(qs), di.plan(qs)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # under pins (global and Q-scoped) the padded shapes stay equal
    assert ti.pin_shapes(batches, scope_q=True) == di.pin_shapes(batches,
                                                                 scope_q=True)
    assert ti.pin_shapes(T=32) == di.pin_shapes(T=32)
    for qs in batches:
        got, ref = ti.plan_full(qs), di.plan_full(qs)
        assert got[0].shape[1] == 32 and got[4].shape == ref[4].shape
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
        s, d, w, ld, _u, _m = got
        for block in (64, 2048):
            assert ti._chunk_budget(ld, block) == di._chunk_budget(ld, block)
            for a, b in zip(ti._chunk_plan(s, d, w, block),
                            di._chunk_plan(s, d, w, block)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    check(ti, segs, batches[0], di)


# Batches at the flat planner's edges, over `segs` (every term has one row
# in each of the three segments; w0000-w0009 are heavy, w0015 on light).
PLAN_EDGES = {
    # 2 terms = 6 rows, past a pinned T=4: T escapes to 8
    "past_pinned_T": ([[("w0000", 1.0), ("w0180", 0.7)], [("w0015", 0.4)]],
                      {"T": 4}),
    # one heavy row summed within and across queries, -0.0 weights included;
    # the last query's sum is 1e-8 in term order and 0 in reverse
    "repeated_heavy": ([[("w0000", 1.0), ("w0000", 0.3), ("w0000", -0.0)],
                        [("w0000", 0.7), ("w0001", 1.1), ("w0000", 2.5)],
                        [("w0001", -0.0)],
                        [("w0000", 1.0), ("w0000", -1.0), ("w0000", 1e-8)]],
                       {}),
    "all_light": ([[("w0015", 1.0), ("w0180", 0.5)], [("w0219", 1.2)],
                   [("w0017", 0.9), ("w0017", 0.9)]], {}),
    "empty_or_unknown": ([[], [("nosuchterm", 1.0)], [], [("zz", 0.5)]], {}),
    "single_query": ([[("w0001", 1.0), ("w0180", 0.7)]], {}),
    # 129 queries: past the top of Q_BUCKETS (128), so Q rounds up to 256
    "q129": (None, {}),
}


@pytest.mark.parametrize("scoped", [False, True], ids=["unpinned", "scope_q"])
@pytest.mark.parametrize("case", list(PLAN_EDGES))
def test_plan_full_edges_equal_jax_bitwise(segs, case, scoped):
    """plan_full's six arrays at the flat fill's edges are the JAX index's
    byte for byte (so -0.0 and NaN patterns count), unpinned and under
    Q-scoped pins."""
    qs, pins = PLAN_EDGES[case]
    if qs is None:
        qs = _queries(53, n=123)  # and its six fixed queries
    di, ti = _pair(segs, mode="fused")
    for idx in (ti, di):
        if pins:
            idx.pin_shapes(**pins)
        if scoped:
            idx.pin_shapes([qs], scope_q=True)
    got, ref = ti.plan_full(qs), di.plan_full(qs)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    starts, _d, weights, light_dfs, uh, mix = got
    assert starts.shape[0] == (256 if case == "q129" else
                               1 if case == "single_query" else 8)
    if case == "past_pinned_T":
        assert starts.shape[1] == 8 and (weights[0] != 0).sum() == 6
    if case == "all_light":
        assert (uh == ti.n_dense).all() and not mix.any()
    if case == "empty_or_unknown":
        assert not weights.any() and not light_dfs.any() and not mix.any()
    if case == "repeated_heavy":
        # w0000's three rows (one a segment) each get 1.0 + 0.3 + -0.0
        row0 = mix[0][mix[0] != 0]
        assert row0.size == 3 and (row0 == np.float32(1.0) + np.float32(0.3)).all()
        assert (mix[3][mix[3] != 0] == np.float32(1e-8)).sum() == 3


def test_exact_mode_is_deterministic(segs):
    """The parity mode gives the same bits on every run: within one window
    a (query, doc) cell receives at most one contribution."""
    _di, ti = _pair(segs, mode="exact")
    qs = _queries(45)
    a, b = ti.search_batch(qs, 10), ti.search_batch(qs, 10)
    for x, y in zip(a, b):
        assert x.found == y.found
        assert np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32))
        assert np.array_equal(x.doc_slots, y.doc_slots)


@pytest.mark.parametrize("mode,tag", [("fused", "packed"), ("exact", "pending"),
                                      ("fast", "pending")])
def test_handles_and_pipelining(segs, mode, tag):
    """search_batch_async's handle carries the reference's tag; two
    launches in flight gather to the serial answers; an empty batch and an
    empty index answer without a launch."""
    di, ti = _pair(segs, mode=mode)
    b1, b2 = _queries(46), _queries(47)
    h1 = ti.search_batch_async(b1, 10)
    h2 = ti.search_batch_async(b2, 10)
    assert h1[0] == tag and h1[1:4] == (len(b1), 10, 10)
    for got, qs in ((ti.search_batch_gather(h1), b1),
                    (ti.search_batch_gather(h2), b2)):
        for g, r in zip(got, di.search_batch(qs, 10)):
            assert g.found == r.found and np.array_equal(g.doc_slots, r.doc_slots)
    assert ti.search_batch_async([], 10) == ("empty", 0)
    assert ti.search_batch([], 10) == []
    empty = TorchIndex([], config=ti.config, device="cpu")
    res = empty.search_batch([[("w0000", 1.0)]], 10)
    assert len(res) == 1 and res[0].found == 0 and res[0].scores.size == 0


def test_fused_launch_gathers_through_k3(segs, monkeypatch):
    """The fused launch's heavy contribution goes through the K3 wrapper
    once per batch (its plain version on CPU tensors), over the batch's
    unique rows padded with the zero row."""
    from nextsearch_tpu_torch.ops import bm25 as tbm25

    _di, ti = _pair(segs, mode="fused")
    calls = []
    real = hk.gather_rows

    def spy(ids, table, **kw):
        calls.append((ids.clone(), table))
        return real(ids, table, **kw)

    monkeypatch.setattr(tbm25, "gather_rows", spy)
    qs = _queries(48)
    ti.search_batch(qs, 10)
    assert len(calls) == 1
    ids, table = calls[0]
    assert table is ti.dense_rows
    uh = ti.plan_full(qs)[4]
    assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), uh)
    assert (uh == ti.n_dense).any() and (uh < ti.n_dense).any()
    assert not ti.dense_rows[ti.n_dense:].any()


def test_unknown_mode_is_refused(segs):
    bad = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode="dense"))
    with pytest.raises(ValueError, match="unknown device mode"):
        TorchIndex(segs, config=bad, device="cpu")


def test_default_mode_engine_and_http_answer_as_sparse(index_dir, tmp_path):
    """The port's Engine and HTTP server in the library default (fused)
    give the bodies of the port in sparse mode and of the JAX Engine in its
    default mode."""
    assert tconfig.DEFAULT_CONFIG.device.mode == "fused"
    sparse_cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode="sparse"))
    servers = []
    for name, make in (
        ("default", lambda d: TorchEngine(index_dir, cache_dir=d, device="cpu")),
        ("sparse", lambda d: TorchEngine(index_dir, config=sparse_cfg,
                                         cache_dir=d, device="cpu")),
        ("jax", lambda d: JaxEngine(index_dir, cache_dir=d)),
    ):
        (tmp_path / name).mkdir()
        servers.append(_serve(make(tmp_path / name), tmp_path / name,
                              JAX_API if name == "jax" else PORT_API))
    try:
        assert servers[0][1].engine.index.config.device.mode == "fused"
        hits = 0
        for q in QUERIES:
            bodies = [_get(srv, f"/api/search?q={q}&k=5") for srv, _ in servers]
            assert bodies[0][0] == 200
            assert bodies[0] == bodies[1] == bodies[2], q
            hits += len(bodies[0][1]["results"])
        assert hits > 10
        eng = servers[0][1].engine
        assert eng.warmup(sizes=[1, 4]) > 0
        batch = eng.search_batch([(q.replace("+", " "), 5) for q in QUERIES])
        assert [len(b["results"]) for b in batch] == [
            len(_get(servers[2][0], f"/api/search?q={q}&k=5")[1]["results"])
            for q in QUERIES]
    finally:
        for srv, ctx in servers:
            srv.shutdown()
            ctx.batcher.shutdown()


# ------------------------------------------------------------ the bench


@pytest.fixture
def small_bench(monkeypatch):
    for k, v in dict(CACHE="0", DOCS="3000", VOCAB="800", BATCH="16",
                     SECS="0.2", LAT_BATCH="8", LAT_SECS="0.1").items():
        monkeypatch.setenv(f"NEXTSEARCH_BENCH_{k}", v)


@pytest.mark.parametrize("mode", ["sparse", "fused"])
def test_bench_prints_the_metric_line(small_bench, monkeypatch, capsys, mode):
    """On the CPU at a small size: the gate passes and the last line of
    standard output is the reference's metric object; no device number is
    stated for a CPU run."""
    monkeypatch.setenv("NEXTSEARCH_BENCH_MODE", mode)
    assert tbench.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["metric"] == "bm25_top10_qps_3k" and out["unit"] == "queries/sec"
    assert out["value"] > 0 and out["mode"] == mode
    assert out["stream_span_ms_per_batch"] is None
    assert out["peak_device_mem_gib"] is None
    assert out["latency_point"]["batch"] == 8
    assert "p50_req_ms=" in lines[-2] and "not measured" in lines[-2]
    assert "parity spot-check: OK (8 queries, exact)" in cap.err


def test_bench_config_follows_the_reference_defaults(monkeypatch):
    for name in ("DENSE", "DENSE_BYTES", "BLOCK", "HEAVYB", "K2", "BF16",
                 "UNIFIED"):
        monkeypatch.delenv(f"NEXTSEARCH_BENCH_{name}", raising=False)
    s, f = tbench.bench_config("sparse").device, tbench.bench_config("fused").device
    assert (s.dense_df_ratio, s.dense_max_bytes) == (1 / 1024, 7 << 30)
    assert (f.dense_df_ratio, f.dense_max_bytes) == (1 / 256, 2 << 30)
    for d in (s, f):
        assert (d.posting_block, d.heavy_buckets, d.rescore_margin) == (
            64, (512,), 32)
        assert not d.scores_bf16 and not d.unified
    monkeypatch.setenv("NEXTSEARCH_BENCH_BF16", "1")
    monkeypatch.setenv("NEXTSEARCH_BENCH_DENSE", "0.5")
    d = tbench.bench_config("fused").device
    assert d.scores_bf16 and d.dense_df_ratio == 0.5
    assert tbench.metric_name(1_000_000) == "bm25_top10_qps_1M"


@pytest.mark.parametrize("what", ["score", "found", "doc"])
def test_bench_refuses_a_speed_when_the_gate_fails(small_bench, monkeypatch,
                                                   capsys, what):
    """An oracle that disagrees in one score bit, one count or one doc:
    exit code 1 and no metric on standard output."""
    monkeypatch.setenv("NEXTSEARCH_BENCH_MODE", "fused")

    def wrong(segments, terms, k, **kw):
        hits, found = oracle_search(segments, terms, k, **kw)
        if what == "found":
            return hits, found + 1
        if hits and what == "score":
            s, sg, d = hits[0]
            hits[0] = (float(np.nextafter(np.float32(s), np.float32(np.inf))), sg, d)
        elif hits:
            s, sg, d = hits[-1]
            hits[-1] = (s, sg, d + 1)
        return hits, found

    monkeypatch.setattr(tbench, "oracle_search", wrong)
    assert tbench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert "metric" not in cap.out and "queries/sec" not in cap.out
    assert "parity spot-check FAILED, no speed reported" in cap.err


def test_bench_and_profile_host_need_a_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("this case is the machine without a card")
    assert tbench.main([]) == 2
    assert tprofile_host.main([]) == 2
    assert "metric" not in capsys.readouterr().out


def test_profile_host_attributes_both_modes(small_bench, monkeypatch, capsys):
    for k, v in dict(DOCS="3000", VOCAB="800", BATCH="16", ITERS="4").items():
        monkeypatch.setenv(f"NEXTSEARCH_PROF_{k}", v)
    assert tprofile_host.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for mode in ("sparse", "fused"):
        assert f"host wall attribution, mode {mode}" in out
    assert out.count("async (plan+dispatch)") == 2
    assert out.count("unpack alone") == 2
