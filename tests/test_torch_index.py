"""TorchIndex (nextsearch_tpu_torch/index/segment.py) on the CPU against the
JAX DeviceIndex and the oracle: results, plans, pins, shortcuts, guard trips
through the host rescue and the exact relaunch, multi-launch groups, the
unified launch, and the dense table against the JAX device build."""

import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.oracle import oracle_search
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu_torch.index.segment import TorchIndex

from conftest import make_synthetic_docs

torch.set_num_threads(1)

WORDS = [f"w{i:04d}" for i in range(220)]


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


def _cfg(**kw):
    base = dict(mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
                dense_df_ratio=0.02)
    base.update(kw)
    return EngineConfig(device=DeviceConfig(**base))


def _pair(segs, **kw):
    cfg = _cfg(**kw)
    return DeviceIndex(segs, config=cfg), TorchIndex(segs, config=cfg, device="cpu")


def _random_queries(seed, n=24, max_terms=5):
    r = np.random.default_rng(seed)
    return [
        [(WORDS[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, max_terms)))]
        for _ in range(n)
    ]


MIXED = [
    [("w0000", 1.0)],                      # heaviest term
    [("w0150", 1.0)],                      # light term
    [("w0001", 1.0), ("w0180", 0.7)],      # heavy + light
    [("w0002", 0.9), ("w0003", 0.8), ("w0160", 0.5)],
    [("nosuchterm", 1.0)],
    [("w0005", 1.0), ("w0005", 0.5)],      # duplicate term
    [("w0199", 1.2)],
]


def check(ti, segs, queries, di=None, k=10):
    """TorchIndex results equal the oracle's, and the JAX index's if given."""
    oracle_segs = [s.to_oracle_segment() for s in segs]
    got = ti.search_batch(queries, k=k)
    ref = di.search_batch(queries, k=k) if di is not None else None
    for i, (terms, res) in enumerate(zip(queries, got)):
        hits, found = oracle_search(oracle_segs, terms, k=k)
        assert res.found == found, terms
        assert len(res.scores) == len(hits), terms
        for (o_s, o_seg, o_doc), d_s, d_slot in zip(hits, res.scores, res.doc_slots):
            assert ti.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_s) == np.float32(o_s), terms
        if ref is not None:
            assert res.found == ref[i].found
            assert np.array_equal(res.scores, ref[i].scores)
            assert np.array_equal(res.doc_slots, ref[i].doc_slots)


@pytest.mark.parametrize("ratio", [0.02, 0.0])
def test_mixed_and_light_only_match_reference(segs, ratio):
    di, ti = _pair(segs, dense_df_ratio=ratio)
    assert (ti.n_dense > 0) == (ratio > 0)
    check(ti, segs, MIXED + _random_queries(41), di)


def test_heavy_only_single_segment():
    seg = build_segment_arrays(make_synthetic_docs(150, 30, seed=63))
    di, ti = _pair([seg], dense_df_ratio=0.001)
    assert ti.n_dense == len([d for d in seg.term_df if d > 0])
    queries = [[("w0000", 1.0)], [("w0001", 0.8), ("w0002", 0.5)],
               [("w0029", 1.0), ("w0000", 0.3)]]
    check(ti, [seg], queries, di)


@pytest.mark.parametrize("fast", [True, False])
def test_fast_and_exact_launches_match(segs, fast):
    di, ti = _pair(segs, fast_heavy=fast)
    check(ti, segs, _random_queries(42), di)


def test_plans_pins_and_tables_equal_reference(segs):
    di, ti = _pair(segs)
    for name in ("n_slots", "n_dense", "n_light", "_bs_depth", "_lb_log2"):
        assert getattr(ti, name) == getattr(di, name), name
    assert np.array_equal(ti._lex_table, di._lex_table)
    assert ti._lex_slices == di._lex_slices
    queries = _random_queries(43)
    p1, u1 = ti.plan_sparse(queries)
    p2, u2 = di.plan_sparse(queries)
    assert u1 == u2 and np.array_equal(p1, p2)
    probe = [_random_queries(s, n=16) for s in range(4)]
    assert ti.pin_shapes(probe, scope_q=True) == di.pin_shapes(probe, scope_q=True)
    assert ti.pin_shapes(probe) == di.pin_shapes(probe)
    assert ti._chunk_budget(p1[1], 64) == di._chunk_budget(p2[1], 64)
    assert ti._light_budget(p1) == di._light_budget(p2)
    assert ti._heavy_budget(p1) == di._heavy_budget(p2)
    assert np.array_equal(ti.light_bucket_pos.numpy(),
                          np.asarray(di.light_bucket_pos))
    for a, b in zip(ti._row_topk, di._row_topk):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(ti._light_topk, di._light_topk):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n_segs", [1, 3])
def test_dense_table_equals_jax_device_build(segs, n_segs):
    """Row for row equal to build_heavy_on_device's table (its extra
    group-grid rows past nd1_pad are zero)."""
    di, ti = _pair(segs[:n_segs])
    rows = ti.dense_rows.shape[0]
    ref = np.asarray(di.dense_rows).reshape(di.dense_rows.shape[0], -1)
    assert rows == ((ti.n_dense + 1 + 7) // 8) * 8
    assert np.array_equal(ti.dense_rows.numpy().view(np.uint32),
                          ref[:rows].view(np.uint32))
    assert not ref[rows:].any()
    hbm = ti.hbm_bytes()
    assert hbm["dense_rows"] == rows * ti.n_slots * 4
    assert hbm["total"] == sum(v for k, v in hbm.items() if k != "total")


def test_shortcuts_answer_host_side(segs):
    """1-term heavy and light queries come from the host tables; an
    all-shortcut batch launches nothing; mixed batches keep positions."""
    di, ti = _pair(segs)
    heavy = sorted({t for lex in ti.lex for t, v in lex.items() if v[2] >= 0})
    queries = [[(t, 1.0)] for t in heavy[:3]] + [[(heavy[0], 0.7)]]
    handle = ti.search_batch_async(queries, 10)
    assert handle[0] == "fills"
    check(ti, segs, queries, di)
    mixed = queries + [[("w0150", 1.0), ("w0180", 0.7)], [("w0160", 1.0)]]
    assert ti.search_batch_async(mixed, 10)[0] != "fills"
    check(ti, segs, mixed, di)


def test_forced_query_ordering(segs, monkeypatch):
    monkeypatch.setenv("NEXTSEARCH_SORT_QUERIES", "1")
    di, ti = _pair(segs)
    check(ti, segs, MIXED + _random_queries(44, n=12), di)


def test_guard_trips_host_rescue_and_memo(segs, monkeypatch):
    """eps=1e9 trips every non-trivial query: with the rescue cap raised
    they are rescued by the host oracle and memoized, so a repeat batch
    answers from the memo with no second rescue."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    ti = TorchIndex(segs, config=_cfg(fast_heavy_eps=1e9), device="cpu")
    queries = _random_queries(17, n=12, max_terms=4)
    first = ti.search_batch(queries, k=10)
    trips = ti.rescue_trips
    assert trips > 0 and ti._rescue_memo
    second = ti.search_batch(queries, k=10)
    assert ti.rescue_trips == trips
    for a, b in zip(first, second):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)
    check(ti, segs, queries)


def test_guard_trips_exact_relaunch(segs, monkeypatch):
    """With no host rescue allowed every tripped batch relaunches the exact
    full-table kernel; results stay oracle-exact."""
    import nextsearch_tpu_torch.index.segment as seg_mod

    calls = []

    def spy(*args, **kw):
        calls.append((kw["fast_heavy"], kw["use_compact"]))
        return packed_impl(*args, **kw)

    packed_impl = seg_mod.packed_impl
    monkeypatch.setattr(seg_mod, "packed_impl", spy)
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "0")
    ti = TorchIndex(segs, config=_cfg(fast_heavy_eps=1e9), device="cpu")
    check(ti, segs, _random_queries(47))
    assert ti.rescue_trips == 0 and ti.relaunches == 1
    assert calls == [(True, True), (False, False)]


def test_group_launches(segs):
    """A batch above launch_group runs as block-diagonal groups."""
    di, ti = _pair(segs, launch_group=8)
    queries = _random_queries(99, n=19)
    handle = ti.search_batch_async(queries, 10)
    assert handle[4].host.shape[0] == 24  # 3 groups of 8, last padded
    ti.search_batch_gather(handle)
    check(ti, segs, queries, di)


@pytest.mark.parametrize("kw,env", [
    (dict(mode="fused"), None),
    (dict(dense_rows_bf16=True), None),
    ({}, ("NEXTSEARCH_LIGHT_BUILD", "device")),
])
def test_unported_configurations_raise(segs, monkeypatch, kw, env):
    if env:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchIndex(segs, config=_cfg(**kw), device="cpu")


@pytest.mark.parametrize("fast", [True, False])
def test_unified_launch_matches_reference(segs, fast, monkeypatch):
    """unified=True takes the unified-totals launch (K5) on single
    launches; results equal the JAX unified index's and the oracle's."""
    import nextsearch_tpu_torch.index.segment as seg_mod

    calls = []
    unified_impl = seg_mod.unified_impl
    monkeypatch.setattr(seg_mod, "unified_impl",
                        lambda *a, **kw: calls.append(kw["fast_heavy"])
                        or unified_impl(*a, **kw))
    di, ti = _pair(segs, unified=True, fast_heavy=fast)
    check(ti, segs, MIXED + _random_queries(49), di)
    assert calls == [fast]
