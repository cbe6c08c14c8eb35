"""The torch port's sharded backend (nextsearch_tpu_torch/parallel/) on the
CPU: every case of tests/test_sharded.py on the port, over a mesh of CPU
entries (a device may appear more than once in the grid), and the port's
ShardedIndex against the JAX one on the same segments, on the 8 virtual
JAX CPU devices that conftest.py sets up: builds, plans, pins, slot bases
and results (scores bit for bit, doc slots, found) in the fused, sparse and
exact modes, and with bf16 dense rows."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.parallel.mesh import make_mesh as jax_mesh
from nextsearch_tpu.parallel.sharded import ShardedIndex as JaxSharded
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.index.oracle import oracle_search
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.parallel.mesh import Mesh, make_mesh
from nextsearch_tpu_torch.parallel.sharded import ShardedIndex

from conftest import make_synthetic_docs

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def cpu_mesh(dp, seg):
    return make_mesh(dp=dp, seg=seg, devices=CPU8[:dp * seg])


def port_config(cfg=None):
    """The port's EngineConfig holding a reference EngineConfig's fields."""
    if cfg is None:
        return tconfig.EngineConfig()
    return tconfig.EngineConfig(
        device=tconfig.DeviceConfig(**dataclasses.asdict(cfg.device)))


def _cfg(**kw):
    return EngineConfig(device=DeviceConfig(**kw))


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(60, 200, seed=10)),
        build_segment_arrays(make_synthetic_docs(90, 200, seed=11, avg_len=40)),
        build_segment_arrays(make_synthetic_docs(40, 200, seed=12, avg_len=80)),
        build_segment_arrays(make_synthetic_docs(75, 200, seed=13)),
        build_segment_arrays(make_synthetic_docs(25, 200, seed=14)),
    ]


QUERIES = [
    [("w0000", 1.0)],
    [("w0001", 1.0), ("w0005", 1.0)],
    [("w0002", 1.0), ("w0013", 0.42), ("w0190", 0.6)],
    [("nosuchterm", 1.0)],
    [("w0199", 1.0)],
    [("w0003", 0.9), ("w0004", 0.8)],
]


def _random_queries(seed, n):
    r = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(200)]
    return [
        [(words[int(r.integers(0, 200))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(n)
    ]


def _oracle_parity(si, segs, queries, k=10):
    oracle_segs = [s.to_oracle_segment() for s in segs]
    results = si.search_batch(queries, k=k)
    for terms, res in zip(queries, results):
        hits, total_found = oracle_search(oracle_segs, terms, k=k)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(
            hits, res.scores, res.doc_slots
        ):
            assert si.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_score) == np.float32(o_score), terms
    return results


# ---------------------------------------------------------------- mesh


def test_make_mesh_defaults_and_errors():
    m = make_mesh(devices=CPU8)
    assert m.shape == {"dp": 1, "seg": 8} and len(m.devices[0]) == 8
    assert make_mesh(dp=2, devices=CPU8).shape == {"dp": 2, "seg": 4}
    assert make_mesh(seg=2, devices=CPU8).shape == {"dp": 4, "seg": 2}
    with pytest.raises(ValueError, match="3x3 != 8"):
        make_mesh(dp=3, seg=3, devices=CPU8)
    with pytest.raises(ValueError):
        Mesh([[torch.device("cpu")], []])
    if not torch.cuda.is_available():  # no CPU fallback without devices=
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)


# ------------------------------------------- tests/test_sharded.py, ported


@pytest.mark.parametrize(
    "dp,seg,mode",
    [
        (1, 8, "fused"), (2, 4, "fused"), (4, 2, "fused"), (2, 4, "exact"),
        (1, 8, "sparse"), (2, 4, "sparse"), (4, 2, "sparse"),
    ],
)
def test_sharded_matches_oracle(segs, dp, seg, mode):
    cfg = port_config(_cfg(mode=mode, posting_block=64, chunk_buckets=(64, 256)))
    si = ShardedIndex(segs, cpu_mesh(dp, seg), config=cfg)
    covered = []
    for lo, hi in si.shard_seg_ranges:
        covered.extend(range(lo, hi))
    assert covered == list(range(len(segs)))
    _oracle_parity(si, segs, QUERIES)


def test_sharded_matches_single_device(segs):
    si = ShardedIndex(segs, cpu_mesh(2, 4), config=port_config())
    ti = TorchIndex(segs, config=port_config(), device="cpu")
    rs = si.search_batch(QUERIES, k=10)
    rd = ti.search_batch(QUERIES, k=10)
    for a, b in zip(rs, rd):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        # same (segment, doc) despite different global slot layouts
        assert [si.locate(int(x)) for x in a.doc_slots] == [
            ti.locate(int(x)) for x in b.doc_slots
        ]


def test_more_shards_than_segments():
    segs = [build_segment_arrays(make_synthetic_docs(30, 100, seed=20))]
    si = ShardedIndex(segs, cpu_mesh(1, 8), config=port_config())
    res = si.search_batch([[("w0000", 1.0)]], k=10)[0]
    oracle_hits, found = oracle_search(
        [segs[0].to_oracle_segment()], [("w0000", 1.0)], k=10)
    assert res.found == found
    assert len(res.scores) == len(oracle_hits)


def test_sharded_dense_rows_parity(segs):
    """Force the dense-row (heavy term) path on the sharded fused step."""
    cfg = port_config(_cfg(mode="fused", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.003))
    si = ShardedIndex(segs, cpu_mesh(2, 4), config=cfg)
    assert si.n_dense > 0
    _oracle_parity(si, segs, QUERIES)


def test_sharded_async_pipeline(segs):
    """Depth-2 in-flight launches return the same results as blocking calls."""
    si = ShardedIndex(segs, cpu_mesh(2, 4), config=port_config())
    h1 = si.search_batch_async(QUERIES[:3], k=10)
    h2 = si.search_batch_async(QUERIES[3:], k=10)
    got = si.search_batch_gather(h1) + si.search_batch_gather(h2)
    want = si.search_batch(QUERIES[:3], k=10) + si.search_batch(QUERIES[3:], k=10)
    for a, b in zip(got, want):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)


def test_common_index_interface(segs):
    """iter_lexicons / slot_capacity / segment_slot_bases agree across index
    types."""
    si = ShardedIndex(segs, cpu_mesh(2, 4), config=port_config())
    ti = TorchIndex(segs, config=port_config(), device="cpu")
    terms_s, terms_d = set(), set()
    for lex in si.iter_lexicons():
        terms_s.update(lex.keys())
    for lex in ti.iter_lexicons():
        terms_d.update(lex.keys())
    assert terms_s == terms_d
    for idx in (si, ti):
        assert idx.slot_capacity > 0
        bases = idx.segment_slot_bases()
        assert len(bases) == len(segs)
        for seg_i, base in enumerate(bases):
            assert idx.locate(base) == (seg_i, 0)
            assert idx.doc_info(base) == (idx.seg_names[seg_i],
                                          segs[seg_i].cord_uids[0], 0)
    assert si.doc_info_batch(np.asarray(si.segment_slot_bases()[:2])) == [
        si.doc_info(b) for b in si.segment_slot_bases()[:2]]
    hbm = si.hbm_bytes()
    assert hbm["total"] == sum(v for k, v in hbm.items() if k != "total") > 0


def test_sharded_engine_warmup(tmp_path, segs):
    """Engine.warmup() works against a mesh-backed (sharded) index and pins
    the probed envelopes (pin_shapes(scope_q=True))."""
    from nextsearch_tpu_torch.engine import Engine
    from nextsearch_tpu_torch.index.segmentio import write_segment

    segdir = tmp_path / "segments"
    for i, seg in enumerate(segs[:2]):
        write_segment(seg, segdir / f"seg_{i + 1:06d}")
    eng = Engine(tmp_path, mesh=cpu_mesh(2, 4), cache_dir=tmp_path)
    assert eng.reload() and isinstance(eng.index, ShardedIndex)
    assert eng.warmup(n_queries=2) > 0
    assert eng.index._qpins, "warmup must pin the probed envelopes"
    res = eng.search("w0000 w0001", 5)
    assert res["found"] > 0 and res["results"]


@pytest.mark.parametrize("eps", [2e-3, 1e9])
def test_sharded_fast_heavy_guard(segs, eps):
    """The sharded guarded fast path (per-shard packed_impl, guards
    min-merged across shards): eps=1e9 trips every non-trivial query and
    the whole batch relaunches over the full table (24 trips > the rescue
    cap); both must match the oracle exactly."""
    cfg = port_config(_cfg(mode="sparse", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.02,
                           fast_heavy=True, fast_heavy_eps=eps))
    si = ShardedIndex(segs, cpu_mesh(2, 4), config=cfg)
    _oracle_parity(si, segs, _random_queries(43, 24))
    if eps > 1:
        assert si.relaunches == 1


def test_sharded_guard_trip_host_rescue(segs, monkeypatch):
    """With the rescue cap raised, every tripped query is re-scored by the
    host oracle with GLOBAL shard-major slot mapping (segment_slot_bases)
    instead of the relaunch: bit-exact."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    cfg = port_config(_cfg(mode="sparse", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.02,
                           fast_heavy=True, fast_heavy_eps=1e9))
    si = ShardedIndex(segs, cpu_mesh(1, 8), config=cfg)
    queries = _random_queries(47, 16) + [[("w0000", 1.0)], [("nosuchterm", 1.0)]]
    _oracle_parity(si, segs, queries)
    assert si.rescue_trips > 0 and si.relaunches == 0


def test_sharded_row_topk_shortcut_parity(segs):
    """1-term head-heavy queries answered host-side from the per-shard row
    top-k are oracle-exact, including inside a mixed batch and at w != 1;
    the shortcut does not fire for duplicate-term or multi-term queries."""
    cfg = port_config(_cfg(mode="sparse", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.02))
    si = ShardedIndex(segs, cpu_mesh(2, 2), config=cfg)
    assert si._row_topk is not None
    elig = sorted(
        t for t, (off, cnt) in si._lex_slices.items()
        if (si._lex_table[off: off + cnt, 3] >= 0).all()
    )
    assert elig, "fixture must produce all-shard-heavy terms"
    t0 = elig[0]
    q, fills = si._shortcut_single_heavy([[(t0, 1.0)], [(t0, 0.7)]], 10)
    assert fills is not None and 0 in fills and q[0] == []
    _q2, fills2 = si._shortcut_single_heavy(
        [[(t0, 1.0), (t0, 0.5)], [(t0, 1.0), (elig[-1], 1.0)]], 10)
    assert fills2 is None
    queries = [[(t, 1.0)] for t in elig[:5]]
    queries += [[(t0, 0.7)], [(t0, 2.5)], [(t0, 1.0), ("w0150", 0.6)]]
    queries += [[("w0150", 1.0)], [("nosuchterm", 1.0)]]
    _oracle_parity(si, segs, queries)


def test_sharded_light_topk_shortcut_parity(segs):
    """1-term all-shard-LIGHT queries answered host-side from the per-shard
    per-(term, segment) posting top-k are oracle-exact (multi- and
    fewest-occurrence terms, w != 1, df above the prefix width); k above
    the prefix, duplicate-term and mixed heavy/light terms keep the kernel
    path."""
    cfg = port_config(_cfg(mode="sparse", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.02))
    si = ShardedIndex(segs, cpu_mesh(2, 2), config=cfg)
    assert si._light_topk is not None
    kl = si._light_topk[0].shape[2]
    occ = {t: si._lex_table[off: off + cnt]
           for t, (off, cnt) in si._lex_slices.items()}
    light = sorted(t for t, ent in occ.items() if (ent[:, 3] < 0).all())
    assert light, "fixture must produce all-light terms"
    multi = [t for t in light if len(occ[t]) >= 2]
    assert multi, "fixture must produce multi-occurrence light terms"
    single = sorted(light, key=lambda t: len(occ[t]))[:3]
    big = sorted((t for t in light if int(occ[t][:, 2].max()) > kl),
                 key=lambda t: -int(occ[t][:, 2].max()))
    mixed = sorted(t for t, ent in occ.items()
                   if (ent[:, 3] >= 0).any() and (ent[:, 3] < 0).any())

    q, fills = si._shortcut_single_heavy([[(multi[0], 1.0)]], 10)
    assert fills is not None and q[0] == []
    assert si._shortcut_single_heavy([[(multi[0], 1.0)]], kl + 1)[1] is None
    assert si._shortcut_single_heavy(
        [[(multi[0], 1.0), (multi[0], 0.5)]], 10)[1] is None
    if mixed:
        assert si._shortcut_single_heavy([[(mixed[0], 1.0)]], 10)[1] is None
    queries = (
        [[(t, 1.0)] for t in multi[:3] + single[:3]]
        + [[(multi[0], 0.7)], [(single[0], 2.5)]]
        + [[(multi[0], 1.0), ("w0002", 0.6)]]
        + ([[(big[0], 1.0)], [(big[0], 0.9)]] if big else [])
        + ([[(mixed[0], 1.0)]] if mixed else [])
    )
    _oracle_parity(si, segs, queries)


def test_sharded_probe_applies_shortcut(segs):
    """pin_shapes' workload probe excludes shortcut-eligible 1-term
    queries, so an all-eligible batch pins the minimum C/L budgets."""
    cfg = port_config(_cfg(mode="sparse", posting_block=64,
                           chunk_buckets=(64, 256), dense_df_ratio=0.02))
    si = ShardedIndex(segs, cpu_mesh(2, 2), config=cfg)
    elig = sorted(
        t for t, (off, cnt) in si._lex_slices.items()
        if (si._lex_table[off: off + cnt, 3] < 0).all()
        or (si._lex_table[off: off + cnt, 3] >= 0).all()
    )
    batch = [[(t, 1.0)] for t in elig[:24]]
    stripped, fills = si._shortcut_single_heavy(batch, 10)
    assert fills is not None and len(fills) == len(batch)
    assert all(q == [] for q in stripped)
    ((_qb, pins),) = si.pin_shapes([batch], scope_q=True).items()
    assert pins["C"] == 128  # c_pad floor: nothing reached the plan
    raw_pi, _ub = si.plan_sparse(batch)
    tb = raw_pi.shape[2] // 7
    assert si._chunk_budget(raw_pi[:, :, tb: 2 * tb],
                            si.config.device.posting_block) > 1


# ------------------------------------------- against the JAX ShardedIndex


def _jax_pair(segs, dp, seg, cfg):
    jmesh = jax_mesh(dp=dp, seg=seg, devices=jax.devices()[:dp * seg])
    return (JaxSharded(segs, jmesh, config=cfg),
            ShardedIndex(segs, cpu_mesh(dp, seg), config=port_config(cfg)))


def _np(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def _jnp(x):
    """A JAX array as numpy, bf16 as its int16 bit patterns."""
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _check_build(ref, port):
    """The two builds hold the same tables, shard by shard."""
    assert port.shard_seg_ranges == ref.shard_seg_ranges
    assert port.shard_capacity == ref.shard_capacity
    assert (port.n_dense, port.n_light, port._bs_depth) == (
        ref.n_dense, ref.n_light, ref._bs_depth)
    assert port.lex == ref.lex
    assert port._lex_slices == ref._lex_slices
    assert np.array_equal(port._lex_table, ref._lex_table)
    rows = ref.n_dense + 1
    ref_dense = _jnp(ref.dense_rows).reshape(port.n_shards, -1, port.shard_capacity)
    for s in range(port.n_shards):
        tab = port._tables[s][torch.device("cpu")]
        nd = _np(tab.dense_rows)
        assert np.array_equal(nd[:rows], ref_dense[s, :rows])
        assert not nd[rows:].any()
        pd = np.asarray(ref.post_doc)[s]
        assert np.array_equal(_np(tab.post_doc), pd[:tab.post_doc.numel()])
        if ref.light_bucket_pos is not None:
            assert np.array_equal(_np(tab.light_bucket_pos),
                                  np.asarray(ref.light_bucket_pos)[s])
        if ref.bucket_pos is not None:
            assert np.array_equal(_np(tab.bucket_pos)[:rows],
                                  np.asarray(ref.bucket_pos)[s])
    # the row top-k from the postings equals the reference's from the rows
    # on every live entry (the reference pads with zero-score slots, the
    # port with slot 2^30)
    assert (port._row_topk is None) == (ref._row_topk is None)
    for pr, rr in zip(port._row_topk or [], ref._row_topk or []):
        assert (pr is None) == (rr is None)
        if pr is not None:
            assert np.array_equal(pr[0], rr[0])
            live = rr[0] > 0
            assert np.array_equal(pr[1][live], rr[1][live])
    assert (port._light_topk is None) == (ref._light_topk is None)
    if port._light_topk is not None:
        for a, b in zip(port._light_topk, ref._light_topk):
            assert np.array_equal(a, b)


def _same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.found == b.found
        assert np.array_equal(a.scores.view(np.uint32), b.scores.view(np.uint32))
        assert np.array_equal(a.doc_slots, b.doc_slots)


def _jax_parity(segs, dp, seg, cfg):
    ref, port = _jax_pair(segs, dp, seg, cfg)
    _check_build(ref, port)
    assert port.segment_slot_bases() == ref.segment_slot_bases()
    batches = [QUERIES + _random_queries(s, 18) for s in (51, 52)]
    for b in batches:  # unpinned plans
        for a, w in zip(port.plan(b), ref.plan(b)):
            assert np.array_equal(a, w)
        (pa, ua), (pw, uw) = port.plan_sparse(b), ref.plan_sparse(b)
        assert ua == uw and np.array_equal(pa, pw)
    assert port.probe_workload(batches) == ref.probe_workload(batches)
    assert port.pin_shapes(batches, scope_q=True) == ref.pin_shapes(
        batches, scope_q=True)
    for b in batches:  # pinned plans and results
        for a, w in zip(port.plan(b), ref.plan(b)):
            assert np.array_equal(a, w)
        (pa, ua), (pw, uw) = port.plan_sparse(b), ref.plan_sparse(b)
        assert ua == uw and np.array_equal(pa, pw)
        _same_results(port.search_batch(b, k=10), ref.search_batch(b, k=10))
    _oracle_parity(port, segs, batches[0])


@pytest.mark.parametrize("dp,seg", [(2, 4), (1, 1)])
@pytest.mark.parametrize("mode", ["fused", "sparse", "exact"])
def test_equal_to_jax_sharded_index(segs, dp, seg, mode):
    """Builds, plan() and plan_sparse() (unpinned and pinned), the workload
    probe, pin_shapes(scope_q=True), segment_slot_bases and results equal
    the JAX ShardedIndex's, bit for bit."""
    ratio = 0.02 if mode == "sparse" else 0.003
    cfg = _cfg(mode=mode, posting_block=64, chunk_buckets=(64, 256),
               dense_df_ratio=ratio)
    _jax_parity(segs, dp, seg, cfg)


def test_equal_to_jax_sharded_index_bf16_rows(segs):
    """bf16 dense rows: one row per (term, segment), the heavy bucket table
    and the v2 rescore; every table and result equal to the JAX index's."""
    cfg = _cfg(mode="sparse", posting_block=64, chunk_buckets=(64, 256),
               dense_df_ratio=0.02, dense_rows_bf16=True)
    _jax_parity(segs, 2, 4, cfg)


@functools.lru_cache(maxsize=None)
def _hybrid_segs():
    return (build_segment_arrays(make_synthetic_docs(70, 120, seed=30)),
            build_segment_arrays(make_synthetic_docs(50, 120, seed=31)))


@pytest.mark.parametrize("mode", ["fused", "sparse"])
def test_hybrid_over_sharded_index(mode, tmp_path):
    """HybridIndex over a ShardedIndex: a fused handle reranks on the
    device; sparse handles take "hybrid_host" (gathered on the host, then
    reranked). Both equal _host_hybrid_row."""
    from nextsearch_tpu_torch.models.hybrid import HybridIndex
    from nextsearch_tpu_torch.models.semantic import SemanticIndex

    segs = list(_hybrid_segs())
    r = np.random.default_rng(5)
    terms = sorted({t for s in segs for t in s.terms})
    emb = tmp_path / "emb.vec"
    emb.write_text("".join(t + " " + " ".join(f"{x:.5f}" for x in r.normal(size=12))
                           + "\n" for t in terms))
    sem = SemanticIndex(device="cpu")
    assert sem.load_from_text(str(emb), set(terms))
    cfg = port_config(_cfg(mode=mode, posting_block=64, chunk_buckets=(64, 256),
                           dense_df_ratio=0.02))
    si = ShardedIndex(segs, cpu_mesh(1, 2), config=cfg)
    hy = HybridIndex(si, sem, beta=0.5)
    queries = [[("w0000", 1.0), ("w0003", 0.5)], [("w0007", 1.0)],
               [("w0001", 1.0), ("w0050", 0.8)], [("nosuchterm", 1.0)]]
    # 32 candidates: a K bucket, so the fused launch's K is the C of
    # _host_hybrid_row
    h = hy.search_batch_async(queries, k=5, candidates=32)
    assert h[0] == ("hybrid" if mode == "fused" else "hybrid_host")
    got = hy.search_batch_gather(h)
    for q, res in zip(queries, got):
        exp = hy._host_hybrid_row(q, 5, 32)
        assert res.found == exp.found
        assert res.doc_slots.tolist() == exp.doc_slots.tolist()
        assert np.allclose(res.scores, exp.scores, rtol=2e-5, atol=0)
