"""The unified-totals path of the torch port (K5 ``unified_fused``,
``unified_impl``, ``exact_rescore_v4``) against nextsearch_tpu on the CPU:
the Pallas kernel in interpret mode, its XLA reference, the JAX pipeline
(use_pallas=False), the JAX DeviceIndex and the oracle.

Tolerances: totals and smax within rtol 2e-6. Entries of one (q, doc) are
summed in another order than the reference's scatter-add (the port folds a
run in stream order and adds it once), which moves a total by a few f32
ulps; where no (q, doc) has two entries they agree bit for bit. cnt,
`found` and every final packed output are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.ops import bm25_sparse as jsp
from nextsearch_tpu.ops.heavy_pallas import (
    ENT_G,
    ENT_W,
    TILE,
    unified_fused_pallas,
    unified_fused_xla,
)
from nextsearch_tpu_torch.ops import bm25_sparse as tsp
from nextsearch_tpu_torch.ops import heavy_kernels as hk
from conftest import make_synthetic_docs
from test_torch_index import MIXED, _pair, _random_queries, check
from test_torch_sparse_ops import BLOCK, K, _arrays, _queries, _statics, _t

torch.set_num_threads(1)

RTOL = 2e-6


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


@pytest.fixture(scope="module")
def di(segs):
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=BLOCK, chunk_buckets=(64, 256, 1024),
        dense_df_ratio=0.02, unified=True,
    ))
    return DeviceIndex(segs, config=cfg)


def _entries(r, Q, n_slots, *, unique):
    """Light entries sorted by (doc, q): one sub-block with several
    hundred (multi-window on the TPU), one tile with none, a boundary doc,
    and sentinel lanes (doc = n_slots) at the end."""
    docs = np.concatenate([r.integers(0, 128, size=360),
                           r.integers(TILE, 2 * TILE, size=200),
                           [TILE - 1, TILE]])
    qs = r.integers(0, Q, size=docs.size)
    if unique:
        _, keep = np.unique(docs * Q + qs, return_index=True)
        docs, qs = docs[keep], qs[keep]
    order = np.lexsort((qs, docs))
    docs, qs = docs[order].astype(np.int32), qs[order].astype(np.int32)
    vs = r.uniform(0.1, 1.0, size=docs.size).astype(np.float32)
    n = docs.size
    Np = ((n + ENT_W - 1) // ENT_W) * ENT_W + 2 * ENT_G * ENT_W
    sd = np.concatenate([docs, np.full(Np - n, n_slots, np.int32)])
    sq = np.concatenate([qs, np.zeros(Np - n, np.int32)])
    sv = np.concatenate([vs, np.zeros(Np - n, np.float32)])
    return sd, sq, sv


def _jax_unified(mix, dense, sd, sq, sv, n_slots, *, interpret):
    nw = sd.size // ENT_W
    eoff = np.searchsorted(sd, np.arange(0, n_slots + 1, TILE)).astype(np.int32)
    ent_pack = jnp.concatenate([
        jnp.asarray(sd).reshape(nw, 1, ENT_W),
        jnp.asarray(sq).reshape(nw, 1, ENT_W),
        lax.bitcast_convert_type(jnp.asarray(sv), jnp.int32).reshape(nw, 1, ENT_W),
        jnp.zeros((nw, 5, ENT_W), jnp.int32),
    ], axis=1)
    args = (jnp.asarray(mix), jnp.asarray(dense), ent_pack, jnp.asarray(eoff))
    out = (unified_fused_pallas(*args, interpret=True) if interpret
           else unified_fused_xla(*args))
    return [np.asarray(x) for x in out]


def _operands(r, Q, ND, n_slots, nnz_per_row):
    mix = np.zeros((Q, ND), np.float32)
    for q in range(Q - 1):  # the last query row stays empty
        mix[q, r.choice(ND, size=nnz_per_row, replace=False)] = r.uniform(0.2, 1.5)
    dense = np.zeros((ND, n_slots), np.float32)
    for row in range(ND):
        dense[row, r.integers(0, n_slots, size=200)] = r.uniform(0.1, 2.0, size=200)
    return mix, dense


@pytest.mark.parametrize("interpret", [True, False])
def test_unified_fused_matches_jax(interpret):
    """Against the Pallas kernel (interpret) and unified_fused_xla, with
    repeated (q, doc) entries: totals and smax within RTOL, cnt exact."""
    r = np.random.default_rng(66)
    Q, ND, n_slots = 8, 16, 3 * TILE
    mix, dense = _operands(r, Q, ND, n_slots, 2)
    sd, sq, sv = _entries(r, Q, n_slots, unique=False)
    assert np.any((sd[1:] == sd[:-1]) & (sq[1:] == sq[:-1]) & (sd[1:] < n_slots))
    tot, smax, cnt = (x.numpy() for x in hk.unified_fused(
        _t(mix), _t(dense), _t(sd), _t(sq), _t(sv), fast=False))
    rt, rs, rc = _jax_unified(mix, dense, sd, sq, sv, n_slots,
                              interpret=interpret)
    np.testing.assert_allclose(tot, rt, rtol=RTOL, atol=0)
    fin = np.isfinite(rs)
    assert np.array_equal(np.isfinite(smax), fin) and smax.shape == rs.shape
    np.testing.assert_allclose(smax[fin], rs[fin], rtol=RTOL, atol=0)
    assert np.array_equal(cnt, rc)
    assert cnt[2].sum() > 0 and np.all(cnt[3:] == 0)


def test_unified_fused_bit_exact_without_repeated_pairs():
    """One heavy term per query (the product rounds once) and no (q, doc)
    with two entries: totals, smax and cnt equal the XLA reference's bit
    for bit, in exact mode and in fast mode on bf16-exact operands."""
    r = np.random.default_rng(67)
    Q, ND, n_slots = 8, 16, 2 * TILE
    mix, dense = _operands(r, Q, ND, n_slots, 1)
    sd, sq, sv = _entries(r, Q, n_slots, unique=True)
    mix_b = _t(mix).to(torch.bfloat16).float().numpy()
    dense_b = _t(dense).to(torch.bfloat16).float().numpy()
    for fast, m, d in ((False, mix, dense), (True, mix_b, dense_b)):
        got = hk.unified_fused(_t(mix), _t(d).to(torch.bfloat16) if fast
                               else _t(d), _t(sd), _t(sq), _t(sv), fast=fast)
        ref = _jax_unified(m, d, sd, sq, sv, n_slots, interpret=False)
        for a, b in zip(got, ref):
            assert np.array_equal(a.numpy().view(np.uint32), b.view(np.uint32))


def test_unified_fused_is_product_plus_runs():
    """The plain version by its definition: K1's H plus each (q, doc)
    run's stream-order sum; sentinels never reach a tile's padding."""
    r = np.random.default_rng(68)
    Q, ND, n_slots = 4, 8, TILE
    mix, dense = _operands(r, Q, ND, n_slots, 2)
    sd = np.array([5, 5, 5, 9, n_slots, n_slots], np.int32)
    sq = np.array([1, 1, 2, 0, 3, 3], np.int32)
    sv = np.array([0.1, 0.2, 0.3, 0.4, 9.0, 9.0], np.float32)
    tot, smax, cnt = hk.unified_fused(_t(mix), _t(dense), _t(sd), _t(sq),
                                      _t(sv), fast=False)
    h, _s, _c = hk.heavy_fused3(_t(mix), _t(dense), fast=False)
    exp = h.clone()
    exp[1, 5] = h[1, 5] + (np.float32(0.1) + np.float32(0.2))
    exp[2, 5] = h[2, 5] + np.float32(0.3)
    exp[0, 9] = h[0, 9] + np.float32(0.4)
    assert torch.equal(tot, exp)
    assert torch.equal(cnt[0], (exp > 0).sum(1).float())
    assert torch.equal(smax[:16], exp.view(Q, 16, 128).amax(2).T)
    assert hk.unified_fused.launches == 0  # CPU tensors launch nothing


def test_exact_rescore_v4_matches(di):
    plan, U = di.plan_sparse(_queries(31))
    st = _statics(di, plan, U)
    a = _arrays(di)
    weights = plan[5].view(np.float32)
    r = np.random.default_rng(12)
    cand = r.integers(0, di.n_docs, size=(plan.shape[1], 2 * st["K2"]))
    cand = cand.astype(np.int32)
    ref = np.asarray(jsp.exact_rescore_v4(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        di.dense_rows, jnp.asarray(a["lbp"]), jnp.asarray(plan[0]),
        jnp.asarray(plan[2]), jnp.asarray(plan[3]), jnp.asarray(weights),
        jnp.asarray(cand), bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"],
        L2=st["L2"], lb_log2=st["lb_log2"],
    ))
    got = tsp.exact_rescore_v4(
        _t(a["post_doc"]), _t(a["post_score"]), _t(a["dense2"]), _t(a["lbp"]),
        _t(plan[0]), _t(plan[2]), _t(plan[3]), _t(weights), _t(cand).long(),
        bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"], L2=st["L2"],
        lb_log2=st["lb_log2"],
    ).numpy()
    assert (ref > 0).sum() > 20
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_packed_impl_v4_rescore_matches(di):
    """H2 unset routes the packed rescore through v4, as the reference
    does: the whole output bit-identical to the JAX packed kernel's."""
    plan, U = di.plan_sparse(_queries(32))
    st = _statics(di, plan, U)
    st["H2"] = 0
    a = _arrays(di)
    ref = np.asarray(jsp.bm25_search_sparse_packed(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(a["dense2"]).reshape(a["dense2"].shape[0], -1, 128), None,
        jnp.asarray(a["lbp"]), jnp.asarray(plan), use_pallas=False,
        use_compact=True, fast_heavy=False, **st,
    ))
    got = tsp.packed_impl(
        _t(a["post_doc"]), _t(a["post_score"]), _t(a["dense2"]), _t(a["lbp"]),
        _t(plan), use_compact=True, fast_heavy=False, **st,
    ).numpy()
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def _unified_both(di, plan, U, *, fast, dense2=None):
    st = _statics(di, plan, U)
    del st["H2"], st["lb_log2"]
    a = _arrays(di)
    dense2 = a["dense2"] if dense2 is None else dense2
    ref = np.asarray(jsp.bm25_search_sparse_unified(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(dense2).reshape(dense2.shape[0], -1, 128), None,
        jnp.asarray(a["lbp"]), jnp.asarray(plan), use_pallas=False,
        fast_heavy=fast, **st,
    ))
    got = tsp.unified_impl(
        _t(a["post_doc"]), _t(a["post_score"]), _t(dense2), _t(a["lbp"]),
        _t(plan), fast_heavy=fast, **st,
    ).numpy()
    return got, ref


def test_unified_impl_exact_bit_identical(di):
    plan, U = di.plan_sparse(_queries(33))
    got, ref = _unified_both(di, plan, U, fast=False)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 1)
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_unified_impl_fast_on_bf16_rounded_inputs(di):
    """Fast mode rounds the heavy operands to bf16, which JAX's CPU path
    does not: on a bf16-exact table and bf16-exact weights over distinct
    terms both compute the same totals, and the whole output, guard column
    included, agrees bit for bit."""
    plan, U = di.plan_sparse(
        _queries(34, weights=[0.5, 0.75, 1.0, 1.25, 1.5], distinct=True))
    dense2 = _t(_arrays(di)["dense2"]).to(torch.bfloat16).float().numpy()
    got, ref = _unified_both(di, plan, U, fast=True, dense2=dense2)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 2)
    assert ref[:, -1].sum() > 10
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("rescue", ["100", "0"])
def test_torch_index_unified_trips(segs, rescue, monkeypatch):
    """eps = 1e9 trips every non-trivial query of a unified fast launch:
    with the rescue cap raised the host oracle answers them; with no rescue
    the batch relaunches the exact full-table PACKED kernel, not K5. Both
    stay oracle-exact and equal to the JAX unified index."""
    import nextsearch_tpu_torch.index.segment as seg_mod

    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", rescue)
    calls = []
    for name in ("unified_impl", "packed_impl"):
        real = getattr(seg_mod, name)
        monkeypatch.setattr(seg_mod, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append((_n, kw["fast_heavy"],
                                          kw.get("use_compact", True)))
                            or _r(*a, **kw))
    di, ti = _pair(segs, unified=True, fast_heavy_eps=1e9)
    check(ti, segs, MIXED + _random_queries(50, n=16), di)
    if rescue == "0":
        assert ti.relaunches == 1 and ti.rescue_trips == 0
        assert calls == [("unified_impl", True, True),
                         ("packed_impl", False, False)]
    else:
        assert ti.relaunches == 0 and ti.rescue_trips > 0
        assert calls == [("unified_impl", True, True)]


def test_torch_index_unified_needs_single_launch(segs, monkeypatch):
    """Launch groups keep the packed kernel, as in the reference."""
    import nextsearch_tpu_torch.index.segment as seg_mod

    calls = []
    real = seg_mod.unified_impl
    monkeypatch.setattr(seg_mod, "unified_impl",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    di, ti = _pair(segs, unified=True, launch_group=8)
    check(ti, segs, _random_queries(51, n=19), di)
    assert calls == []
