"""The bf16-dense-rows configuration of the torch port and the packed path's
switches that ride on it, against nextsearch_tpu on the CPU:
build_heavy_on_device(bf16, with_buckets), exact_rescore_v2, packed_impl and
unified_impl over bf16 rows (heavy_direct=False), the h_bf16 H store, every
prof_skip stage, and TorchIndex(dense_rows_bf16=True) against the JAX
DeviceIndex and the oracle.

Every comparison is bit for bit: the bf16 rows are the f32 eager scores
rounded to nearest even on both sides, a bf16 x bf16 product is exact in
f32, and the rescores re-accumulate the host f32 scores in term-slot order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index import device_build as jdb
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.ops import bm25_sparse as jsp
from nextsearch_tpu_torch.index.device_build import build_heavy_on_device
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.ops import bm25_sparse as tsp
from conftest import make_synthetic_docs
from test_torch_index import MIXED, _random_queries, check
from test_torch_sparse_ops import BLOCK, K, _arrays, _queries, _statics, _t

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _segs():
    return (
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    )


def _cfg(**kw):
    base = dict(mode="sparse", posting_block=BLOCK,
                chunk_buckets=(64, 256, 1024), dense_df_ratio=0.02,
                dense_rows_bf16=True)
    base.update(kw)
    return EngineConfig(device=DeviceConfig(**base))


@functools.lru_cache(maxsize=None)
def bf16_index(n_segs: int = 3) -> DeviceIndex:
    """The JAX DeviceIndex of the bf16-rows configuration."""
    return DeviceIndex(list(_segs()[:n_segs]), config=_cfg())


def _t16(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)


def _bf16_arrays(di):
    rows = di.dense_rows.shape[0]
    return dict(
        post_doc=np.asarray(di.post_doc), post_score=np.asarray(di.post_score),
        dense3=di.dense_rows, dense2=_t16(di.dense_rows).reshape(rows, di.n_slots),
        bp=np.asarray(di.bucket_pos), lbp=np.asarray(di.light_bucket_pos),
    )


def run_packed(di, plan, U, *, use_compact, fast=False, **kw):
    """(port, reference) packed outputs of one plan on a bf16-rows index."""
    st = _statics(di, plan, U)
    st["U"] = U if use_compact else 0
    st.update(kw)
    a = _bf16_arrays(di)
    ref = np.asarray(jsp.bm25_search_sparse_packed(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]), a["dense3"],
        jnp.asarray(a["bp"]), jnp.asarray(a["lbp"]), jnp.asarray(plan),
        use_pallas=False, use_compact=use_compact, heavy_direct=False,
        fast_heavy=fast, **st,
    ))
    got = tsp.packed_impl(
        _t(a["post_doc"]), _t(a["post_score"]), a["dense2"], _t(a["lbp"]),
        _t(plan), use_compact=use_compact, heavy_direct=False, fast_heavy=fast,
        bucket_pos=_t(a["bp"]), **st,
    ).numpy()
    return got, ref


def run_unified(di, seed: int):
    """(port, reference) unified outputs of one plan on a bf16-rows index."""
    plan, U = di.plan_sparse(_queries(seed))
    st = _statics(di, plan, U)
    del st["H2"], st["lb_log2"]
    a = _bf16_arrays(di)
    ref = np.asarray(jsp.bm25_search_sparse_unified(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]), a["dense3"],
        jnp.asarray(a["bp"]), jnp.asarray(a["lbp"]), jnp.asarray(plan),
        use_pallas=False, heavy_direct=False, fast_heavy=False, **st,
    ))
    got = tsp.unified_impl(
        _t(a["post_doc"]), _t(a["post_score"]), a["dense2"], _t(a["lbp"]),
        _t(plan), heavy_direct=False, fast_heavy=False, bucket_pos=_t(a["bp"]),
        **st,
    ).numpy()
    return got, ref


# ------------------------------------------------------------ device build


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_build_heavy_on_device_matches_jax(bf16, merged):
    """Dense rows, bucket table and max occupancy equal the JAX build's;
    merged entries (two segments' postings of one term into one row) add
    their bucket counts."""
    di = bf16_index()
    post_doc, post_score = np.asarray(di.post_doc), np.asarray(di.post_score)
    lex = [(v[0], v[1]) for seg_lex in di.lex for v in seg_lex.values()
           if v[1] >= 20]
    starts = np.asarray([s for s, _ in lex], np.int64)
    dfs = np.asarray([d for _, d in lex], np.int64)
    rows = np.arange(dfs.size, dtype=np.int64) // 2 if merged else None
    n_rows_pad = ((int(dfs.size if rows is None else rows[-1] + 1) + 1 + 7) // 8) * 8
    ref_d, ref_b, ref_occ = jdb.build_heavy_on_device(
        jnp.asarray(post_doc), jnp.asarray(post_score), starts, dfs, rows=rows,
        n_rows_pad=n_rows_pad, n_slots=di.n_slots, bf16=bf16,
        with_buckets=True)
    dense, buckets, occ = build_heavy_on_device(
        _t(post_doc), _t(post_score), starts, dfs, rows=rows,
        n_rows_pad=n_rows_pad, n_slots=di.n_slots, bf16=bf16,
        with_buckets=True)
    assert dfs.size > 10 and occ == ref_occ > 1
    ref_d = np.asarray(ref_d)[:n_rows_pad]
    if bf16:
        assert dense.dtype == torch.bfloat16
        assert np.array_equal(dense.view(torch.int16).numpy(), ref_d.view(np.int16))
    else:
        assert np.array_equal(dense.numpy().view(np.uint32), ref_d.view(np.uint32))
    assert np.array_equal(buckets.numpy(), np.asarray(ref_b))
    _d, none, zero = build_heavy_on_device(
        _t(post_doc), _t(post_score), starts, dfs, rows=rows,
        n_rows_pad=n_rows_pad, n_slots=di.n_slots, bf16=bf16)
    assert none is None and zero == 0


# ------------------------------------------------------------ rescore v2


def test_exact_rescore_v2_matches():
    di = bf16_index()
    plan, U = di.plan_sparse(_queries(36))
    st = _statics(di, plan, U)
    a = _bf16_arrays(di)
    weights = plan[5].view(np.float32)
    r = np.random.default_rng(13)
    cand = r.integers(0, di.n_docs, size=(plan.shape[1], 2 * st["K2"]))
    cand = cand.astype(np.int32)
    ref = np.asarray(jsp.exact_rescore_v2(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(a["bp"]), jnp.asarray(a["lbp"]), jnp.asarray(plan[0]),
        jnp.asarray(plan[2]), jnp.asarray(plan[3]), jnp.asarray(weights),
        jnp.asarray(cand), bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"],
        lb_log2=st["lb_log2"],
    ))
    got = tsp.exact_rescore_v2(
        _t(a["post_doc"]), _t(a["post_score"]), _t(a["bp"]), _t(a["lbp"]),
        _t(plan[0]), _t(plan[2]), _t(plan[3]), _t(weights), _t(cand).long(),
        bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"],
        lb_log2=st["lb_log2"],
    ).numpy()
    assert (ref > 0).sum() > 40 and (plan[2] < st["nd"]).sum() > 10
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


# ------------------------------------------------------------ packed / unified


@pytest.mark.parametrize("use_compact", [True, False])
def test_packed_impl_over_bf16_rows_bit_identical(use_compact):
    """The compact launch gathers bf16 rows (K3 over bf16) and the
    full-table launch reads them; both round mix to bf16 and rescore by
    v2: the whole packed output equals the JAX kernel's."""
    di = bf16_index()
    plan, U = di.plan_sparse(_queries(37))
    got, ref = run_packed(di, plan, U, use_compact=use_compact)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 1)
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_packed_multi_over_bf16_rows():
    di = DeviceIndex(list(_segs()), config=_cfg(launch_group=8))
    plans, U = di._plan_groups(_queries(38, n=19), 8)
    st = _statics(di, plans[0], U)
    for g in range(1, plans.shape[0]):
        st["C"] = max(st["C"], di._chunk_budget(plans[g, 1], BLOCK))
        st["L2"] = max(st["L2"], di._light_budget(plans[g]))
    a = _bf16_arrays(di)
    ref = np.asarray(jsp.bm25_search_sparse_packed_multi(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]), a["dense3"],
        jnp.asarray(a["bp"]), jnp.asarray(a["lbp"]), jnp.asarray(plans),
        use_pallas=False, use_compact=True, heavy_direct=False, **st,
    ))
    got = tsp.packed_multi(
        _t(a["post_doc"]), _t(a["post_score"]), a["dense2"], _t(a["lbp"]),
        _t(plans), use_compact=True, heavy_direct=False,
        bucket_pos=_t(a["bp"]), **st,
    ).numpy()
    assert got.shape == (24, 2 * K + 1)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_unified_impl_over_bf16_rows_bit_identical():
    got, ref = run_unified(bf16_index(), seed=39)
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_v2_without_bucket_table_raises():
    di = bf16_index()
    plan, U = di.plan_sparse(_queries(40, n=4))
    a = _bf16_arrays(di)
    with pytest.raises(ValueError, match="bucket_pos"):
        tsp.packed_impl(_t(a["post_doc"]), _t(a["post_score"]), a["dense2"],
                        _t(a["lbp"]), _t(plan), heavy_direct=False,
                        **_statics(di, plan, U))


# ------------------------------------------------------------ h_bf16, prof_skip


@functools.lru_cache(maxsize=None)
def _f32_index():
    return DeviceIndex(list(_segs()), config=_cfg(dense_rows_bf16=False))


def _f32_operands(plan, U, use_compact, **kw):
    """The f32-rows index's arrays with a bf16-exact table, and the statics."""
    di = _f32_index()
    st = _statics(di, plan, U)
    st["U"] = U if use_compact else 0
    st.update(kw)
    a = _arrays(di)
    a["dense2"] = _t(a["dense2"]).to(torch.bfloat16).float().numpy()
    return a, st


def _port_f32(plan, U, *, use_compact=True, fast=True, **kw):
    """The port's packed output on the f32-rows index's bf16-exact table."""
    a, st = _f32_operands(plan, U, use_compact, **kw)
    return tsp.packed_impl(
        _t(a["post_doc"]), _t(a["post_score"]), _t(a["dense2"]), _t(a["lbp"]),
        _t(plan), use_compact=use_compact, fast_heavy=fast, **st,
    ).numpy()


def _run_f32(plan, U, *, use_compact=True, fast=True, **kw):
    """(port, reference) on the f32-rows index, fed a bf16-exact table and
    bf16-exact weights over distinct terms, so that the JAX CPU fast path
    (which does not round) computes the port's fast H."""
    a, st = _f32_operands(plan, U, use_compact, **kw)
    dense2 = a["dense2"]
    ref = np.asarray(jsp.bm25_search_sparse_packed(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(dense2).reshape(dense2.shape[0], -1, 128), None,
        jnp.asarray(a["lbp"]), jnp.asarray(plan), use_pallas=False,
        use_compact=use_compact, fast_heavy=fast, **st,
    ))
    return _port_f32(plan, U, use_compact=use_compact, fast=fast, **kw), ref


def _bf16_plan(seed, n=24):
    return _f32_index().plan_sparse(
        _queries(seed, n=n, weights=[0.5, 0.75, 1.0, 1.25, 1.5], distinct=True))


@pytest.mark.parametrize("use_compact", [True, False])
def test_h_bf16_matches_reference(use_compact):
    """h_bf16 under fast_heavy: H stored bf16 rounded up, read back by the
    light H gather and heavy_candidates as f32; the whole output, guard
    column included, equals the reference's bf16 branches bit for bit."""
    plan, U = _bf16_plan(41)
    got, ref = _run_f32(plan, U, use_compact=use_compact, h_bf16=True)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 2)
    assert ref[:, -1].sum() > 10
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    f32 = _port_f32(plan, U, use_compact=use_compact)
    assert np.array_equal(got[:, :2 * K + 1], f32[:, :2 * K + 1])


_SKIPS = [(name,) for name in tsp.PROF_STAGES] + [
    ("light", "hgather", "sort2"),
    ("heavy_mm", "rowgather", "light", "hgather", "sort2", "cand_heavy",
     "rescore"),
]


@pytest.mark.parametrize("skip", _SKIPS, ids=["+".join(s) for s in _SKIPS])
def test_prof_skip_stage_matches_reference(skip):
    """Each stage prof_skip drops yields what the reference yields in its
    place, so the (deliberately wrong) output equals the JAX kernel's with
    the same prof_skip, on the guarded fast launch as profile_serving.py
    runs it."""
    plan, U = _bf16_plan(42)
    got, ref = _run_f32(plan, U, prof_skip=skip)
    assert got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_prof_skip_rejects_unknown_stage():
    plan, U = _bf16_plan(43, n=4)
    with pytest.raises(ValueError, match="unknown"):
        _port_f32(plan, U, prof_skip=("nosuchstage",))


# ------------------------------------------------------------ TorchIndex


@pytest.mark.parametrize("unified", [False, True])
@pytest.mark.parametrize("n_segs", [1, 3])
def test_torch_index_bf16_rows_matches_reference(n_segs, unified):
    """TorchIndex(dense_rows_bf16=True), single and multi segment, packed
    and unified: the tables, the depth, and every result equal the JAX
    DeviceIndex's and the oracle's."""
    segs = list(_segs()[:n_segs])
    cfg = _cfg(unified=unified)
    di = DeviceIndex(segs, config=cfg)
    ti = TorchIndex(segs, config=cfg, device="cpu")
    for name in ("n_dense", "n_light", "_bs_depth", "_heavy_direct",
                 "_merged_heavy"):
        assert getattr(ti, name) == getattr(di, name), name
    assert not ti._heavy_direct and ti._row_topk is None
    rows = ti.dense_rows.shape[0]
    assert ti.dense_rows.dtype == torch.bfloat16
    assert np.array_equal(ti.dense_rows.view(torch.int16).numpy(),
                          _t16(di.dense_rows).reshape(-1, ti.n_slots)[:rows]
                          .view(torch.int16).numpy())
    assert np.array_equal(ti.bucket_pos.numpy(), np.asarray(di.bucket_pos))
    hbm = ti.hbm_bytes()
    assert hbm["dense_rows"] == rows * ti.n_slots * 2
    assert hbm["bucket_pos"] == ti.bucket_pos.numel() * 4
    assert hbm["total"] == sum(v for k, v in hbm.items() if k != "total")
    check(ti, segs, MIXED + _random_queries(52), di)


def test_torch_index_bf16_rows_take_twice_the_rows_and_no_fast_mode(monkeypatch):
    """Under a byte cap that binds, bf16 rows fit twice the f32 count; the
    guarded fast launch is off (a fast_heavy config launches exact)."""
    import nextsearch_tpu_torch.index.segment as seg_mod

    segs = list(_segs()[:1])
    cap = 6 * 4 * 2048  # six f32 rows of the 2048-slot table
    f32 = TorchIndex(segs, config=_cfg(dense_rows_bf16=False,
                                       dense_max_bytes=cap), device="cpu")
    calls = []
    real = seg_mod.packed_impl
    monkeypatch.setattr(seg_mod, "packed_impl", lambda *a, **kw: calls.append(
        (kw["fast_heavy"], kw["heavy_direct"])) or real(*a, **kw))
    ti = TorchIndex(segs, config=_cfg(dense_max_bytes=cap, fast_heavy=True),
                    device="cpu")
    assert ti.n_slots == 2048 and f32.n_dense == 6 and ti.n_dense == 12
    di = DeviceIndex(segs, config=_cfg(dense_max_bytes=cap, fast_heavy=True))
    check(ti, segs, MIXED + _random_queries(53, n=12), di)
    assert calls == [(False, False)]


def test_torch_index_bf16_rows_launch_groups():
    segs = list(_segs())
    cfg = _cfg(launch_group=8)
    di = DeviceIndex(segs, config=cfg)
    ti = TorchIndex(segs, config=cfg, device="cpu")
    check(ti, segs, _random_queries(54, n=19), di)
