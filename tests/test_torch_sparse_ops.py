"""Sparse pipeline of the torch port (nextsearch_tpu_torch/ops/bm25_sparse.py)
stage by stage and whole, against nextsearch_tpu/ops/bm25_sparse.py on the
CPU (use_pallas=False: the XLA references of the Pallas kernels), on plans
from the JAX DeviceIndex planner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.ops import bm25 as jbm25
from nextsearch_tpu.ops import bm25_sparse as jsp
from nextsearch_tpu.ops.heavy_pallas import heavy_fused3_xla
from nextsearch_tpu_torch.ops import bm25 as tbm25
from nextsearch_tpu_torch.ops import bm25_sparse as tsp

from conftest import make_synthetic_docs

torch.set_num_threads(1)

BLOCK = 64
K = 10


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
        dense_df_ratio=0.02,
    ))
    return DeviceIndex(segs, config=cfg)


def _queries(seed, n=24, weights=None, distinct=False):
    r = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(220)]
    out = []
    for _ in range(n):
        nt = int(r.integers(1, 5))
        ids = (r.choice(220, size=nt, replace=False) if distinct
               else r.integers(0, 220, size=nt))
        ws = (r.choice(weights, size=nt) if weights is not None
              else r.uniform(0.2, 1.5, size=nt))
        out.append([(words[int(i)], float(w)) for i, w in zip(ids, ws)])
    out[0] = [("w0000", 1.0), ("w0001", 0.5)]  # two heavy terms
    out[1] = [("w0005", 1.0), ("w0005", 0.5)]  # duplicate term
    out[2] = [("nosuchterm", 1.0)]             # empty query
    return out


def _arrays(di):
    rows = di.dense_rows.shape[0]
    dense2 = np.asarray(di.dense_rows).reshape(rows, di.n_slots)
    return dict(
        post_doc=np.asarray(di.post_doc), post_score=np.asarray(di.post_score),
        dense2=dense2, lbp=np.asarray(di.light_bucket_pos),
    )


def _statics(di, plan, U):
    K2 = min(max(2 * K, di.config.device.rescore_margin), di.n_slots)
    return dict(
        n_slots=di.n_slots, K=K, K2=K2, C=di._chunk_budget(plan[1], BLOCK),
        block=BLOCK, bs_steps=di._bs_depth, nd=di.n_dense, nl=di.n_light,
        U=U, lb_log2=di._lb_log2, L2=di._light_budget(plan),
        H2=di._heavy_budget(plan),
    )


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def staged(di):
    """One plan and the JAX pipeline's intermediate values on it."""
    plan, U = di.plan_sparse(_queries(3))
    st = _statics(di, plan, U)
    a = _arrays(di)
    Q, T = plan.shape[1:]
    weights = plan[5].view(np.float32)
    mix = np.zeros((Q, a["dense2"].shape[0]), np.float32)
    for t in range(T):
        mix[np.arange(Q), plan[2][:, t]] += weights[:, t]
    mix[:, di.n_dense] = 0.0
    H3, smax, cnt = heavy_fused3_xla(
        jnp.asarray(mix), jnp.asarray(a["dense2"]).reshape(
            mix.shape[1], di.n_slots // 128, 128)
    )
    H = np.asarray(H3).reshape(Q, di.n_slots)
    lt = jsp.light_totals(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(plan[0]), jnp.asarray(plan[1]), jnp.asarray(weights),
        C=st["C"], block=BLOCK, Q=Q, n_slots=di.n_slots,
    )
    sq, sd, stot, last = (np.asarray(x) for x in lt)
    hval = H[np.clip(sq, 0, Q - 1), np.clip(sd, 0, di.n_slots - 1)]
    valid_last = last & (sq < Q)
    sel = np.where(valid_last, stot + hval, np.float32(0)).astype(np.float32)
    return dict(plan=plan, U=U, st=st, a=a, weights=weights, H=H,
                smax=np.asarray(smax), cnt=np.asarray(cnt), sq=sq, sd=sd,
                stot=stot, last=last, hval=hval, sel=sel, Q=Q, T=T)


def test_expand_chunks_matches(staged):
    s = staged
    ref = jbm25.expand_chunks(
        jnp.asarray(s["plan"][0]), jnp.asarray(s["plan"][1]),
        jnp.asarray(s["weights"]), C=s["st"]["C"], block=BLOCK,
    )
    got = tbm25.expand_chunks(
        _t(s["plan"][0]), _t(s["plan"][1]), _t(s["weights"]),
        C=s["st"]["C"], block=BLOCK,
    )
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_light_totals_matches(staged):
    s = staged
    sq, sd, stot, last = tsp.light_totals(
        _t(s["a"]["post_doc"]), _t(s["a"]["post_score"]), _t(s["plan"][0]),
        _t(s["plan"][1]), _t(s["weights"]), C=s["st"]["C"], block=BLOCK,
        Q=s["Q"], n_slots=s["st"]["n_slots"],
    )
    assert np.array_equal(sq.numpy(), s["sq"])
    assert np.array_equal(sd.numpy(), s["sd"])
    assert np.array_equal(last.numpy(), s["last"])
    live = s["last"] & (s["sq"] < s["Q"])
    assert live.sum() > 50
    assert np.array_equal(stot.numpy()[live].view(np.uint32),
                          s["stot"][live].view(np.uint32))


def test_segmented_cumsum_bounded_left_fold():
    """Each group's lanes sum in lane order, f32 rounding at every step."""
    r = np.random.default_rng(5)
    vals = r.uniform(0.1, 10.0, 200).astype(np.float32)
    first = r.random(200) < 0.3
    first[0] = True
    ref = np.asarray(jsp._segmented_cumsum_bounded(
        jnp.asarray(vals), jnp.asarray(first), 8))
    got = tsp.segmented_cumsum_bounded(_t(vals), _t(first), 8).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_per_query_counts_matches(staged):
    s = staged
    ind = (s["last"] & (s["sq"] < s["Q"]) & (s["hval"] == 0))
    ref = np.asarray(jsp.per_query_counts(
        jnp.asarray(s["sq"]), jnp.asarray(ind), s["Q"]))
    got = tsp.per_query_counts(_t(s["sq"]), _t(ind), s["Q"]).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("quantized", [False, True])
def test_per_query_topk_flat_matches(staged, quantized):
    s = staged
    K2 = s["st"]["K2"]
    rd, rv = jsp.per_query_topk_flat(
        jnp.asarray(s["sq"]), jnp.asarray(s["sel"]), jnp.asarray(s["sd"]),
        s["Q"], K2, jnp.int32(2**30), quantized=quantized,
    )
    gd, gv = tsp.per_query_topk_flat(
        _t(s["sq"]), _t(s["sel"]), _t(s["sd"]), s["Q"], K2,
        quantized=quantized,
    )
    assert np.array_equal(gd.numpy(), np.asarray(rd))
    assert np.array_equal(gv.numpy().view(np.uint32),
                          np.asarray(rv).view(np.uint32))


def test_per_query_topk_flat_ties_break_doc_ascending():
    sq = np.array([0, 0, 0, 0, 1, 1, 2], np.int64)
    score = np.array([2.0, 3.0, 2.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    doc = np.array([9, 4, 1, 7, 5, 3, 8], np.int64)
    docs, vals = tsp.per_query_topk_flat(_t(sq), _t(score), _t(doc), 3, 4)
    assert docs.tolist() == [[4, 1, 9, 2**30], [3, 5, 2**30, 2**30],
                             [2**30] * 4]
    assert vals[0].tolist() == [3.0, 2.0, 2.0, 0.0]


def test_heavy_candidates_matches(staged):
    s = staged
    K2 = s["st"]["K2"]
    H3 = jnp.asarray(s["H"]).reshape(s["Q"], -1, 128)
    rv, rd = jsp.heavy_candidates(H3, jnp.asarray(s["smax"]), K2, s["Q"],
                                  s["st"]["n_slots"])
    gv, gd = tsp.heavy_candidates(_t(s["H"]), _t(s["smax"]), K2, s["Q"],
                                  s["st"]["n_slots"])
    assert np.array_equal(gd.numpy(), np.asarray(rd))
    assert np.array_equal(gv.numpy(), np.asarray(rv))


def test_heavy_candidates_ties_take_lowest_index():
    """lax.top_k order: equal values come out lowest index first."""
    n_slots = 2048
    H = np.zeros((1, n_slots), np.float32)
    H[0, [5, 130, 300, 1000, 1500]] = [1.0, 2.0, 1.0, 1.0, 2.0]
    smax = np.full((128, 1), -np.inf, np.float32)
    smax[:16, 0] = H[0].reshape(16, 128).max(axis=1)
    vals, docs = tsp.heavy_candidates(_t(H), _t(smax), 4, 1, n_slots)
    assert docs.tolist() == [[130, 1500, 5, 300]]
    assert vals.tolist() == [[2.0, 2.0, 1.0, 1.0]]


def test_exact_rescore_v5_matches(staged, di):
    s = staged
    st = s["st"]
    plan = s["plan"]
    r = np.random.default_rng(11)
    cand = r.integers(0, st["n_slots"], size=(s["Q"], 2 * st["K2"])).astype(np.int32)
    cand[:, 0] = np.asarray(s["sd"][:s["Q"]]).clip(0, st["n_slots"] - 1)
    args = (s["a"]["post_doc"], s["a"]["post_score"])
    ref = np.asarray(jsp.exact_rescore_v5(
        *map(jnp.asarray, args),
        di.dense_rows, jnp.asarray(s["a"]["lbp"]), jnp.asarray(plan[0]),
        jnp.asarray(plan[2]), jnp.asarray(plan[3]), jnp.asarray(s["weights"]),
        jnp.asarray(cand), bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"],
        L2=st["L2"], H2=st["H2"], lb_log2=st["lb_log2"],
    ))
    got = tsp.exact_rescore_v5(
        *map(_t, args), _t(s["a"]["dense2"]), _t(s["a"]["lbp"]),
        _t(plan[0]), _t(plan[2]), _t(plan[3]), _t(s["weights"]),
        _t(cand).long(), bs_steps=st["bs_steps"], nd=st["nd"], nl=st["nl"],
        L2=st["L2"], H2=st["H2"], lb_log2=st["lb_log2"],
    ).numpy()
    assert (ref > 0).sum() > 20
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_canonical_sort_and_dedup_match():
    r = np.random.default_rng(9)
    scores = r.choice([0.0, 1.5, 2.25, 3.0, 7.5], size=(6, 40)).astype(np.float32)
    docs = r.integers(0, 30, size=(6, 40)).astype(np.int32)
    rv, rd = jbm25.canonical_sort(jnp.asarray(scores), jnp.asarray(docs))
    gv, gd = tbm25.canonical_sort(_t(scores), _t(docs))
    assert np.array_equal(gv.numpy(), np.asarray(rv))
    assert np.array_equal(gd.numpy(), np.asarray(rd))
    rv2, rd2 = jsp._dedup_sorted(rv, rd)
    gv2, gd2 = tsp.dedup_sorted(gv, gd)
    assert np.array_equal(gv2.numpy(), np.asarray(rv2))
    assert np.array_equal(gd2.numpy(), np.asarray(rd2))


def _run_both(di, plan, U, *, use_compact, fast, dense2=None, multi=False):
    st = _statics(di, plan if not multi else plan[0], U)
    if multi:
        for g in range(1, plan.shape[0]):
            st["C"] = max(st["C"], di._chunk_budget(plan[g, 1], BLOCK))
            st["L2"] = max(st["L2"], di._light_budget(plan[g]))
            st["H2"] = max(st["H2"], di._heavy_budget(plan[g]))
    a = _arrays(di)
    dense2 = a["dense2"] if dense2 is None else dense2
    st["U"] = U if use_compact else 0
    jfn = jsp.bm25_search_sparse_packed_multi if multi else jsp.bm25_search_sparse_packed
    tfn = tsp.packed_multi if multi else tsp.packed_impl
    ref = np.asarray(jfn(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(dense2).reshape(dense2.shape[0], -1, 128), None,
        jnp.asarray(a["lbp"]), jnp.asarray(plan),
        use_pallas=False, use_compact=use_compact, fast_heavy=fast, **st,
    ))
    got = tfn(
        _t(a["post_doc"]), _t(a["post_score"]), _t(dense2), _t(a["lbp"]),
        _t(plan), use_compact=use_compact, fast_heavy=fast, **st,
    ).numpy()
    return got, ref


@pytest.mark.parametrize("use_compact", [True, False])
def test_packed_impl_exact_bit_identical(di, use_compact):
    """Exact mode, compact and full-table: the whole packed output."""
    plan, U = di.plan_sparse(_queries(21))
    got, ref = _run_both(di, plan, U, use_compact=use_compact, fast=False)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 1)
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_packed_impl_fast_on_bf16_rounded_inputs(di):
    """Fast mode rounds the heavy operands to bf16, which JAX's CPU path
    does not; on a bf16-exact table and bf16-exact weights (distinct terms,
    so the mix needs no sums) both compute the same H, and vals, docs,
    found and the guard column agree bit for bit."""
    plan, U = di.plan_sparse(
        _queries(22, weights=[0.5, 0.75, 1.0, 1.25, 1.5], distinct=True)
    )
    dense2 = _arrays(di)["dense2"]
    dense2 = _t(dense2).to(torch.bfloat16).float().numpy()
    got, ref = _run_both(di, plan, U, use_compact=True, fast=True,
                         dense2=dense2)
    assert got.shape == ref.shape == (plan.shape[1], 2 * K + 2)
    assert ref[:, -1].sum() > 10  # the guard passes for most queries
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_packed_multi_matches(segs):
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=BLOCK, chunk_buckets=(64, 256, 1024),
        dense_df_ratio=0.02, launch_group=8,
    ))
    dig = DeviceIndex(segs, config=cfg)
    plans, U = dig._plan_groups(_queries(23, n=19), 8)
    assert plans.shape[0] == 3
    got, ref = _run_both(dig, plans, U, use_compact=True, fast=False,
                         multi=True)
    assert got.shape == (24, 2 * K + 1)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kw,msg", [
    (dict(h_bf16=True), "h_bf16"),
    (dict(prof_skip=("light",)), "prof_skip"),
    (dict(heavy_direct=False), "v2"),
])
def test_unported_paths_raise(di, kw, msg):
    plan, U = di.plan_sparse(_queries(24, n=4))
    st = _statics(di, plan, U)
    st.update(kw)
    a = _arrays(di)
    with pytest.raises(NotImplementedError, match=msg):
        tsp.packed_impl(_t(a["post_doc"]), _t(a["post_score"]),
                        _t(a["dense2"]), _t(a["lbp"]), _t(plan), **st)


def test_two_level_sort_raises(monkeypatch):
    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", "1")
    n = 32768
    sq = torch.zeros(n, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="SORT2_2LEVEL"):
        tsp.per_query_topk_flat(sq, torch.ones(n), sq, 1, 32, quantized=True)
