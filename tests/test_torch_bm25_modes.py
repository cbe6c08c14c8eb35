"""The fused, exact and fast modes' ops (nextsearch_tpu_torch/ops/bm25.py)
function by function against nextsearch_tpu/ops/bm25.py on the CPU: the same
numpy inputs (made from a seed, or planned by the JAX DeviceIndex over a
small corpus) go through both.

Tolerances: everything that the exact rescore or the exact mode produces is
compared bit for bit, as are docs and `found`; pass-1 scores (scatter_scores,
heavy_scores, bm25_topk_fast) are sums taken in another order than XLA's and
are held to rtol 1e-6 in f32 and 2^-7 where the score array is bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.ops import bm25 as jbm25
from nextsearch_tpu.ops.heavy_pallas import gather_rows_pallas
from nextsearch_tpu_torch.ops import bm25 as tbm25
from nextsearch_tpu_torch.ops import heavy_kernels as hk
from nextsearch_tpu_torch.ops import probe_kernels as pk

from conftest import make_synthetic_docs

torch.set_num_threads(1)

BLOCK = 64
K = 10
K2 = 32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _n(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


def _index(segs, **kw):
    cfg = dict(mode="fused", posting_block=BLOCK, chunk_buckets=(64, 256, 1024),
               dense_df_ratio=0.02)
    cfg.update(kw)
    return DeviceIndex(segs, config=EngineConfig(device=DeviceConfig(**cfg)))


@pytest.fixture(scope="module")
def di(segs):
    return _index(segs)


@pytest.fixture(scope="module")
def di_single():
    return _index([build_segment_arrays(make_synthetic_docs(300, 120, seed=7))])


def _queries(seed, n=14):
    r = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(220)]
    out = [
        [(words[int(i)], float(w))
         for i, w in zip(r.integers(0, 220, size=nt), r.uniform(0.2, 1.5, size=nt))]
        for nt in r.integers(1, 5, size=n)
    ]
    out[0] = [("w0000", 1.0), ("w0001", 0.5)]  # two heavy terms
    out[1] = [("w0005", 1.0), ("w0005", 0.5)]  # a repeated term
    out[2] = [("nosuchterm", 1.0)]             # no hit (df 0 everywhere)
    out[3] = []                                # empty query
    out[4] = [("w0219", 1.0)]                  # fewer matches than K
    return out


def _plan(di, queries):
    """The JAX planner's arrays for a batch, as numpy, with the statics."""
    starts, dfs, weights, light_dfs, uh, mix = di.plan_full(queries)
    return dict(
        post_doc=np.asarray(di.post_doc), post_score=np.asarray(di.post_score),
        dense=np.asarray(di.dense_rows), starts=starts, dfs=dfs,
        weights=weights, light_dfs=light_dfs, uh=uh, mix=mix,
        n_slots=di.n_slots, C=di._chunk_budget(light_dfs, BLOCK),
        bs_steps=max(2, di.n_slots.bit_length() + 1),
    )


@pytest.fixture(scope="module", params=["multi", "single"])
def plan(request, di, di_single):
    return _plan(di if request.param == "multi" else di_single, _queries(11))


def _chunks(p, light=True):
    args = (p["starts"], p["light_dfs"] if light else p["dfs"], p["weights"])
    j = jbm25.expand_chunks(*map(jnp.asarray, args), C=p["C"] if light else 1024,
                            block=BLOCK)
    t = tbm25.expand_chunks(*map(_t, args), C=p["C"] if light else 1024,
                            block=BLOCK)
    return j, t


@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_scores(plan, bf16):
    """Pass 1's scatter: f32 within rtol 1e-6 (the adds land in another
    order), bf16 within 2^-7 relative; the set of positive cells, which is
    what `found` counts, is equal."""
    p = plan
    jc, tc = _chunks(p)
    q = p["starts"].shape[0]
    ref = jbm25.scatter_scores(
        jnp.asarray(p["post_doc"]), jnp.asarray(p["post_score"]), *jc, Q=q,
        n_slots=p["n_slots"], block=BLOCK,
        dtype=jnp.bfloat16 if bf16 else jnp.float32)
    got = tbm25.scatter_scores(
        _t(p["post_doc"]), _t(p["post_score"]), *tc, Q=q, n_slots=p["n_slots"],
        block=BLOCK, dtype=torch.bfloat16 if bf16 else torch.float32)
    assert got.shape == ref.shape and got.is_contiguous()
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(_n(got), ref, rtol=2.0 ** -7 if bf16 else 1e-6)
    assert np.array_equal(_n(got) > 0, ref > 0)
    assert (ref > 0).any()


@pytest.mark.parametrize("bf16_rows", [False, True])
@pytest.mark.parametrize("bf16_out", [False, True])
def test_heavy_scores(plan, bf16_rows, bf16_out):
    """The dense-row product: rtol 1e-6 in f32 (cuBLAS/MKL and XLA sum in
    other orders), 2^-7 where the output is bf16; positives equal."""
    p = plan
    dense = p["dense"]
    jd, td = jnp.asarray(dense), _t(dense)
    if bf16_rows:
        jd, td = jd.astype(jnp.bfloat16), td.to(torch.bfloat16)
    ref = jbm25.heavy_scores(jd, jnp.asarray(p["uh"]), jnp.asarray(p["mix"]),
                             dtype=jnp.bfloat16 if bf16_out else jnp.float32)
    got = tbm25.heavy_scores(td, _t(p["uh"]), _t(p["mix"]),
                             dtype=torch.bfloat16 if bf16_out else torch.float32)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(_n(got), ref, rtol=2.0 ** -7 if bf16_out else 1e-6)
    assert np.array_equal(_n(got) > 0, ref > 0)
    assert (p["mix"] != 0).any()


def test_heavy_scores_zero_padding_row():
    dense = np.array([[1.0, 0.0, 2.0], [0.5, 0.5, 0.0], [0.0, 0.0, 0.0]],
                     np.float32)
    out = tbm25.heavy_scores(_t(dense), torch.tensor([0, 2], dtype=torch.int32),
                             torch.tensor([[2.0, 99.0]]))
    assert out.tolist() == [[2.0, 0.0, 4.0]]


def test_score_only_exact_and_determinism(plan):
    """Exact-mode dense scores: bit-identical to the JAX function (each
    cell receives its contributions in term-slot order in both), and the
    same bits on a second run."""
    p = plan
    args = (p["post_doc"], p["post_score"], p["starts"], p["dfs"], p["weights"])
    ref = np.asarray(jbm25.score_only_exact(*map(jnp.asarray, args),
                                            n_slots=p["n_slots"], block=BLOCK))
    got = tbm25.score_only_exact(*map(_t, args), n_slots=p["n_slots"],
                                 block=BLOCK)
    again = tbm25.score_only_exact(*map(_t, args), n_slots=p["n_slots"],
                                   block=BLOCK)
    assert np.array_equal(_n(got).view(np.uint32), ref.view(np.uint32))
    assert torch.equal(got, again)


def _tied_scores(seed, q, ns, n_hot=40):
    """Sparse score rows with planted ties: few distinct values, repeated
    across far-apart slots."""
    r = np.random.default_rng(seed)
    s = np.zeros((q, ns), np.float32)
    for row in s:
        pos = r.choice(ns, size=n_hot, replace=False)
        row[pos] = r.choice(np.array([0.25, 0.5, 0.75, 1.5], np.float32), n_hot)
    return s


@pytest.mark.parametrize("ns,k2,tile", [
    (16 * 2048, 8, 2048),    # tiled branch
    (64 * 256, 16, 256),     # tiled branch, narrow tiles
    (1000, 10, 2048),        # NS % tile != 0: flat top-k
    (8 * 2048, 8, 2048),     # NS <= k2 * tile: flat top-k
])
@pytest.mark.parametrize("bf16", [False, True])
def test_tiled_topk_with_planted_ties(ns, k2, tile, bf16):
    """Values and doc slots bit-identical to the JAX tiled_topk and to a
    flat lax.top_k, ties going to the lower slot."""
    s = _tied_scores(ns + k2, 3, ns)
    s[2] = 0.0
    s[2, [7, ns - 1, ns // 2]] = 0.5  # fewer positives than k2
    js, ts = jnp.asarray(s), _t(s)
    if bf16:
        js, ts = js.astype(jnp.bfloat16), ts.to(torch.bfloat16)
    rv, ri = jbm25.tiled_topk(js, k2, tile=tile)
    fv, fi = lax.top_k(js, k2)
    gv, gi = tbm25.tiled_topk(ts, k2, tile=tile)
    assert gi.dtype == torch.int32
    assert np.array_equal(_n(gv), np.asarray(rv.astype(jnp.float32)))
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    assert np.array_equal(gi.numpy(), np.asarray(fi))


def test_tiled_topk_cluster_in_one_tile():
    ns, k2 = 64 * 2048, 16
    s = np.zeros((1, ns), np.float32)
    s[0, 4096:4096 + 50] = np.linspace(1.0, 0.5, 50, dtype=np.float32)
    gv, gi = tbm25.tiled_topk(_t(s), k2)
    fv, fi = lax.top_k(jnp.asarray(s), k2)
    assert np.array_equal(gi.numpy(), np.asarray(fi))
    assert np.array_equal(gv.numpy(), np.asarray(fv))


def test_exact_rescore(plan):
    """Bit-identical to the JAX rescore on candidates that hold hits,
    misses and out-of-range-of-postings docs."""
    p = plan
    r = np.random.default_rng(5)
    q = p["starts"].shape[0]
    cand = r.integers(0, p["n_slots"], size=(q, K2)).astype(np.int32)
    cand[:, :8] = p["post_doc"][r.integers(0, p["post_doc"].size, size=(q, 8))]
    args = (p["post_doc"], p["post_score"], p["starts"], p["dfs"], p["weights"],
            cand)
    ref = np.asarray(jbm25.exact_rescore(*map(jnp.asarray, args),
                                         bs_steps=p["bs_steps"]))
    got = tbm25.exact_rescore(*map(_t, args), bs_steps=p["bs_steps"])
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    assert (ref > 0).any()


def test_exact_rescore_candidate_not_in_postings():
    out = tbm25.exact_rescore(
        torch.tensor([2, 5, 9], dtype=torch.int32), torch.tensor([1.0, 2.0, 3.0]),
        torch.tensor([[0]], dtype=torch.int32), torch.tensor([[3]], dtype=torch.int32),
        torch.tensor([[1.0]]), torch.tensor([[5, 4, 9, 11]], dtype=torch.int32),
        bs_steps=8)
    assert out.tolist() == [[2.0, 0.0, 3.0, 0.0]]


def _same_topk(got, ref, score_rtol=0.0):
    gv, gi, gf = got
    rv, ri, rf = (np.asarray(x) for x in ref)
    assert gi.dtype == torch.int32 and gf.dtype == torch.int32
    assert np.array_equal(gf.numpy(), rf)
    assert np.array_equal(gi.numpy(), ri)
    if score_rtol:
        np.testing.assert_allclose(gv.numpy(), rv, rtol=score_rtol)
    else:
        assert np.array_equal(gv.numpy().view(np.uint32), rv.view(np.uint32))


@pytest.mark.parametrize("k", [10, 100])
def test_bm25_topk_exact(plan, k):
    p = plan
    args = (p["post_doc"], p["post_score"], p["starts"], p["dfs"], p["weights"])
    kw = dict(n_slots=p["n_slots"], K=k, block=BLOCK)
    _same_topk(tbm25.bm25_topk_exact(*map(_t, args), **kw),
               jbm25.bm25_topk_exact(*map(jnp.asarray, args), **kw))


def test_bm25_topk_fast(plan):
    """Docs and `found` equal; scores within rtol 1e-6: one scatter whose
    adds land in any order (the JAX docstring allows the last ULP)."""
    p = plan
    jc, tc = _chunks(p, light=False)
    kw = dict(n_slots=p["n_slots"], K=K, Q=p["starts"].shape[0], block=BLOCK)
    _same_topk(
        tbm25.bm25_topk_fast(_t(p["post_doc"]), _t(p["post_score"]), *tc, **kw),
        jbm25.bm25_topk_fast(jnp.asarray(p["post_doc"]),
                             jnp.asarray(p["post_score"]), *jc, **kw),
        score_rtol=1e-6)


@pytest.mark.parametrize("k", [10, 100])
def test_bm25_topk_fused(plan, k):
    p = plan
    args = (p["post_doc"], p["post_score"], p["dense"], p["starts"], p["dfs"],
            p["weights"], p["light_dfs"], p["uh"], p["mix"])
    kw = dict(n_slots=p["n_slots"], K=k, K2=max(2 * k, K2), C=p["C"],
              block=BLOCK, bs_steps=p["bs_steps"])
    _same_topk(tbm25.bm25_topk_fused(*map(_t, args), **kw),
               jbm25.bm25_topk_fused(*map(jnp.asarray, args), **kw))


@pytest.mark.parametrize("scores_bf16", [False, True])
def test_bm25_search_packed(plan, scores_bf16):
    """The packed launch: the whole [Q, 2K + 1] result bit-identical (exact
    scores, docs and found as f32 values)."""
    p = plan
    q, t = p["starts"].shape
    u = p["uh"].shape[0]
    plan_ints = np.stack([p["starts"], p["dfs"], p["light_dfs"]])
    plan_f32 = np.zeros((q + 1, t + u), np.float32)
    plan_f32[:q, :t] = p["weights"]
    plan_f32[:q, t:] = p["mix"]
    plan_f32[q, t:] = p["uh"].astype(np.float32)
    args = (p["post_doc"], p["post_score"], p["dense"], plan_ints, plan_f32)
    kw = dict(n_slots=p["n_slots"], K=K, K2=K2, C=p["C"], block=BLOCK,
              bs_steps=p["bs_steps"], scores_bf16=scores_bf16)
    ref = np.asarray(jbm25.bm25_search_packed(*map(jnp.asarray, args), **kw))
    got = tbm25.bm25_search_packed(*map(_t, args), **kw)
    assert got.shape == (q, 2 * K + 1)
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    assert (ref[:, 2 * K] > 0).any()


def test_topk_low_index_orders_ties_like_lax():
    s = _tied_scores(3, 4, 5000, n_hot=200)
    s[1, :3] = [-1.0, -0.0, 0.0]
    gv, gi = tbm25.topk_low_index(_t(s), 64)
    fv, fi = lax.top_k(jnp.asarray(s), 64)
    assert np.array_equal(gi.numpy(), np.asarray(fi))
    assert np.array_equal(gv.numpy(), np.asarray(fv))


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_rows_against_the_jax_kernel(bf16):
    """K3's wrappers (their plain versions on the CPU) against the JAX K3,
    gather_rows_pallas, in Pallas TPU interpret mode: bit for bit, f32 and
    bf16 rows, repeated and unordered ids."""
    from jax.experimental.pallas import tpu as pltpu

    r = np.random.default_rng(9)
    table = r.standard_normal((11, 2048)).astype(np.float32)
    ids = np.array([3, 0, 10, 3, 7, 5, 10, 10], np.int32)
    jt = jnp.asarray(table)
    tt = _t(table)
    if bf16:
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = gather_rows_pallas(jnp.asarray(ids), jt.reshape(11, 16, 128))
    ref = np.asarray(ref.astype(jnp.float32)).reshape(8, 2048)
    fn = hk.gather_bf16_rows if bf16 else hk.gather_rows
    got = fn(_t(ids), tt)
    assert got.dtype == tt.dtype
    assert np.array_equal(_n(got).view(np.uint32), ref.view(np.uint32))
    assert fn.launches == 0  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("q,t,w", [(128, 1024, 512), (5, 3, 7), (33, 70, 130)])
def test_nt_dot_against_numpy(q, t, w):
    """P1's wrapper against a numpy NT dot (f64 accumulation): rtol 1e-4 of
    the row's magnitude, kernel_probe's tolerance for an f32 sum over W."""
    r = np.random.default_rng(q + t + w)
    a = r.standard_normal((q, w)).astype(np.float32)
    b = r.standard_normal((t, w)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64).T
    got = pk.nt_dot(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.sqrt(w))
    assert pk.nt_dot.launches == 0


def test_no_dropped_scatter_reaches_a_real_cell():
    """Chunks owned by row Q and lanes past a chunk's length add nothing:
    an all-dead plan gives all-zero scores and found 0."""
    post_doc = torch.arange(50, dtype=torch.int32)
    post_score = torch.ones(50)
    z = torch.zeros((2, 4), dtype=torch.int32)
    chunks = tbm25.expand_chunks(z, z, torch.zeros((2, 4)), C=16, block=8)
    assert torch.all(chunks[1] == 0) and torch.all(chunks[2] == 2)
    s = tbm25.scatter_scores(post_doc, post_score, *chunks, Q=2, n_slots=64,
                             block=8)
    assert s.shape == (2, 64) and not s.any()
    vals, idx, found = tbm25.bm25_topk_fast(post_doc, post_score, *chunks,
                                            n_slots=64, K=4, Q=2, block=8)
    assert not vals.any() and found.tolist() == [0, 0]
    assert idx.tolist() == [[0, 1, 2, 3]] * 2
