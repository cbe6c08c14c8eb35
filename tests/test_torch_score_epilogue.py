"""The fused mode's score epilogue (nextsearch_tpu_torch/ops/score_kernels.py)
on the CPU: its plain version against the three torch ops it replaced, the
wrapper's checks, tiled_topk with given tile maxima, and the fused, fast
and exact launches that now take `found` (and the fused ones the tile
maxima) from it, bit for bit against nextsearch_tpu/ops/bm25.py.

Inputs are made with numpy from a seed: a posting list per term over
n_slots docs, the heavy terms' dense rows built from their postings, and a
batch of queries mixing light and heavy terms. n_slots 8192 with K2 3
takes tiled_topk's tiled branch (3 tiles of 2048 < 8192), so the tile
maxima reach the candidate selection; 5000 (not a multiple of 2048) takes
its flat branch. Tolerance 0 throughout: every comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.ops import bm25 as jbm25
from nextsearch_tpu_torch.ops import bm25 as tbm25
from nextsearch_tpu_torch.ops import score_kernels as se
from nextsearch_tpu_torch.parallel import sharded

torch.set_num_threads(1)

BLOCK = 64
N_TERMS = 14
N_HEAVY = 3  # terms 0..2 have dense rows


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _scores(rng, q, n, dtype):
    s = np.where(rng.random((q, n)) < 0.3, rng.uniform(0.01, 9.0, (q, n)), 0.0)
    return torch.from_numpy(s.astype(np.float32)).to(dtype)


def _heavy(rng, q, n):
    h = np.where(rng.random((q, n)) < 0.2, rng.uniform(0.0, 5.0, (q, n)), 0.0)
    return torch.from_numpy(h.astype(np.float32))


# ------------------------------------------------------- the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,tile", [(8192, 2048), (6144, 2048), (1000, 2048),
                                    (777, 37), (96, 32)])
@pytest.mark.parametrize("with_heavy", [True, False])
def test_ref_equals_the_three_ops_it_replaced(dtype, n, tile, with_heavy):
    """score_epilogue_ref, and the wrapper on CPU tensors, against the
    eager ops of the fused tail before the kernel: heavy_scores(...,
    dtype).add_, (scores > 0).sum(int32) and tiles.amax(dim=2)."""
    rng = np.random.default_rng(n + tile)
    q = 5
    base = _scores(rng, q, n, dtype)
    heavy = _heavy(rng, q, n) if with_heavy else None
    want = base.clone()
    if heavy is not None:
        want.add_(heavy.to(dtype))
    want_found = (want > 0).sum(dim=1, dtype=torch.int32)
    tiled = n % tile == 0
    for fn in (se.score_epilogue_ref, se.score_epilogue):
        got = base.clone()
        found, tile_max = fn(got, heavy, tile=tile)
        assert torch.equal(_bits(got), _bits(want))
        assert found.dtype == torch.int32 and torch.equal(found, want_found)
        if tiled:
            ref_max = want.view(q, n // tile, tile).amax(dim=2)
            assert tile_max.dtype == dtype
            assert torch.equal(_bits(tile_max), _bits(ref_max))
        else:
            assert tile_max is None
        found2, none = fn(got.clone(), tile=tile, tiles=False)
        assert none is None and torch.equal(found2, want_found)


def test_bf16_scores_round_heavy_first_then_the_sum():
    """With bf16 scores H is rounded to bf16 before the bf16 add, as the
    reference's heavy_scores(..., dtype=bf16) then `+`; rounding once,
    bf16(s + H), gives other bits on these values."""
    s = torch.tensor([[1.0, 256.0, 3.0, 0.0]], dtype=torch.bfloat16)
    # 2^-8 + 2^-17 rounds to 2^-8, and 1 + 2^-8 is a tie that rounds to 1;
    # unrounded, 1 + 2^-8 + 2^-17 rounds up to 1 + 2^-7
    h = torch.tensor([[2.0 ** -8 + 2.0 ** -17, 1.5, 0.0, 0.0]])
    got = s.clone()
    found, _ = se.score_epilogue(got, h, tiles=False)
    assert torch.equal(_bits(got), _bits(s + h.to(torch.bfloat16)))
    once = (s.float() + h).to(torch.bfloat16)
    assert not torch.equal(_bits(got), _bits(once))
    assert found.tolist() == [3]


@pytest.mark.parametrize("bad", ["int", "f64", "3d", "heavy_bf16",
                                 "heavy_shape", "strided", "heavy_strided",
                                 "tile"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    s = torch.zeros((4, 64))
    h = torch.zeros((4, 64))
    kw = {}
    if bad == "int":
        s = s.to(torch.int32)
    elif bad == "f64":
        s = s.double()
    elif bad == "3d":
        s = s.view(4, 8, 8)
    elif bad == "heavy_bf16":
        h = h.to(torch.bfloat16)
    elif bad == "heavy_shape":
        h = torch.zeros((4, 32))
    elif bad == "strided":
        s = torch.zeros((64, 4)).T
    elif bad == "heavy_strided":
        h = torch.zeros((64, 4)).T
    else:
        kw["tile"] = 0
    err = ValueError if bad in ("strided", "heavy_strided", "tile") else TypeError
    with pytest.raises(err):
        se.score_epilogue(s, h, **kw)


# ------------------------------------------------------------ tiled_topk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiled_topk_with_given_tile_max_equals_without(dtype):
    rng = np.random.default_rng(3)
    q, n, k2 = 6, 8 * 2048, 5
    s = _scores(rng, q, n, dtype)
    s[:, 4000:4010] = 9.5  # a tie run inside one tile
    _f, tile_max = se.score_epilogue(s.clone())
    got = tbm25.tiled_topk(s, k2, tile_max=tile_max)
    want = tbm25.tiled_topk(s, k2)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    # the maxima given are the ones used: all-equal maxima pick the first
    # k2 tiles, whatever the scores
    flat = torch.zeros_like(tile_max)
    _v, idx = tbm25.tiled_topk(s, k2, tile_max=flat)
    assert bool((idx < k2 * 2048).all())


# ------------------------------------------- the launches against the JAX ones


def _batch(n_slots, seed=0, q=7, t=4):
    """Postings, dense rows and one planned batch, as numpy."""
    rng = np.random.default_rng(seed)
    n_docs = min(n_slots, 4900)
    dfs_t = np.concatenate([rng.integers(1500, 3000, N_HEAVY),
                            rng.integers(3, 700, N_TERMS - N_HEAVY)])
    docs, scores, start = [], [], []
    off = 0
    for df in dfs_t:
        d = np.sort(rng.choice(n_docs, size=int(df), replace=False))
        docs.append(d)
        scores.append(rng.uniform(0.05, 4.0, df))
        start.append(off)
        off += int(df)
    post_doc = np.concatenate(docs).astype(np.int32)
    post_score = np.concatenate(scores).astype(np.float32)
    dense = np.zeros((N_HEAVY + 1, n_slots), np.float32)
    for h in range(N_HEAVY):
        dense[h, docs[h]] = scores[h]
    starts = np.zeros((q, t), np.int32)
    dfs = np.zeros((q, t), np.int32)
    weights = np.zeros((q, t), np.float32)
    for i in range(q):
        nt = int(rng.integers(1, t + 1)) if i else t
        terms = rng.choice(N_TERMS, size=nt, replace=False)
        if i == 0:
            terms[:2] = [0, 1]  # two heavy terms
        for j, term in enumerate(terms):
            starts[i, j] = start[term]
            dfs[i, j] = dfs_t[term]
            weights[i, j] = rng.uniform(0.2, 1.5)
    heavy = np.zeros((q, t), bool)
    for h in range(N_HEAVY):
        heavy |= (starts == start[h]) & (dfs == dfs_t[h])
    light_dfs = np.where(heavy, 0, dfs).astype(np.int32)
    uh = np.array(sorted({h for h in range(N_HEAVY)
                          if ((starts == start[h]) & heavy).any()}) + [N_HEAVY],
                  np.int32)
    mix = np.zeros((q, uh.size), np.float32)
    for i in range(q):
        for j in range(t):
            if heavy[i, j]:
                h = next(h for h in range(N_HEAVY) if starts[i, j] == start[h])
                mix[i, list(uh).index(h)] += weights[i, j]
    c_light = int(((light_dfs.astype(np.int64) + BLOCK - 1) // BLOCK).sum())
    c_all = int(((dfs.astype(np.int64) + BLOCK - 1) // BLOCK).sum())
    return dict(post_doc=post_doc, post_score=post_score, dense=dense,
                starts=starts, dfs=dfs, weights=weights, light_dfs=light_dfs,
                uh=uh, mix=mix, n_slots=n_slots, q=q,
                C=(c_light + 127) // 128 * 128, C_all=(c_all + 127) // 128 * 128,
                bs_steps=max(2, n_slots.bit_length() + 1))


@pytest.fixture(scope="module", params=[8192, 5000])
def batch(request):
    return _batch(request.param, seed=request.param)


# (K, K2): K2 3 takes the tiled branch at n_slots 8192, 32 the flat one
SIZES = [(2, 3), (10, 32)]


def _same(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.array_equal(g.numpy().view(np.uint32), r.view(np.uint32))


@pytest.mark.parametrize("scores_bf16", [False, True])
@pytest.mark.parametrize("k,k2", SIZES)
def test_bm25_search_packed_bit_equal_to_jax(batch, scores_bf16, k, k2):
    p = batch
    q, t = p["starts"].shape
    u = p["uh"].size
    plan_ints = np.stack([p["starts"], p["dfs"], p["light_dfs"]])
    plan_f32 = np.zeros((q + 1, t + u), np.float32)
    plan_f32[:q, :t] = p["weights"]
    plan_f32[:q, t:] = p["mix"]
    plan_f32[q, t:] = p["uh"].astype(np.float32)
    args = (p["post_doc"], p["post_score"], p["dense"], plan_ints, plan_f32)
    kw = dict(n_slots=p["n_slots"], K=k, K2=k2, C=p["C"], block=BLOCK,
              bs_steps=p["bs_steps"], scores_bf16=scores_bf16)
    ref = np.asarray(jbm25.bm25_search_packed(*map(jnp.asarray, args), **kw))
    got = tbm25.bm25_search_packed(*map(_t, args), **kw)
    _same([got], [ref])
    assert (ref[:, 2 * k] > 0).all()


@pytest.mark.parametrize("k,k2", SIZES)
def test_bm25_topk_fused_bit_equal_to_jax(batch, k, k2):
    p = batch
    args = (p["post_doc"], p["post_score"], p["dense"], p["starts"], p["dfs"],
            p["weights"], p["light_dfs"], p["uh"], p["mix"])
    kw = dict(n_slots=p["n_slots"], K=k, K2=k2, C=p["C"], block=BLOCK,
              bs_steps=p["bs_steps"])
    _same(tbm25.bm25_topk_fused(*map(_t, args), **kw),
          jbm25.bm25_topk_fused(*map(jnp.asarray, args), **kw))


def test_bm25_topk_fast_bit_equal_to_jax(batch):
    p = batch
    args = (p["starts"], p["dfs"], p["weights"])
    jc = jbm25.expand_chunks(*map(jnp.asarray, args), C=p["C_all"], block=BLOCK)
    tc = tbm25.expand_chunks(*map(_t, args), C=p["C_all"], block=BLOCK)
    kw = dict(n_slots=p["n_slots"], K=10, Q=p["q"], block=BLOCK)
    _same(tbm25.bm25_topk_fast(_t(p["post_doc"]), _t(p["post_score"]), *tc, **kw),
          jbm25.bm25_topk_fast(jnp.asarray(p["post_doc"]),
                               jnp.asarray(p["post_score"]), *jc, **kw))


def test_bm25_topk_exact_bit_equal_to_jax(batch):
    p = batch
    args = (p["post_doc"], p["post_score"], p["starts"], p["dfs"], p["weights"])
    kw = dict(n_slots=p["n_slots"], K=10, block=BLOCK)
    _same(tbm25.bm25_topk_exact(*map(_t, args), **kw),
          jbm25.bm25_topk_exact(*map(jnp.asarray, args), **kw))


# ------------------------------------------- each launch calls it once


@pytest.fixture
def calls(monkeypatch):
    """Count score_epilogue's calls where ops/bm25.py and the sharded local
    step call it (a CPU wrapper launches nothing), and fail a tiled_topk
    that is not handed the epilogue's tile maxima, so that it would take
    them again."""
    seen = []

    def counting(scores, heavy=None, **kw):
        seen.append((heavy is not None, kw.get("tiles", True)))
        return se.score_epilogue(scores, heavy, **kw)

    def given_maxima(scores, k2, tile=2048, tile_max=None):
        n = scores.shape[1]
        if n % tile == 0 and n > k2 * tile:
            assert tile_max is not None and tile_max.shape[1] == n // tile
        return tbm25.tiled_topk(scores, k2, tile, tile_max)

    for mod in (tbm25, sharded):
        monkeypatch.setattr(mod, "score_epilogue", counting)
    monkeypatch.setattr(sharded, "tiled_topk", given_maxima)
    return seen


def test_each_launch_runs_the_epilogue_once(batch, calls):
    p = batch
    t_args = {k: _t(v) for k, v in p.items() if isinstance(v, np.ndarray)}
    kw = dict(n_slots=p["n_slots"], K=2, K2=3, C=p["C"], block=BLOCK,
              bs_steps=p["bs_steps"])
    tbm25.bm25_topk_fused(
        t_args["post_doc"], t_args["post_score"], t_args["dense"],
        t_args["starts"], t_args["dfs"], t_args["weights"],
        t_args["light_dfs"], t_args["uh"], t_args["mix"], **kw)
    assert calls == [(True, True)]
    tbm25.bm25_topk_exact(t_args["post_doc"], t_args["post_score"],
                          t_args["starts"], t_args["dfs"], t_args["weights"],
                          n_slots=p["n_slots"], K=10, block=BLOCK)
    chunks = tbm25.expand_chunks(t_args["starts"], t_args["dfs"],
                                 t_args["weights"], C=p["C_all"], block=BLOCK)
    tbm25.bm25_topk_fast(t_args["post_doc"], t_args["post_score"], *chunks,
                         n_slots=p["n_slots"], K=10, Q=p["q"], block=BLOCK)
    assert calls[1:] == [(False, False), (False, False)]


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_sharded_local_step_runs_the_epilogue_once(batch, calls, mode):
    """The sharded fused and exact steps take found (and the fused one the
    tile maxima) from the epilogue, and their results equal the
    single-device launch's over the same shard."""
    p = batch
    q, t = p["starts"].shape
    u = p["uh"].size
    pi = np.zeros((q, 4 * t + 2 * u), np.int32)
    pi[:, :t], pi[:, t:2 * t], pi[:, 2 * t:3 * t] = (p["starts"], p["dfs"],
                                                     p["light_dfs"])
    pi[:, 3 * t:4 * t] = p["weights"].view(np.int32)
    pi[:, 4 * t:4 * t + u] = p["mix"].view(np.int32)
    pi[0, 4 * t + u:] = p["uh"]
    tab = sharded._Tables(_t(p["post_doc"]), _t(p["post_score"]),
                          _t(p["dense"]), None, None)
    vals, idx, found, _g = sharded.local_step(
        tab, _t(pi), mode=mode, T=t, U=u, n_slots=p["n_slots"], K=2, K2=3,
        C=p["C"], block=BLOCK, bs_steps=p["bs_steps"], nd=0, nl=0,
        use_compact=False, heavy_direct=False, fast_heavy=False,
        guard_eps=0.0, L2=0, H2=0, max_df=p["dfs"].max(axis=0).tolist())
    assert calls == [(mode == "fused", mode == "fused")]
    if mode == "fused":
        ref = jbm25.bm25_topk_fused(*map(jnp.asarray, (
            p["post_doc"], p["post_score"], p["dense"], p["starts"], p["dfs"],
            p["weights"], p["light_dfs"], p["uh"], p["mix"])),
            n_slots=p["n_slots"], K=3, K2=3, C=p["C"], block=BLOCK,
            bs_steps=24)
    else:
        ref = jbm25.bm25_topk_exact(*map(jnp.asarray, (
            p["post_doc"], p["post_score"], p["starts"], p["dfs"],
            p["weights"])), n_slots=p["n_slots"], K=2, block=BLOCK)
    _same([vals, idx.to(torch.int32), found], ref)
