"""The windowed selection kernel K4 of the torch port
(nextsearch_tpu_torch/ops/select_kernels.py) and the packed path through it,
against nextsearch_tpu/ops/select_pallas.py (Pallas interpret mode and the
XLA reference), the flat-sort path, the JAX DeviceIndex and the oracle, on
the CPU (the wrapper runs its plain version). Every comparison is bit-exact:
K4's values are exact f32 and its tie rule is the sort path's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.ops import bm25_sparse as jsp
from nextsearch_tpu.ops.select_pallas import (
    per_query_topk_pallas,
    per_query_topk_xla_ref,
)
from nextsearch_tpu_torch.ops import bm25_sparse as tsp
from nextsearch_tpu_torch.ops import select_kernels as sk
from conftest import make_synthetic_docs
from test_torch_index import WORDS, MIXED, _pair, _random_queries, check
from test_torch_sparse_ops import BLOCK, K, _arrays, _queries, _statics, _t

torch.set_num_threads(1)


def _windows(r, Q, w_max, *, ties=True):
    """A flat array of Q windows (the first empty, the last full-width)
    with zeroed (dead) slots and, where a window is long enough, two equal
    values at its first and last slot."""
    lens = r.integers(0, w_max + 1, size=Q)
    lens[0] = 0
    lens[-1] = w_max
    N = ((int(lens.sum()) + 1023) // 1024 + 1) * 1024
    bounds = np.zeros(Q + 1, np.int32)
    bounds[1:] = np.cumsum(lens)
    scores = np.zeros(N, np.float32)
    for q in range(Q):
        seg = r.random(lens[q]).astype(np.float32)
        seg[r.random(lens[q]) < 0.3] = 0.0
        if ties and lens[q] > 4:
            seg[1] = seg[lens[q] - 1] = np.float32(0.25)
        scores[bounds[q]:bounds[q + 1]] = seg
    return scores, bounds


def _port(scores, bounds, k2):
    v, g = sk.per_query_topk(_t(scores), _t(bounds), k2)
    assert v.dtype == torch.float32 and g.dtype == torch.int64
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("Q,k2,w_max", [(40, 8, 512), (17, 32, 1024),
                                        (64, 5, 64)])
def test_per_query_topk_matches_xla_ref(Q, k2, w_max):
    """tests/test_sparse.py's shapes: bit-exact values and global indices
    against the XLA reference."""
    scores, bounds = _windows(np.random.default_rng(Q + k2), Q, w_max)
    v, g = _port(scores, bounds, k2)
    rv, rg = per_query_topk_xla_ref(jnp.asarray(scores), jnp.asarray(bounds),
                                    Q=Q, k2=k2)
    assert np.array_equal(v.view(np.uint32), np.asarray(rv).view(np.uint32))
    assert np.array_equal(g, np.asarray(rg))
    assert (v > 0).sum() > Q  # not vacuous


def test_per_query_topk_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) on a small case with
    ties, empty and full windows: bit-exact."""
    Q, k2, w_max = 12, 6, 64
    scores, bounds = _windows(np.random.default_rng(3), Q, w_max)
    v, g = _port(scores, bounds, k2)
    rv, rg = per_query_topk_pallas(jnp.asarray(scores), jnp.asarray(bounds),
                                   Q=Q, k2=k2, w_max=w_max, interpret=True)
    assert np.array_equal(v.view(np.uint32), np.asarray(rv).view(np.uint32))
    assert np.array_equal(g, np.asarray(rg))
    assert (v > 0).sum() > Q


def test_per_query_topk_edge_cases():
    """Empty and all-zero windows, k2 above the live count, equal values on
    both sides of a 1024-entry boundary, and a window of 2,297 entries:
    against the XLA reference and by hand."""
    scores = np.zeros(4096, np.float32)
    bounds = np.array([0, 0, 700, 703, 3000, 3000], np.int32)
    scores[703:3000] = np.float32(0.5)  # one long window of equal values
    scores[1023] = scores[1024] = scores[2900] = np.float32(2.0)
    scores[700] = np.float32(1.0)  # window 2: one live entry of three
    k2 = 6
    v, g = _port(scores, bounds, k2)
    rv, rg = per_query_topk_xla_ref(jnp.asarray(scores), jnp.asarray(bounds),
                                    Q=5, k2=k2)
    assert np.array_equal(v, np.asarray(rv)) and np.array_equal(g, np.asarray(rg))
    assert not v[0].any() and not g[0].any()  # empty window
    assert not v[1].any() and not g[1].any()  # all-zero window
    assert v[2].tolist() == [1.0] + [0.0] * 5 and g[2].tolist() == [700] + [0] * 5
    assert g[3].tolist() == [1023, 1024, 2900, 703, 704, 705]
    assert v[3].tolist() == [2.0, 2.0, 2.0, 0.5, 0.5, 0.5]
    assert not v[4].any()


def test_per_query_topk_rejects_bad_arguments():
    s, b = torch.zeros(8), torch.tensor([0, 8])
    with pytest.raises(TypeError):
        sk.per_query_topk(s.double(), b, 2)
    with pytest.raises(TypeError):
        sk.per_query_topk(s, b.float(), 2)
    with pytest.raises(ValueError):
        sk.per_query_topk(s, b, 0)
    assert sk.per_query_topk.launches == 0  # CPU tensors launch nothing


def test_per_query_topk_caps_k2():
    """k2 up to K2_MAX (at least the TPU kernel's 128) runs; above it the
    wrapper raises ValueError on every device."""
    assert sk.K2_MAX >= 128
    s, b = torch.tensor([0.5, 2.0, 0.0, 2.0] * 2), torch.tensor([0, 8])
    v, g = sk.per_query_topk(s, b, sk.K2_MAX)
    assert v.shape == g.shape == (1, sk.K2_MAX)
    assert v[0, :5].tolist() == [2.0] * 4 + [0.5]
    assert g[0, :5].tolist() == [1, 3, 5, 7, 0] and not v[0, 6:].any()
    with pytest.raises(ValueError):
        sk.per_query_topk(s, b, sk.K2_MAX + 1)
    assert sk.per_query_topk.launches == 0


def _run(di, plan, U, *, w_max, fast, use_compact=True, dense2=None):
    st = _statics(di, plan, U)
    st["U"] = U if use_compact else 0
    a = _arrays(di)
    dense2 = a["dense2"] if dense2 is None else dense2
    return tsp.packed_impl(
        _t(a["post_doc"]), _t(a["post_score"]), _t(dense2), _t(a["lbp"]),
        _t(plan), use_compact=use_compact, fast_heavy=fast, w_max=w_max, **st,
    ).numpy()


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


@pytest.mark.parametrize("use_compact", [True, False])
def test_packed_impl_select_kernel_path_matches(di, use_compact, monkeypatch):
    """Exact mode: the K4 path (w_max > 0) is bit-identical to the flat
    sort (w_max = 0) and to the JAX packed kernel."""
    plan, U = di.plan_sparse(_queries(25))
    monkeypatch.setenv("NEXTSEARCH_SELECT_PALLAS", "1")
    w_max = di._sel_window(plan[1])
    assert 0 < w_max <= tsp.SELECT_W_MAX
    calls = []
    real = tsp.per_query_topk
    monkeypatch.setattr(tsp, "per_query_topk",
                        lambda *a: calls.append(a[2]) or real(*a))
    got = _run(di, plan, U, w_max=w_max, fast=False, use_compact=use_compact)
    assert calls == [_statics(di, plan, U)["K2"]]
    flat = _run(di, plan, U, w_max=0, fast=False, use_compact=use_compact)
    assert len(calls) == 1
    st = _statics(di, plan, U)
    st["U"] = U if use_compact else 0
    a = _arrays(di)
    ref = np.asarray(jsp.bm25_search_sparse_packed(
        jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
        jnp.asarray(a["dense2"]).reshape(a["dense2"].shape[0], -1, 128), None,
        jnp.asarray(a["lbp"]), jnp.asarray(plan), use_pallas=False,
        use_compact=use_compact, fast_heavy=False, **st,
    ))
    assert (ref[:, 2 * K] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), flat.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_packed_impl_select_kernel_fast_guard(di):
    """Fast mode: K4's exact values drop the quantized-key term from the
    guard, so the guard passes at least wherever the flat path's does, and
    every query that passes on both paths has the same vals, docs and
    found. Inputs are bf16-exact (the flat path's result is JAX's)."""
    plan, U = di.plan_sparse(
        _queries(26, weights=[0.5, 0.75, 1.0, 1.25, 1.5], distinct=True))
    dense2 = _t(_arrays(di)["dense2"]).to(torch.bfloat16).float().numpy()
    got = _run(di, plan, U, w_max=1024, fast=True, dense2=dense2)
    flat = _run(di, plan, U, w_max=0, fast=True, dense2=dense2)
    ok_k4, ok_flat = got[:, -1] == 1.0, flat[:, -1] == 1.0
    assert ok_flat.sum() > 10 and np.all(ok_k4 >= ok_flat)
    both = ok_k4 & ok_flat
    assert np.array_equal(got[both].view(np.uint32), flat[both].view(np.uint32))


def _long_light_query(ti):
    """The 10 terms with the longest light windows, each three times: a
    window above 1024, which turns on the window ordering."""
    wins = ti._query_windows([[(w, 1.0)] for w in WORDS])
    return [(WORDS[i], 1.0) for i in np.argsort(-wins, kind="stable")[:10]] * 3


@pytest.mark.parametrize("fast", [True, False])
def test_torch_index_select_kernel_matches_reference(segs, fast,
                                                     monkeypatch):
    """TorchIndex under NEXTSEARCH_SELECT_PALLAS=1: results equal the JAX
    DeviceIndex's and the oracle's; K4 runs on the launch; a batch with a
    window above 1024 is reordered by window and the order undone."""
    monkeypatch.setenv("NEXTSEARCH_SELECT_PALLAS", "1")
    di, ti = _pair(segs, fast_heavy=fast)
    import nextsearch_tpu_torch.ops.bm25_sparse as mod

    calls = []
    real = mod.per_query_topk
    monkeypatch.setattr(mod, "per_query_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    long_q = _long_light_query(ti)
    assert ti._query_windows([long_q]).max() > 1024
    queries = MIXED + [long_q] + _random_queries(45, n=16)
    handle = ti.search_batch_async(queries, 10)
    perm = handle[6] if fast else handle[5]
    assert perm is not None and list(perm) != sorted(perm)
    ti.search_batch_gather(handle)
    assert len(calls) == 1
    check(ti, segs, queries, di)


@pytest.mark.parametrize("rescue", ["100", "0"])
def test_torch_index_select_kernel_trips(segs, rescue, monkeypatch):
    """eps = 1e9 trips every non-trivial query of a K4 launch: with the
    rescue cap raised the host oracle answers them; with no rescue the
    batch relaunches the exact full-table kernel, K4 included. Both stay
    oracle-exact."""
    monkeypatch.setenv("NEXTSEARCH_SELECT_PALLAS", "1")
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", rescue)
    import nextsearch_tpu_torch.ops.bm25_sparse as mod

    calls = []
    real = mod.per_query_topk
    monkeypatch.setattr(mod, "per_query_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _di, ti = _pair(segs, fast_heavy_eps=1e9)
    check(ti, segs, _random_queries(48, n=20))
    if rescue == "0":
        assert ti.relaunches == 1 and ti.rescue_trips == 0 and len(calls) == 2
    else:
        assert ti.relaunches == 0 and ti.rescue_trips > 0 and len(calls) == 1
