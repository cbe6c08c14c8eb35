"""The port's CUDA kernels and sparse path on a card (skipped without one).

Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version: K2/K3 (f32 and
bf16 rows) and K4 bit for bit; K1 and K6 cnt bit for bit and H/smax within
1e-6 relative (the kernel's fp32 sums run in another order than cuBLAS's),
a bf16 H equal to the rounding of the kernel's own f32 H; K5 cnt bit for bit
and totals/smax within 2e-6 relative (the same product, plus entry sums in
the same order); on dense mixes with bf16 operands (the tensor-core kernel)
H and smax within (ND / 8 + 8) * 2^-23 relative, cnt and H > 0 still bit for
bit; P6 as K6, its reduced smax within 1e-6 relative; P1
within 2 * 512 * 2^-24 relative (two orders of a 512-term positive sum),
P3 within 1e-6 (a few entries per cell at most) and, in its own test,
bit for bit against np.add.at; K4's threshold select on cases aimed at the
select's steps; P2, P4 and P5 bit for bit; K3's copy kernel bit for bit,
and P1's tiled kernel at ragged shapes. score_epilogue bit for bit (scores, found, tile_max) against its
plain version at odd shapes, off 16-byte alignment and at Q 512 x
1,001,472, once per fused, exact and fast launch, and replayed by a graphed
fused launch. The whole TorchIndex on
the card, on the packed, unified and windowed-selection paths and with bf16
dense rows, and in the fused, exact and fast modes, is held against the same
index on the CPU and against the oracle. The prefix top-k, similarity top-k
and hybrid rerank ops run on the card as on the CPU, and HybridIndex's
results equal its host rows. While the tracer records, the fused and sparse
launches record the card's idle gap before each (device.idle).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(q, nd, n_slots, seed, dev):
    g = torch.Generator().manual_seed(seed)
    table = torch.where(torch.rand(nd, n_slots, generator=g) < 0.3,
                        torch.rand(nd, n_slots, generator=g) * 6, torch.zeros(()))
    table[-1] = 0.0
    mix = torch.zeros(q, nd)
    for i in range(q):
        cols = torch.randint(0, nd - 1, (3,), generator=g)
        mix[i, cols] = torch.rand(3, generator=g) + 0.2
    return mix.to(dev), table.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("q,nd,n_slots", [(8, 24, 4096), (100, 37, 2048),
                                          (512, 528, 16384)])
def test_heavy_fused3_matches_plain(cuda, q, nd, n_slots):
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    mix, table = _operands(q, nd, n_slots, q + nd, cuda)
    n_sub, n_tiles = n_slots // 128, n_slots // 2048
    for fast, tab in ((False, table), (True, table),
                      (True, table.to(torch.bfloat16))):
        n0 = hk.heavy_fused3.launches
        h, smax, cnt = hk.heavy_fused3(mix, tab, fast=fast)
        assert hk.heavy_fused3.launches == n0 + 1
        rh, rsmax, rcnt = hk.heavy_fused3_ref(mix, tab, fast=fast)
        torch.cuda.synchronize()
        assert torch.equal(cnt, rcnt)
        assert torch.equal(h > 0, rh > 0)
        torch.testing.assert_close(h, rh, rtol=1e-6, atol=0)
        torch.testing.assert_close(smax[:n_sub], rsmax[:n_sub], rtol=1e-6, atol=0)
        assert torch.equal(smax[:n_sub], h.view(q, n_sub, 128).amax(2).T)
        assert torch.all(smax[n_sub:] == float("-inf"))
        assert torch.all(cnt[n_tiles:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ids", [1, 17, 528])
def test_gather_rows_bit_exact(cuda, n_ids):
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    _mix, table = _operands(4, 40, 4096, n_ids, cuda)
    ids = torch.randint(0, 40, (n_ids,), device=cuda, dtype=torch.int32)
    assert torch.equal(hk.gather_rows(ids, table), hk.gather_rows_ref(ids, table))
    got = hk.gather_rows_bf16(ids, table)
    assert torch.equal(got.view(torch.int16),
                       hk.gather_rows_bf16_ref(ids, table).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_torch_index_on_card_matches_cpu_and_oracle(cuda, fast):
    _index_on_card_matches(cuda, fast=fast)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("path", ["unified", "select"])
def test_kernel_paths_on_card_match_cpu_and_oracle(cuda, fast, path,
                                                   monkeypatch):
    """unified=True (K5) and NEXTSEARCH_SELECT_PALLAS=1 (K4) through the
    whole TorchIndex: the kernel launches, and results equal the CPU
    index's and the oracle's."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import select_kernels as sk

    if path == "select":
        monkeypatch.setenv("NEXTSEARCH_SELECT_PALLAS", "1")
        counter = sk.per_query_topk
    else:
        counter = hk.unified_fused
    n0 = counter.launches
    _index_on_card_matches(cuda, fast=fast, unified=path == "unified")
    assert counter.launches > n0


def _index_on_card_matches(cuda, *, fast, unified=False):
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.oracle import oracle_search
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), fast_heavy=fast, unified=unified,
    ))
    queries = sample_queries(probs, 256, 128, seed=3)
    on_card = TorchIndex([seg], config=cfg, device=cuda)
    on_cpu = TorchIndex([seg], config=cfg, device="cpu")
    assert on_card.n_dense > 0
    oseg = [seg.to_oracle_segment()]
    for batch in queries:
        a = on_card.search_batch(batch, k=10)
        b = on_cpu.search_batch(batch, k=10)
        for terms, x, y in zip(batch, a, b):
            assert x.found == y.found
            assert np.array_equal(x.scores, y.scores)
            assert np.array_equal(x.doc_slots, y.doc_slots)
        for terms, x in list(zip(batch, a))[:24]:
            hits, found = oracle_search(oseg, terms, k=10)
            assert x.found == found
            assert [np.float32(s) for s, _g, _d in hits] == list(x.scores)
            assert [d for _s, _g, d in hits] == x.doc_slots.tolist()


def _windows(q, w_max, seed, dev):
    """Q windows of random lengths up to w_max (the first empty, the last
    full), with dead slots and ties; bounds int64 [Q + 1]."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(0, w_max + 1, (q,), generator=g)
    lens[0], lens[-1] = 0, w_max
    bounds = torch.zeros(q + 1, dtype=torch.int64)
    bounds[1:] = torch.cumsum(lens, 0)
    n = int(bounds[-1]) + 37
    # few distinct values: many ties, some across 1024-entry boundaries
    scores = (torch.randint(0, 50, (n,), generator=g).float() / 8.0)
    scores[torch.rand(n, generator=g) < 0.3] = 0.0
    return scores.to(dev), bounds.to(dev)


def _joined(wins, dev):
    """One flat array of the given windows (float32 numpy arrays) and its
    int64 bounds."""
    lens = [len(w) for w in wins]
    bounds = torch.zeros(len(wins) + 1, dtype=torch.int64)
    bounds[1:] = torch.cumsum(torch.tensor(lens), 0)
    flat = np.concatenate(wins).astype(np.float32) if sum(lens) else \
        np.zeros(1, np.float32)
    return torch.from_numpy(flat).to(dev), bounds.to(dev)


def _threshold_case(case, k2, dev):
    """Windows aimed at the threshold select's steps: (scores, bounds)."""
    rng = np.random.default_rng(k2)
    f32 = np.float32
    if case == "repeat_long":
        # one value repeated past the 4,096-entry shared tile, and the same
        # with a few larger values at random places
        a = np.full(10_000, f32(0.75))
        b = np.full(6_000, f32(0.75))
        b[rng.choice(6_000, 7, replace=False)] = f32(2.0)
        c = np.full(4_096, f32(0.75))  # exactly the tile
        return _joined([a, b, c], dev)
    if case == "straddle":
        # the k2-th slot falls inside a run of equal values, in windows
        # staged and not; values that agree in their top 24 bits too
        wins = []
        for n in (300, 3_000, 9_000):
            w = np.zeros(n, np.float32)
            pos = rng.permutation(n)
            top = k2 // 2
            w[pos[:top]] = rng.uniform(3.0, 4.0, top).astype(f32)
            w[pos[top:top + k2]] = f32(2.0)  # the run across slot k2
            near = np.nextafter(f32(1.0), f32(2.0)) + np.arange(40, dtype=f32) \
                * np.finfo(f32).eps
            w[pos[top + k2:top + k2 + 40]] = near.astype(f32)
            wins.append(w)
            # the run straddles the k2-th slot among last-byte neighbours
            w2 = np.zeros(n, np.float32)
            base = np.float32(1.5).view(np.uint32)
            bits = base + rng.integers(0, 3, n).astype(np.uint32)
            w2[:] = bits.view(np.float32)
            w2[rng.random(n) < 0.2] = 0.0
            wins.append(w2)
        return _joined(wins, dev)
    if case == "live_count":
        # live counts exactly k2, k2 - 1 and k2 + 1, dead slots between
        wins = []
        for live in (k2, k2 - 1, k2 + 1):
            w = np.zeros(3 * k2 + 5, np.float32)
            at = rng.choice(len(w), live, replace=False)
            w[at] = rng.integers(1, 6, live).astype(f32)  # ties among them
            wins.append(w)
        return _joined(wins, dev)
    if case == "specials":
        # NaN, -0.0, negatives and subnormals: only positive values live,
        # positive subnormals among them
        sub = np.float32(1e-40)
        w = np.array([np.nan, -0.0, 0.0, -1.0, -sub, sub, 2 * sub, sub, 1.0,
                      3.0, -np.inf, np.nan, 0.5, sub], np.float32)
        big = rng.uniform(-1, 1, 5_000).astype(f32)
        big[rng.random(5_000) < 0.1] = np.nan
        big[rng.random(5_000) < 0.1] = -0.0
        tiny = rng.random(5_000) < 0.2
        big[tiny] = (rng.integers(-3, 4, int(tiny.sum())) * 1e-40).astype(f32)
        few = np.array([sub, -sub, np.nan, -0.0], np.float32)
        # the k2-th largest among tied subnormals
        low = (rng.integers(-3, 4, 600) * 1e-40).astype(f32)
        low[rng.choice(600, 3, replace=False)] = f32(0.25)
        return _joined([w, big, few, np.tile(w, 20), low], dev)
    if case == "empty_and_long":
        # windows of 0 and of 40,000 entries in one launch
        long = rng.integers(0, 50, 40_000).astype(f32) / 8
        long[rng.random(40_000) < 0.3] = 0.0
        mid = rng.random(500).astype(f32)
        return _joined([np.zeros(0, np.float32), long, np.zeros(0, np.float32),
                        mid, long[::-1].copy(), np.zeros(0, np.float32)], dev)
    raise ValueError(case)


K4_CASES = [
    # (q, k2, w_max) of random windows, as before
    (512, 32, 8192),     # serving-like
    (64, 32, 40000),     # windows past the TPU kernel's 32768 bound
    (100, 5, 3000),
    (7, 128, 300),       # k2 above the live count
    # the threshold select's steps
    ("repeat_long", 32), ("straddle", 32), ("straddle", 128),
    ("live_count", 32), ("live_count", 128), ("specials", 32),
    ("specials", 5), ("empty_and_long", 32), ("empty_and_long", 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES, ids=[
    "-".join(map(str, c)) for c in K4_CASES])
def test_per_query_topk_matches_plain(cuda, case):
    """The threshold select bit-equal to the plain version."""
    from nextsearch_tpu_torch.ops import select_kernels as sk

    if len(case) == 3:
        q, k2, w_max = case
        scores, bounds = _windows(q, w_max, q + k2, cuda)
    else:
        name, k2 = case
        scores, bounds = _threshold_case(name, k2, cuda)
    rv, rg = sk.per_query_topk_ref(scores, bounds, k2)
    n0 = sk.per_query_topk.launches
    v, g = sk.per_query_topk(scores, bounds, k2)
    assert sk.per_query_topk.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(g, rg)
    assert bool((v > 0).any())


def _sorted_entries(q, n_slots, n, seed, dev):
    """n light entries sorted by (doc, q), with repeated (q, doc) pairs,
    plus sentinel lanes (doc = n_slots) at the end."""
    g = torch.Generator().manual_seed(seed)
    doc = torch.randint(0, n_slots, (n,), generator=g)
    doc[: n // 4] = torch.randint(0, 256, (n // 4,), generator=g)  # dense runs
    qq = torch.randint(0, q, (n,), generator=g)
    key, order = torch.sort(doc * q + qq, stable=True)
    sd = torch.cat([key // q, torch.full((50,), n_slots)])
    sq = torch.cat([key % q, torch.zeros(50, dtype=torch.int64)])
    sv = torch.cat([torch.rand(n, generator=g)[order] + 0.05, torch.zeros(50)])
    return sd.to(dev), sq.to(dev), sv.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("q,nd,n_slots,n", [(8, 24, 4096, 300),
                                            (100, 37, 2048, 2000),
                                            (512, 528, 16384, 60000)])
def test_unified_fused_matches_plain(cuda, q, nd, n_slots, n):
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    mix, table = _operands(q, nd, n_slots, q + n, cuda)
    sd, sq, sv = _sorted_entries(q, n_slots, n, n, cuda)
    n_sub, n_tiles = n_slots // 128, n_slots // 2048
    for fast, tab in ((False, table), (True, table.to(torch.bfloat16))):
        n0 = hk.unified_fused.launches
        tot, smax, cnt = hk.unified_fused(mix, tab, sd, sq, sv, fast=fast)
        again = hk.unified_fused(mix, tab, sd, sq, sv, fast=fast)
        assert hk.unified_fused.launches == n0 + 2
        rt, rsmax, rcnt = hk.unified_fused_ref(mix, tab, sd, sq, sv, fast=fast)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((tot, smax, cnt), again))
        assert torch.equal(cnt, rcnt)
        assert torch.equal(tot > 0, rt > 0)
        torch.testing.assert_close(tot, rt, rtol=2e-6, atol=0)
        torch.testing.assert_close(smax[:n_sub], rsmax[:n_sub], rtol=2e-6, atol=0)
        assert torch.equal(smax[:n_sub], tot.view(q, n_sub, 128).amax(2).T)
        assert torch.all(smax[n_sub:] == float("-inf"))
        assert torch.all(cnt[n_tiles:] == 0)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
@pytest.mark.parametrize("q,nd,n_slots", [(8, 24, 4096), (100, 37, 2048),
                                          (512, 384, 16384)])
def test_heavy_fused_k6_matches_plain(cuda, q, nd, n_slots):
    """K6 over f32/bf16 tables, exact/fast, f32 and bf16-up H; it counts
    in heavy_fused.launches, not K1's."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    mix, table = _operands(q, nd, n_slots, q + nd + 1, cuda)
    n_sub = n_slots // 128
    for fast, tab in ((False, table), (True, table),
                      (False, table.to(torch.bfloat16)),
                      (True, table.to(torch.bfloat16))):
        k1, k6 = hk.heavy_fused3.launches, hk.heavy_fused.launches
        h, smax, cnt = hk.heavy_fused(mix, tab, fast=fast)
        hb, smax_b, cnt_b = hk.heavy_fused(mix, tab, fast=fast,
                                           h_dtype=torch.bfloat16)
        assert (hk.heavy_fused3.launches, hk.heavy_fused.launches) == (k1, k6 + 2)
        rh, rsmax, rcnt = hk.heavy_fused_ref(mix, tab, fast=fast)
        torch.cuda.synchronize()
        assert torch.equal(cnt, rcnt) and torch.equal(cnt_b, rcnt)
        torch.testing.assert_close(h, rh, rtol=1e-6, atol=0)
        torch.testing.assert_close(smax[:n_sub], rsmax[:n_sub], rtol=1e-6, atol=0)
        assert torch.equal(smax, smax_b)
        assert hb.dtype == torch.bfloat16
        assert torch.equal(_bits(hb), _bits(hk.round_up_bf16(h)))


@pytest.mark.cuda
def test_k1_exact_over_bf16_table_rounds_mix(cuda):
    """Exact mode over a bf16 table rounds mix to bf16 in the kernel, as
    the reference's mix.astype(table.dtype): equal to the plain version,
    and away from the unrounded product by the mix's rounding."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    g = torch.Generator().manual_seed(11)
    mix = (torch.rand(64, 40, generator=g) + 0.1).to(cuda)
    table = torch.rand(40, 4096, generator=g).to(cuda).to(torch.bfloat16)
    for fn in (hk.heavy_fused3, hk.heavy_fused):
        h, _smax, _cnt = fn(mix, table, fast=False)
        rh = hk.heavy_fused3_ref(mix, table, fast=False)[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(h, rh, rtol=1e-6, atol=0)
        assert float((h - mix @ table.float()).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("q,nd,n_slots", [(8, 24, 4096), (100, 37, 6144),
                                          (512, 384, 16384)])
def test_heavy_fused_variant_p6_matches_plain(cuda, q, nd, n_slots):
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    mix, table = _operands(q, nd, n_slots, q + nd + 2, cuda)
    tab = table.to(torch.bfloat16)
    n_sub = n_slots // 128
    full = hk.heavy_fused_variant(mix, tab)
    for kw in ({}, dict(epilogue=False), dict(smax_store=False),
               dict(store_h=False), dict(h_dtype=torch.bfloat16)):
        n0 = hk.heavy_fused_variant.launches
        h, smax, cnt = hk.heavy_fused_variant(mix, tab, **kw)
        assert hk.heavy_fused_variant.launches == n0 + 1
        rh, rsmax, rcnt = hk.heavy_fused_variant_ref(mix, tab, **kw)
        torch.cuda.synchronize()
        assert torch.equal(cnt, rcnt), kw
        fin = torch.isfinite(rsmax)
        assert torch.equal(torch.isfinite(smax), fin), kw
        torch.testing.assert_close(smax[fin], rsmax[fin], rtol=1e-6, atol=0)
        if kw.get("h_dtype") == torch.bfloat16:
            assert torch.equal(_bits(h), _bits(full[0].to(torch.bfloat16)))
        else:
            torch.testing.assert_close(h, rh, rtol=1e-6, atol=0)
        if kw.get("store_h") is False:
            assert not bool(h.any())
    assert torch.equal(full[1][:n_sub], full[0].view(q, n_sub, 128).amax(2).T)


@pytest.mark.cuda
def test_probe_kernels_p1_to_p5_match_plain(cuda):
    from nextsearch_tpu_torch.ops import probe_kernels as pk

    g = torch.Generator().manual_seed(5)
    a = torch.rand(128, 512, generator=g).to(cuda)
    b = torch.rand(1024, 512, generator=g).to(cuda)
    torch.testing.assert_close(pk.nt_dot(a, b), pk.nt_dot_ref(a, b),
                               rtol=2 * 512 * 2.0 ** -24, atol=0)
    e = torch.rand(16, 512, generator=g).to(cuda)
    off = torch.tensor([3], dtype=torch.int32, device=cuda)
    assert torch.equal(pk.row_copy(e, off, 8), pk.row_copy_ref(e, off, 8))
    wq = torch.randint(0, 128, (512,), generator=g).to(cuda)
    wd = torch.randint(0, 1024, (512,), generator=g).to(cuda)
    wq[:4], wd[:4] = 7, 9  # one cell with four entries
    wv = (torch.rand(512, generator=g) + 0.5).to(cuda)
    torch.testing.assert_close(pk.window_op(wq, wv, wd, q=128, tile=1024),
                               pk.window_op_ref(wq, wv, wd, q=128, tile=1024),
                               rtol=1e-6, atol=0)
    r = torch.rand(4, 128, 128, generator=g).to(cuda)
    assert torch.equal(pk.reshape_copy(r, (512, 128)),
                       pk.reshape_copy_ref(r, (512, 128)))
    for shape in ((1, 128), (37, 300)):
        t = torch.rand(*shape, generator=g).to(cuda)
        assert torch.equal(pk.transpose(t), pk.transpose_ref(t))
    assert all(f.launches > 0 for f in (pk.nt_dot, pk.row_copy, pk.window_op,
                                        pk.reshape_copy, pk.transpose))


def _window_case(case, g):
    q, tile, w = 128, 1024, 512
    wq = torch.randint(0, q, (w,), generator=g)
    wd = torch.randint(0, tile, (w,), generator=g)
    if case == "four_in_a_cell":
        wq[:4], wd[:4] = 7, 9
    elif case == "three_cells":
        pick = torch.randint(0, 3, (w,), generator=g)
        wq = torch.tensor([5, 5, 127])[pick]
        wd = torch.tensor([0, 1023, 512])[pick]
    elif case == "last_row":
        wq[:] = q - 1
    wv = torch.rand(w, generator=g) + 0.5
    return wq, wv, wd, q, tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["four_in_a_cell", "three_cells", "last_row"])
def test_window_op_matches_entry_order_sum(cuda, case):
    """P3's band kernel bit-equal to np.add.at, the entries of a cell added
    in entry order into 0. Against the plain version (index_put_ with
    accumulate): bit for bit where no cell holds 32 entries; past that
    PyTorch sums a cell's entries a warp at a time, so within 512 * 2^-24
    relative (two orders of a 512-term positive sum)."""
    from nextsearch_tpu_torch.ops import probe_kernels as pk

    wq, wv, wd, q, tile = _window_case(case, torch.Generator().manual_seed(11))
    want = np.zeros((q, tile), np.float32)
    np.add.at(want, (wq.numpy(), wd.numpy()), wv.numpy())
    want = torch.from_numpy(want).to(cuda)
    wq, wv, wd = wq.to(cuda), wv.to(cuda), wd.to(cuda)
    plain = pk.window_op_ref(wq, wv, wd, q=q, tile=tile)
    crowded = int(torch.bincount(wq * tile + wd).max()) >= 32
    n0 = pk.window_op.launches
    got = pk.window_op(wq, wv, wd, q=q, tile=tile)
    torch.cuda.synchronize()
    assert pk.window_op.launches == n0 + 1
    assert torch.equal(got, want)
    if crowded:
        torch.testing.assert_close(got, plain, rtol=512 * 2.0 ** -24, atol=0)
    else:
        assert torch.equal(got, plain)
    assert crowded == (case == "three_cells")


@pytest.mark.cuda
def test_gather_bf16_rows_bit_exact(cuda):
    """K3 over a bf16 table keeps the rows bf16, bit for bit."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    _mix, table = _operands(4, 40, 4096, 9, cuda)
    tab = table.to(torch.bfloat16)
    ids = torch.randint(0, 40, (300,), device=cuda, dtype=torch.int32)
    n0 = hk.gather_bf16_rows.launches
    got = hk.gather_bf16_rows(ids, tab)
    assert hk.gather_bf16_rows.launches == n0 + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       hk.gather_rows_ref(ids, tab).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("unified", [False, True])
def test_torch_index_bf16_rows_on_card_match_cpu_and_oracle(cuda, unified):
    """dense_rows_bf16: K3 over bf16 rows and K1 (or K5) over the bf16
    table on every launch, v2 rescore; results equal the CPU index's and,
    outside the documented false-tie class, the oracle's."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.oracle import oracle_search
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), dense_rows_bf16=True, unified=unified,
    ))
    on_card = TorchIndex([seg], config=cfg, device=cuda)
    on_cpu = TorchIndex([seg], config=cfg, device="cpu")
    assert on_card.n_dense > 0 and on_card.bucket_pos is not None
    n0 = hk.gather_bf16_rows.launches
    oseg = [seg.to_oracle_segment()]
    for batch in sample_queries(probs, 256, 128, seed=4):
        a = on_card.search_batch(batch, k=10)
        b = on_cpu.search_batch(batch, k=10)
        for x, y in zip(a, b):
            assert x.found == y.found
            assert np.array_equal(x.scores, y.scores)
            assert np.array_equal(x.doc_slots, y.doc_slots)
        for terms, x in list(zip(batch, a))[:24]:
            hits, found = oracle_search(oseg, terms, k=10)
            assert x.found == found
    assert hk.gather_bf16_rows.launches > n0


def _mix_kinds(kind, q, nd, seed, dev):
    """Mixes of the product's two paths: "sparse" (1-4 entries a row, the
    serving plans' shape, plus zero rows), "dense" (torch.rand, the probes'),
    and "mixed" (dense rows in some 64-query blocks only)."""
    g = torch.Generator().manual_seed(seed)
    mix = torch.zeros(q, nd)
    for i in range(q):
        k = int(torch.randint(0, 5, (1,), generator=g))
        cols = torch.randperm(nd - 1, generator=g)[:k]
        mix[i, cols] = torch.rand(k, generator=g) + 0.2
    if kind != "sparse":
        rows = slice(None) if kind == "dense" else slice(64, 128)
        mix[rows] = torch.rand(mix[rows].shape, generator=g) + 0.05
    return mix.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sparse", "dense", "mixed"])
@pytest.mark.parametrize("q,nd", [(512, 384), (200, 1877), (37, 20)])
def test_mix_lists_kernel_bit_exact(cuda, kind, q, nd):
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    mix = _mix_kinds(kind, q, nd, q + nd, cuda)
    for round_bf16 in (False, True):
        for cap in (None, 0, 5):
            n0 = hk.mix_lists.launches
            got = hk.mix_lists(mix, round_bf16, cap)
            assert hk.mix_lists.launches == n0 + 1
            exp = hk.mix_lists_ref(mix, round_bf16, cap)
            torch.cuda.synchronize()
            for a, b in zip(got, exp):
                assert a.dtype == b.dtype and torch.equal(a, b), (round_bf16, cap)
    with_rows = hk.mix_lists(mix, True, with_bf16=True)
    assert all(torch.equal(a, b)
               for a, b in zip(with_rows[:3], hk.mix_lists_ref(mix, True)))
    assert torch.equal(_bits(with_rows[3]), _bits(hk.mix_bf16_padded_ref(mix)))


def _tc_rtol(nd):
    """Tolerance of the tensor-core dense kernel's H and smax against the
    plain version and the gather: the same exact bf16 x bf16
    products, nd non-negative terms added in f32; the tensor cores round
    (toward zero) once per 16-term mma step, so nd / 16 steps of 2^-23,
    doubled for the other side's own rounding, plus 8 steps for short
    contractions (the worst case of any order would be nd * 2^-23)."""
    return (nd / 8 + 8) * 2.0 ** -23


def _close(got, exp, rtol):
    """cnt bit for bit, the same smax padding, finite smax and an f32 H
    within rtol, H > 0 bit for bit."""
    assert torch.equal(got[2], exp[2])
    fin = torch.isfinite(exp[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    torch.testing.assert_close(got[1][fin], exp[1][fin], rtol=rtol, atol=0)
    if got[0].dtype == torch.float32:
        assert torch.equal(got[0] > 0, exp[0] > 0)
        torch.testing.assert_close(got[0], exp[0], rtol=rtol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sparse", "dense", "mixed"])
def test_gather_and_dense_paths_match_plain_and_each_other(cuda, kind):
    """K1/K6 (f32 and bf16 tables, both modes, f32 and bf16-up H), K5 and
    every P6 switch over one mix, against the same launch with the lists'
    capacity forced to 0 (every block with a nonzero entry takes a dense
    kernel). f32-exact launches (the FFMA loop): bit-equal to the gather.
    bf16 operands: the tensor-core kernel agrees with the gather in cnt and
    H > 0 bit for bit and in H and smax within _tc_rtol; its smax is the
    max of its own H and its bf16 H the rounding of its own f32 H."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    q, nd, n_slots = 200, 64, 6144
    mix = _mix_kinds(kind, q, nd, 7, cuda)
    _m, table = _operands(q, nd, n_slots, 8, cuda)
    tab16 = table.to(torch.bfloat16)
    sd, sq, sv = _sorted_entries(q, n_slots, 3000, 9, cuda)
    n_sub = n_slots // 128
    tol = _tc_rtol(nd)
    products = (hk.heavy_fused3, hk.heavy_fused, hk.unified_fused,
                hk.heavy_fused_variant)
    lists0 = hk.mix_lists.launches
    calls0 = sum(f.launches for f in products)

    def both(call, bf16_operands):
        """(the launch as it routes itself, the launch forced dense)."""
        got, dense = call(), call(list_cap=0)
        torch.cuda.synchronize()
        if not bf16_operands:
            # the gather and the cp.async-fed FFMA kernel run the same
            # fmaf chains
            for a, b in zip(got, dense):
                assert torch.equal(_bits(a), _bits(b))
            return got, dense
        _close(dense, got, tol)
        return got, dense

    for fast, tab in ((False, table), (True, table), (False, tab16),
                      (True, tab16)):
        bf16_ops = fast or tab.dtype == torch.bfloat16
        rtol = tol if bf16_ops else 1e-6
        for fn, ref in ((hk.heavy_fused3, hk.heavy_fused3_ref),
                        (hk.heavy_fused, hk.heavy_fused_ref)):
            outs = {}
            for h_dtype in (torch.float32, torch.bfloat16):
                outs[h_dtype] = both(
                    lambda **kw: fn(mix, tab, fast=fast, h_dtype=h_dtype,
                                    **kw), bf16_ops)
                exp = ref(mix, tab, fast=fast, h_dtype=h_dtype)
                for got in outs[h_dtype]:
                    _close(got, exp, rtol)
            for f32, up in zip(outs[torch.float32], outs[torch.bfloat16]):
                assert torch.equal(_bits(up[0]), _bits(hk.round_up_bf16(f32[0])))
                assert torch.equal(up[1], f32[1]) and torch.equal(up[2], f32[2])
                assert torch.equal(f32[1][:n_sub],
                                   f32[0].view(q, n_sub, 128).amax(2).T)
        exp = hk.unified_fused_ref(mix, tab, sd, sq, sv, fast=fast)
        for got in both(lambda **kw: hk.unified_fused(mix, tab, sd, sq, sv,
                                                      fast=fast, **kw),
                        bf16_ops):
            _close(got, exp, max(rtol, 2e-6))
            assert torch.equal(got[1][:n_sub],
                               got[0].view(q, n_sub, 128).amax(2).T)
    full = None
    for kw in ({}, dict(epilogue=False), dict(smax_store=False),
               dict(store_h=False), dict(h_dtype=torch.bfloat16)):
        pair = both(lambda **sw: hk.heavy_fused_variant(mix, tab16, **kw,
                                                        **sw), True)
        full = full or pair
        exp = hk.heavy_fused_variant_ref(mix, tab16, **kw)
        for got, f in zip(pair, full):
            _close(got, exp, tol)
            if kw.get("h_dtype") == torch.bfloat16:
                assert torch.equal(_bits(got[0]), _bits(f[0].to(torch.bfloat16)))
            if kw.get("store_h") is False:
                assert not bool(got[0].any())
    # one pre-pass per product launch
    assert hk.mix_lists.launches - lists0 == \
        sum(f.launches for f in products) - calls0


@pytest.mark.cuda
@pytest.mark.parametrize("q,nd", [(512, 384), (200, 1877), (37, 20)])
@pytest.mark.parametrize("bf16_table", [True, False])
def test_dense_tensor_core_kernel_matches_plain(cuda, q, nd, bf16_table):
    """Dense mixes (every block takes the dense kernel) at ND 384 and at
    ragged Q and ND, over bf16 and f32 tables: K1/K6 fast with all three H
    stores, K1 exact (the tensor cores over a bf16 table, the FFMA loop over
    an f32 one), K5 with entries and every P6 switch against their plain
    versions within _tc_rtol, cnt and H > 0 bit for bit; the identities of
    one kernel bit for bit (smax the max of its own H, a bf16 H the
    rounding of its own f32 H, exact equal to fast over a bf16 table, P6
    full equal to K6)."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    n_slots = 4096
    g = torch.Generator().manual_seed(q + nd)
    mix = (torch.rand(q, nd, generator=g) + 0.05).to(cuda)
    _m, table = _operands(q, nd, n_slots, nd, cuda)
    tab = table.to(torch.bfloat16) if bf16_table else table
    sd, sq, sv = _sorted_entries(q, n_slots, 3000, 5, cuda)
    n_sub = n_slots // 128
    tol = _tc_rtol(nd)

    def own_max(got):
        assert torch.equal(got[1][:n_sub], got[0].view(q, n_sub, 128).amax(2).T)

    fast = hk.heavy_fused3(mix, tab, fast=True)
    _close(fast, hk.heavy_fused3_ref(mix, tab, fast=True), tol)
    own_max(fast)
    k6 = hk.heavy_fused(mix, tab, fast=True)
    assert all(torch.equal(a, b) for a, b in zip(k6, fast))
    up = hk.heavy_fused3(mix, tab, fast=True, h_dtype=torch.bfloat16)
    assert torch.equal(_bits(up[0]), _bits(hk.round_up_bf16(fast[0])))
    assert torch.equal(up[1], fast[1]) and torch.equal(up[2], fast[2])
    exact = hk.heavy_fused3(mix, tab, fast=False)
    _close(exact, hk.heavy_fused3_ref(mix, tab, fast=False), tol)
    own_max(exact)
    if bf16_table:
        assert torch.equal(exact[0], fast[0])
    for mode in (True, False):
        tot = hk.unified_fused(mix, tab, sd, sq, sv, fast=mode)
        again = hk.unified_fused(mix, tab, sd, sq, sv, fast=mode)
        assert all(torch.equal(a, b) for a, b in zip(tot, again))
        _close(tot, hk.unified_fused_ref(mix, tab, sd, sq, sv, fast=mode),
               max(tol, 2e-6))
        own_max(tot)
    for kw in ({}, dict(epilogue=False), dict(smax_store=False),
               dict(store_h=False), dict(h_dtype=torch.bfloat16)):
        got = hk.heavy_fused_variant(mix, tab, **kw)
        _close(got, hk.heavy_fused_variant_ref(mix, tab, **kw), tol)
        if not kw:
            assert torch.equal(got[0], fast[0])
        if kw.get("h_dtype") == torch.bfloat16:
            assert torch.equal(_bits(got[0]), _bits(fast[0].to(torch.bfloat16)))
        if kw.get("store_h") is False:
            assert not bool(got[0].any())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_ids", [1, 448, 70_000])
def test_k3_copies_bit_exact(cuda, n_ids, bf16):
    """K3's unrolled register copy against the plain version, bit for bit:
    rows that are no multiple of a thread's unrolled trip, ids out of range
    (clamped), more ids than one grid dimension holds; an empty id list is
    refused."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    n_rows, n_slots = (33, 40) if n_ids > 1000 else (50, 40968)
    g = torch.Generator().manual_seed(n_ids)
    table = torch.randn(n_rows, n_slots, generator=g).to(cuda)
    ids = torch.randint(-3, n_rows + 3, (n_ids,), generator=g).to(
        torch.int32).to(cuda)
    fn = hk.gather_rows
    if bf16:
        table, fn = table.to(torch.bfloat16), hk.gather_bf16_rows
    want = hk.gather_rows_ref(ids.long().clamp(0, n_rows - 1), table)
    n0 = fn.launches
    got = fn(ids, table)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and got.dtype == table.dtype
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    with pytest.raises(ValueError):
        fn(ids[:0], table)


@pytest.mark.cuda
@pytest.mark.parametrize("q,t,w", [(128, 1024, 512), (5, 3, 7), (33, 70, 130),
                                   (128, 1024, 510), (1, 1, 1), (64, 100, 36)])
def test_nt_dot_tiled_ragged_shapes(cuda, q, t, w):
    """P1's register-tiled kernel at ragged Q, T and W (W off a multiple of
    4 takes the 4-byte copies): the plain version within 2 * W * 2^-24 of
    the row's magnitude (two orders of a W-term positive sum)."""
    from nextsearch_tpu_torch.ops import probe_kernels as pk

    g = torch.Generator().manual_seed(q + t + w)
    a = torch.rand(q, w, generator=g).to(cuda)
    b = torch.rand(t, w, generator=g).to(cuda)
    n0 = pk.nt_dot.launches
    new = pk.nt_dot(a, b)
    torch.cuda.synchronize()
    assert pk.nt_dot.launches == n0 + 1
    torch.testing.assert_close(new, pk.nt_dot_ref(a, b),
                               rtol=2 * max(w, 8) * 2.0 ** -24, atol=0)


def _fast_mode_agrees(res, hits, found, locate, rtol=1e-5):
    """A fast-mode result against the oracle's top k + 1 (hits): found
    equal, scores within rtol rank by rank, and the doc equal at every rank
    whose oracle score stands more than 2 * rtol apart from both its
    neighbours'. The card adds a doc's contributions with atomics in any
    order, so scores that are equal or an ULP apart may swap ranks."""
    assert res.found == found
    want = np.array([s for s, _g, _d in hits], np.float32)
    n = len(res.scores)
    assert n == min(len(hits), 10)
    np.testing.assert_allclose(res.scores, want[:n], rtol=rtol)
    for i in range(n):
        near = any(0 <= j < len(want)
                   and abs(want[j] - want[i]) <= 2 * rtol * want[i]
                   for j in (i - 1, i + 1))
        assert near or locate(int(res.doc_slots[i]))[1] == hits[i][2]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kw", [
    ("fused", {}), ("fused", {"scores_bf16": True}),
    ("fused", {"dense_rows_bf16": True}), ("exact", {}), ("fast", {}),
])
def test_torch_index_modes_on_card_match_cpu_and_oracle(cuda, mode, kw):
    """The fused, exact and fast modes on the card against the same index
    on the CPU and the oracle: fused and exact bit for bit; fast by
    _fast_mode_agrees (atomic adds in any order). The fused launch runs K3
    once per batch."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.oracle import oracle_search
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode=mode, posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), **kw))
    queries = sample_queries(probs, 128, 64, seed=3)
    on_card = TorchIndex([seg], config=cfg, device=cuda)
    on_cpu = TorchIndex([seg], config=cfg, device="cpu")
    assert on_card.n_dense > 0 and on_card.n_slots % 2048 == 0
    k3 = hk.gather_bf16_rows if kw.get("dense_rows_bf16") else hk.gather_rows
    oseg = [seg.to_oracle_segment()]
    for batch in queries:
        n0, c0 = k3.launches, on_card.launch_cache.captures
        a = on_card.search_batch(batch, k=10)
        # a batch that captures its graph launches K3 once more, eagerly
        captured = on_card.launch_cache.captures - c0
        assert k3.launches == n0 + (1 + captured if mode == "fused" else 0)
        if mode != "fast":
            for terms, x, y in zip(batch, a, on_cpu.search_batch(batch, k=10)):
                assert x.found == y.found, terms
                assert np.array_equal(x.doc_slots, y.doc_slots), terms
                assert np.array_equal(x.scores, y.scores), terms
        for terms, x in list(zip(batch, a))[:24]:
            hits, found = oracle_search(oseg, terms, k=11)
            if mode == "fast":
                _fast_mode_agrees(x, hits, found, on_card.locate)
                continue
            assert x.found == found
            assert [d for _s, _g, d in hits[:10]] == x.doc_slots.tolist()
            assert np.array_equal(
                x.scores, np.array([s for s, _g, _d in hits[:10]], np.float32))
    if mode == "exact":
        again = on_card.search_batch(queries[0], k=10)
        first = on_card.search_batch(queries[0], k=10)
        for x, y in zip(again, first):
            assert np.array_equal(x.scores.view(np.uint32),
                                  y.scores.view(np.uint32))


# ------------------------------------------- autocomplete, expansion, hybrid


@pytest.mark.cuda
def test_prefix_topk_on_card_equals_cpu(cuda):
    """prefix_range_topk and prefix_window_topk on the card give the CPU's
    values and indices bit for bit (ties by the lower index)."""
    from nextsearch_tpu_torch.ops import prefix

    g = torch.Generator().manual_seed(4)
    scores = torch.randint(1, 6, (4096,), generator=g, dtype=torch.int32)
    scores[-300:] = -1
    lo = torch.randint(0, 4096, (64,), generator=g, dtype=torch.int32)
    hi = torch.minimum(lo + torch.randint(0, 300, (64,), generator=g,
                                          dtype=torch.int32),
                       torch.tensor(4096, dtype=torch.int32))
    for fn, kw in ((prefix.prefix_range_topk, {}),
                   (prefix.prefix_window_topk, {"W": 512})):
        a = fn(scores.to(cuda), lo.to(cuda), hi.to(cuda), L=10, **kw)
        b = fn(scores, lo, hi, L=10, **kw)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_dense_ops_on_card_match_cpu(cuda):
    """similarity_topk (rows equal, sims within 2e-6) and hybrid_rerank (doc
    order equal, scores within rtol 2e-5) on the card against the CPU; both
    refuse to run a product on the card while TF32 is allowed."""
    from nextsearch_tpu_torch.ops import dense

    g = torch.Generator().manual_seed(5)
    emb = torch.nn.functional.normalize(torch.randn(5000, 64, generator=g), dim=1)
    q = emb[:7] + 0.3 * torch.randn(7, 64, generator=g)
    q = torch.nn.functional.normalize(q, dim=1)
    banned = torch.zeros(5000, dtype=torch.bool)
    banned[:3] = True
    torch.backends.cuda.matmul.allow_tf32 = False
    sv, sr = dense.similarity_topk(emb.to(cuda), q.to(cuda), banned.to(cuda),
                                   0.1, k=9)
    cv, cr = dense.similarity_topk(emb, q, banned, 0.1, k=9)
    assert torch.equal(sr.cpu(), cr)
    assert torch.allclose(sv.cpu(), cv, rtol=0, atol=2e-6)
    cand = torch.randint(0, 5000, (7, 100), generator=g, dtype=torch.int32)
    bm25 = torch.rand(7, 100, generator=g) * 5
    bm25[:, 90:] = 0.0
    a = dense.hybrid_rerank(emb.to(cuda), q.to(cuda), cand.to(cuda),
                            bm25.to(cuda), 0.5, K=10)
    b = dense.hybrid_rerank(emb, q, cand, bm25, 0.5, K=10)
    assert torch.equal(a[1].cpu(), b[1]) and torch.equal(a[2].cpu(), b[2])
    assert torch.allclose(a[0].cpu(), b[0], rtol=2e-5, atol=0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            dense.similarity_topk(emb.to(cuda), q.to(cuda), banned.to(cuda),
                                  0.1, k=9)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sparse", "fused"])
def test_hybrid_index_on_card_matches_host_rows(cuda, mode):
    """HybridIndex on the card: doc embeddings within 1e-6 of the CPU
    build, and every result equal to _host_hybrid_row over the card's own
    doc embeddings (doc order exact, scores within rtol 2e-5)."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.models.hybrid import HybridIndex
    from nextsearch_tpu_torch.models.semantic import SemanticIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(mode=mode, posting_block=64,
                                           dense_df_ratio=1 / 256))
    r = np.random.default_rng(6)
    vecs = r.standard_normal((3000, 32)).astype(np.float32)
    hys = []
    for dev in (cuda, "cpu"):
        sem = SemanticIndex(device=dev)
        assert sem.load_from_arrays(seg.terms, vecs)
        hys.append(HybridIndex(TorchIndex([seg], config=cfg, device=dev), sem))
    assert torch.allclose(hys[0].doc_emb.cpu(), hys[1].doc_emb, rtol=0, atol=1e-6)
    batch = sample_queries(probs, 64, 64, seed=4)[0]
    for q, x in zip(batch, hys[0].search_batch(batch, k=10)):
        y = hys[0]._host_hybrid_row(q, 10, 100)
        assert x.found == y.found
        assert np.array_equal(x.doc_slots, y.doc_slots)
        assert np.allclose(x.scores, y.scores, rtol=2e-5, atol=0)


# ------------------------------------------------------------ launch graphs


def _graph_index(cuda, mode="sparse", **fields):
    """A 20k-doc index on the card, pinned on its batch-64 envelope, and
    the query stream (batch 0 probed the pins)."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode=mode, posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), **fields))
    batches = sample_queries(probs, 6 * 64, 64, seed=5)
    ti = TorchIndex([seg], config=cfg, device=cuda)
    ti.pin_shapes(batches, scope_q=True)
    return seg, ti, batches


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.found == y.found
        assert np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32))
        assert np.array_equal(x.doc_slots, y.doc_slots)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "tripped", "unified", "K4", "fused"])
def test_graphed_launches_bit_equal_to_eager(cuda, path, monkeypatch):
    """Each graphed serving launch against the same index run eagerly, on
    the same batches: bit for bit, oracle-exact, one capture per key (the
    fast launch and, when the guard trips, the exact relaunch) and none
    after the first batch, the counters advanced by every replay."""
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.index.oracle import oracle_search
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    fields = {"unified": True} if path == "unified" else {}
    if path == "tripped":
        fields["fast_heavy_eps"] = 1e9
        monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "0")
    if path == "K4":
        monkeypatch.setenv("NEXTSEARCH_SELECT_PALLAS", "1")
    counter = {"unified": hk.unified_fused,
               "fused": hk.gather_rows}.get(path, hk.heavy_fused3)
    seg, ti, batches = _graph_index(
        cuda, "fused" if path == "fused" else "sparse", **fields)
    graphed, eager = ti.launch_cache, eager_cache(cuda)
    assert graphed.backend is not None and eager.backend is None
    oseg = [seg.to_oracle_segment()]
    for i, batch in enumerate(batches[1:]):
        ti.launch_cache = eager
        want = ti.search_batch(batch, k=10)
        ti.launch_cache = graphed
        caps, n0 = graphed.captures, counter.launches
        rel = ti.relaunches
        got = ti.search_batch(batch, k=10)
        _bits_equal(got, want)
        if i:
            assert graphed.captures == caps
        assert counter.launches > n0
        if path == "tripped":
            assert ti.relaunches == rel + 1
        for terms, x in list(zip(batch, got))[:16]:
            hits, found = oracle_search(oseg, terms, k=10)
            assert x.found == found
            assert [d for _s, _g, d in hits] == x.doc_slots.tolist()
    assert graphed.captures == (2 if path == "tripped" else 1)
    assert graphed.replays == len(batches[1:]) * (2 if path == "tripped" else 1)


@pytest.mark.cuda
def test_graphed_depth2_pipeline_chains_the_hybrid_rerank(cuda):
    """Two graphed launches in flight, the hybrid rerank chained on each
    handle's device_outs: equal to the same index and rerank run eagerly
    (the second replay must not overwrite the first's result)."""
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.models.hybrid import HybridIndex
    from nextsearch_tpu_torch.models.semantic import SemanticIndex

    seg, ti, batches = _graph_index(cuda)
    vecs = np.random.default_rng(6).standard_normal(
        (len(seg.terms), 32)).astype(np.float32)
    sem = SemanticIndex(device=cuda)
    assert sem.load_from_arrays(seg.terms, vecs)
    hy = HybridIndex(ti, sem)
    graphed = ti.launch_cache
    ti.launch_cache = eager_cache(cuda)
    want = [hy.search_batch(b, k=10) for b in batches[1:]]
    ti.launch_cache = graphed
    hy.search_batch(batches[1], k=10)  # capture
    window, got = [], []
    for b in batches[1:]:
        window.append(hy.search_batch_async(b, 10))
        if len(window) > 2:
            got.append(hy.search_batch_gather(window.pop(0)))
    got += [hy.search_batch_gather(h) for h in window]
    assert graphed.replays >= len(batches) - 1
    for g, w in zip(got, want):
        _bits_equal(g, w)


@pytest.mark.cuda
def test_host_sync_inside_a_capture_raises(cuda):
    from nextsearch_tpu_torch.ops.graphs import LaunchCache

    cache = LaunchCache(cuda)

    def syncs(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        cache.run(syncs, {"x": torch.ones(8, device=cuda)}, {})
    assert cache.captures == 0
    assert float((torch.ones(4, device=cuda) * 2).sum()) == 8.0


@pytest.mark.cuda
def test_dropping_an_index_releases_its_graph_pool(cuda):
    """The bytes the card holds after each drop (memory_reserved once the
    allocator's free blocks are returned: a live graph pool's blocks stay
    reserved, though not allocated between replays) do not grow."""
    import gc

    held = []
    for _ in range(3):
        _seg, ti, batches = _graph_index(cuda)
        ti.search_batch(batches[1], k=10)
        assert ti.launch_cache.captures == 1
        del ti
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_reserved(cuda))
    assert held[2] <= held[0]


def _affine(x, *, table, scale):
    return x * scale + table


@pytest.mark.cuda
def test_graphs_on_two_cards_replay_bit_equal_to_eager(cuda):
    """Graphs on two cards, cuda:0's captured first: a bare launch per
    card, then ShardedIndex over a (1, 2) mesh of the two cards, whose
    local steps replay one graph per card. Every replay on fresh inputs
    equals the eager launch bit for bit (a capture on another card's stream
    records nothing, and its replays would hand back the capture's
    output)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.ops.graphs import LaunchCache
    from nextsearch_tpu_torch.parallel.mesh import make_mesh
    from nextsearch_tpu_torch.parallel.sharded import ShardedIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    cards = [torch.device("cuda", i) for i in (0, 1)]
    for d in cards:
        cache = LaunchCache(d)
        table = torch.arange(64, dtype=torch.float32, device=d)
        for seed in range(3):
            g = torch.Generator().manual_seed(seed)
            x = torch.rand(64, generator=g).to(d)
            got = cache.run(_affine, {"x": x}, dict(table=table, scale=3.0))
            assert got.device == d
            assert torch.equal(got, _affine(x, table=table, scale=3.0))
        assert (cache.captures, cache.replays) == (1, 3)

    (seg0, probs), (seg1, _p) = (build_corpus(n, 3000, seed=s)
                                 for n, s in ((12000, 1), (9000, 2)))
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,)))
    si = ShardedIndex([seg0, seg1], make_mesh(dp=1, seg=2, devices=cards),
                      config=cfg)
    batches = sample_queries(probs, 6 * 64, 64, seed=5)
    si.pin_shapes(batches, scope_q=True)
    graphed = dict(si.launch_caches)
    assert set(graphed) == set(cards)
    eager = {d: eager_cache(d) for d in cards}
    si.warm_batch(batches[0], k=10)
    caps = {d: c.captures for d, c in graphed.items()}
    assert all(caps.values()), caps
    for b in batches[1:]:
        si.launch_caches = eager
        want = si.search_batch(b, k=10)
        si.launch_caches = graphed
        _bits_equal(si.search_batch(b, k=10), want)
    assert {d: c.captures for d, c in graphed.items()} == caps
    assert all(c.replays >= len(batches) for c in graphed.values())


# ------------------------------------------------------------ score epilogue


def _epilogue_operands(q, n, dtype, seed, dev, offset=0):
    """Pass-1-like scores (30% positive, the rest +0) and an f32 heavy
    product on the card; offset > 0 shifts both off 16-byte alignment."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.where(torch.rand(q, n, generator=g, device=dev) < 0.3,
                    torch.rand(q, n, generator=g, device=dev) * 9,
                    torch.zeros((), device=dev))
    h = torch.where(torch.rand(q, n, generator=g, device=dev) < 0.2,
                    torch.rand(q, n, generator=g, device=dev) * 5,
                    torch.zeros((), device=dev))
    if offset:
        sb = torch.zeros(q * n + offset, dtype=dtype, device=dev)
        hb = torch.zeros(q * n + offset, device=dev)
        sb[offset:] = s.reshape(-1).to(dtype)
        hb[offset:] = h.reshape(-1)
        return sb[offset:].view(q, n), hb[offset:].view(q, n)
    return s.to(dtype), h


def _epilogue_bits_equal(scores, heavy, tile=2048, tiles=True):
    from nextsearch_tpu_torch.ops import score_kernels as se

    ref, got = scores.clone(), scores
    n0 = se.score_epilogue.launches
    found, tile_max = se.score_epilogue(got, heavy, tile=tile, tiles=tiles)
    assert se.score_epilogue.launches == n0 + 1
    rfound, rmax = se.score_epilogue_ref(ref, heavy, tile=tile, tiles=tiles)
    torch.cuda.synchronize()
    ib = torch.int16 if scores.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ib), ref.view(ib))
    assert found.dtype == torch.int32 and torch.equal(found, rfound)
    assert (tile_max is None) == (rmax is None)
    if rmax is not None:
        assert tile_max.dtype == scores.dtype
        assert torch.equal(tile_max.view(ib), rmax.view(ib))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("q,n,tile,offset", [
    (3, 777, 37, 0), (5, 2048 * 3, 2048, 0), (7, 5001, 2048, 0),
    (2, 96, 32, 0), (4, 4099, 2048, 1), (6, 6144, 2048, 3), (1, 9, 3, 0),
])
@pytest.mark.parametrize("with_heavy", [True, False])
def test_score_epilogue_small_shapes_bit_exact(cuda, dtype, q, n, tile, offset,
                                               with_heavy):
    """Odd N (scalar heads and tails), tiles that do and do not divide N,
    operands off 16-byte alignment (the all-scalar path), with and without
    H: scores' bits, found and tile_max equal to the plain version's."""
    s, h = _epilogue_operands(q, n, dtype, q * n + tile, cuda, offset)
    _epilogue_bits_equal(s, h if with_heavy else None, tile=tile)
    _epilogue_bits_equal(s, None, tile=tile, tiles=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_score_epilogue_at_the_1m_shape_bit_exact(cuda, dtype):
    """Q 512 x n_slots 1,001,472 (the bench fused index): the fused launch's
    form, then the found-only form of exact and fast mode."""
    s, h = _epilogue_operands(512, 1_001_472, dtype, 11, cuda)
    _epilogue_bits_equal(s, h)
    _epilogue_bits_equal(s, None, tiles=False)


@pytest.mark.cuda
def test_score_epilogue_rejects_what_the_kernel_does_not_take(cuda):
    from nextsearch_tpu_torch.ops import score_kernels as se

    s = torch.zeros((4, 64), device=cuda)
    h = torch.zeros((4, 64), device=cuda)
    n0 = se.score_epilogue.launches
    for bad_s, bad_h, err in (
            (s.half(), h, TypeError), (s.double(), None, TypeError),
            (s, h.to(torch.bfloat16), TypeError), (s, h[:, :32], TypeError),
            (torch.zeros((64, 4), device=cuda).T, None, ValueError),
            (s, torch.zeros((64, 4), device=cuda).T, ValueError),
            (s, h.cpu(), ValueError)):
        with pytest.raises(err):
            se.score_epilogue(bad_s, bad_h)
    assert se.score_epilogue.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kw", [("fused", {}), ("fused", {"scores_bf16": True}),
                                     ("exact", {}), ("fast", {})])
def test_every_launch_runs_score_epilogue_once(cuda, mode, kw):
    """Eagerly, each fused, exact and fast launch launches score_epilogue
    once, and the fused one K3 once beside it; the sharded fused step once
    per shard."""
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import score_kernels as se
    from nextsearch_tpu_torch.parallel.mesh import make_mesh
    from nextsearch_tpu_torch.parallel.sharded import ShardedIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode=mode, posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), **kw))
    ti = TorchIndex([seg], config=cfg, device=cuda)
    ti.launch_cache = eager_cache(cuda)
    for batch in sample_queries(probs, 3 * 64, 64, seed=3):
        n0, k0 = se.score_epilogue.launches, hk.gather_rows.launches
        ti.search_batch(batch, k=10)
        assert se.score_epilogue.launches == n0 + 1
        assert hk.gather_rows.launches == k0 + (mode == "fused")
    if mode != "fused" or kw:
        return
    seg1, _p = build_corpus(9000, 3000, seed=2)
    si = ShardedIndex([seg, seg1], make_mesh(1, 2, devices=[cuda] * 2),
                      config=cfg)
    si.launch_caches = {d: eager_cache(d) for d in si.launch_caches}
    n0 = se.score_epilogue.launches
    si.search_batch(batch, k=10)
    assert se.score_epilogue.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("scores_bf16", [False, True])
def test_graphed_fused_launch_replays_score_epilogue(cuda, scores_bf16):
    """The fused launch graphed against the same index run eagerly: bit
    for bit, and score_epilogue's counter advanced by one per replay."""
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.ops import score_kernels as se

    _seg, ti, batches = _graph_index(cuda, "fused", scores_bf16=scores_bf16)
    graphed, eager = ti.launch_cache, eager_cache(cuda)
    ti.warm_batch(batches[1], k=10)
    caps = graphed.captures
    for batch in batches[1:]:
        ti.launch_cache = eager
        want = ti.search_batch(batch, k=10)
        ti.launch_cache = graphed
        n0, r0 = se.score_epilogue.launches, graphed.replays
        _bits_equal(ti.search_batch(batch, k=10), want)
        assert graphed.replays == r0 + 1
        assert se.score_epilogue.launches == n0 + 1
    assert graphed.captures == caps == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "sparse"])
def test_device_idle_gaps_recorded_while_tracing(cuda, mode):
    """While the tracer records, each launch after the first gives a span
    device.idle of 0 ms or more under its batch id, ending where its start
    was enqueued; the host's sleep between launches shows as a gap. With
    the tracer off no launch is timed."""
    import time

    from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER

    _seg, ti, batches = _graph_index(cuda, mode)
    ti.warm_batch(batches[1], k=10)
    assert ti.search_batch_async(batches[1], k=10)[4].mark is None
    torch.cuda.synchronize()
    GLOBAL_TRACER.reset()
    GLOBAL_TRACER.start()
    try:
        bids = []
        for batch in batches[1:]:
            bids.append(GLOBAL_TRACER.new_batch())
            with GLOBAL_TRACER.batch(bids[-1]):
                ti.search_batch_gather(ti.search_batch_async(batch, k=10))
            time.sleep(0.005)
    finally:
        GLOBAL_TRACER.stop()
    gaps = [r for r in GLOBAL_TRACER.records() if r.name == "device.idle"]
    GLOBAL_TRACER.reset()
    assert [r.batch for r in gaps] == bids[1:]
    assert all(r.t1_ns >= r.t0_ns for r in gaps)
    assert max(r.t1_ns - r.t0_ns for r in gaps) > 1e6
