"""The port's CUDA kernels and sparse path on a card (skipped without one).

Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version: K2/K3 (f32 and
bf16 rows) and K4 bit for bit; K1 and K6 cnt bit for bit and H/smax within
1e-6 relative (the kernel's fp32 sums run in another order than cuBLAS's),
a bf16 H equal to the rounding of the kernel's own f32 H; K5 cnt bit for bit
and totals/smax within 2e-6 relative (the same product, plus entry sums in
the same order); P6 as K6, its reduced smax within 1e-6 relative; P1
within 2 * 512 * 2^-24 relative (two orders of a 512-term positive sum),
P3 within 1e-6 (a few entries per cell at most), P2, P4 and P5 bit for
bit. The whole TorchIndex on
the card, on the packed, unified and windowed-selection paths and with bf16
dense rows, is held against the same index on the CPU and against the
oracle.
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
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu.index.oracle import oracle_search
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


@pytest.mark.cuda
@pytest.mark.parametrize("q,k2,w_max", [
    (512, 32, 8192),     # serving-like
    (64, 32, 40000),     # windows past the TPU kernel's 32768 bound
    (100, 5, 3000),
    (7, 128, 300),       # k2 above the live count
])
def test_per_query_topk_matches_plain(cuda, q, k2, w_max):
    from nextsearch_tpu_torch.ops import select_kernels as sk

    scores, bounds = _windows(q, w_max, q + k2, cuda)
    n0 = sk.per_query_topk.launches
    v, g = sk.per_query_topk(scores, bounds, k2)
    assert sk.per_query_topk.launches == n0 + 1
    rv, rg = sk.per_query_topk_ref(scores, bounds, k2)
    torch.cuda.synchronize()
    assert torch.equal(v, rv) and torch.equal(g, rg)
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
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu.index.oracle import oracle_search
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
