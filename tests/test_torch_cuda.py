"""The port's CUDA kernels and sparse path on a card (skipped without one).

Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version: K2/K3 and K4 bit
for bit; K1 cnt bit for bit and H/smax within 1e-6 relative (the kernel's
fp32 sums run in another order than cuBLAS's); K5 cnt bit for bit and
totals/smax within 2e-6 relative (the same product, plus entry sums in the
same order). The whole TorchIndex on the card, on the packed, unified and
windowed-selection paths, is held against the same index on the CPU and
against the oracle.
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
