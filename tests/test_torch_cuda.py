"""The port's CUDA kernels and sparse path on a card (skipped without one).

Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version: K2/K3 bit for bit;
K1 cnt bit for bit and H/smax within 1e-6 relative (the kernel's fp32 sums
run in another order than cuBLAS's). The whole TorchIndex on the card is
held against the same index on the CPU and against the oracle.
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
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu.index.oracle import oracle_search
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import build_corpus, sample_queries

    seg, probs = build_corpus(20000, 3000)
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, dense_df_ratio=1 / 256,
        heavy_buckets=(64,), fast_heavy=fast,
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
