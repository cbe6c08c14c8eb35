"""Heavy kernels of the torch port (nextsearch_tpu_torch/ops/heavy_kernels.py)
against the JAX package's Pallas kernels (interpret mode) and XLA references.

On the CPU every wrapper runs its plain PyTorch version; the CUDA kernels
themselves are compared with those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.ops.heavy_pallas import (
    heavy_fused3_pallas,
    heavy_fused3_xla,
)
from nextsearch_tpu_torch.ops import cuda_build
from nextsearch_tpu_torch.ops import heavy_kernels as hk

torch.set_num_threads(1)

N_SLOTS = 4096  # two 2048-doc tiles -> tiles_pad 8, 128 smax rows
ND = 24
Q = 8


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def operands():
    """Sparse non-negative mix (a few heavy terms per query) and a dense
    table whose rows are mostly zero, like eager-score rows; the last
    sub-blocks stay all-zero so smax/cnt see empty tiles too."""
    r = np.random.default_rng(7)
    table = np.where(
        r.random((ND, N_SLOTS)) < 0.3,
        r.uniform(0.05, 6.0, (ND, N_SLOTS)), 0.0,
    ).astype(np.float32)
    table[:, 3000:] = 0.0
    table[ND - 1] = 0.0  # the zero sentinel row
    mix = np.zeros((Q, ND), np.float32)
    for q in range(Q):
        for c in r.integers(0, ND - 1, size=3):
            mix[q, c] = r.uniform(0.2, 1.5)
    mix[Q - 1] = 0.0  # an empty query row
    return mix, table


def _jax_fused3(mix, table, *, fast, interpret):
    dense3 = jnp.asarray(table).reshape(ND, N_SLOTS // 128, 128)
    if interpret:
        h, smax, cnt = heavy_fused3_pallas(
            jnp.asarray(mix), dense3, fast=fast, interpret=True
        )
    else:
        h, smax, cnt = heavy_fused3_xla(jnp.asarray(mix), dense3, fast=fast)
    return (np.asarray(h).reshape(Q, N_SLOTS), np.asarray(smax),
            np.asarray(cnt))


def _assert_close(port, ref):
    h, smax, cnt = (t.numpy() for t in port)
    h_r, smax_r, cnt_r = ref
    assert h.shape == h_r.shape and smax.shape == smax_r.shape
    np.testing.assert_allclose(h, h_r, rtol=3e-7, atol=0)
    fin = np.isfinite(smax_r)
    assert np.array_equal(np.isfinite(smax), fin)
    assert np.all(smax[~fin] == -np.inf)
    np.testing.assert_allclose(smax[fin], smax_r[fin], rtol=3e-7, atol=0)
    assert np.array_equal(cnt, cnt_r)


@pytest.mark.parametrize("interpret", [True, False])
def test_heavy_fused3_exact_matches_jax(operands, interpret):
    """Exact mode: H and smax within 3e-7 relative (the CPU dot libraries
    may order the f32 sum differently), cnt and the padding exact."""
    mix, table = operands
    port = hk.heavy_fused3(torch.from_numpy(mix), torch.from_numpy(table),
                           fast=False)
    _assert_close(port, _jax_fused3(mix, table, fast=False,
                                    interpret=interpret))
    assert port[1].shape == (8 * 16, Q) and port[2].shape == (8, Q)


@pytest.mark.parametrize("bf16_table", [False, True])
@pytest.mark.parametrize("interpret", [True, False])
def test_heavy_fused3_fast_matches_jax_on_rounded_inputs(
    operands, interpret, bf16_table
):
    """Fast mode rounds both operands to bf16. JAX's CPU fast path does
    not round, so it is fed bf16-pre-rounded f32 inputs; the port gets the
    same values as an f32 table or as the bf16 table K2 produces."""
    mix, table = operands
    mix_r, table_r = _bf16_round(mix), _bf16_round(table)
    t = torch.from_numpy(table_r)
    if bf16_table:
        t = t.to(torch.bfloat16)
    port = hk.heavy_fused3(torch.from_numpy(mix), t, fast=True)
    _assert_close(port, _jax_fused3(mix_r, table_r, fast=True,
                                    interpret=interpret))


def test_heavy_fused3_smax_is_max_of_own_h(operands):
    mix, table = operands
    h, smax, cnt = hk.heavy_fused3(
        torch.from_numpy(mix), torch.from_numpy(table), fast=False
    )
    n_sub = N_SLOTS // 128
    assert torch.equal(smax[:n_sub], h.view(Q, n_sub, 128).amax(2).T)
    assert torch.equal(cnt[:2], (h.view(Q, 2, 2048) > 0).sum(2).T.float())
    assert torch.all(cnt[2:] == 0)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_rows_bit_exact(operands, bf16):
    """K3 (f32) and K2 (bf16, round-to-nearest-even) against dense[ids]
    and .astype(jnp.bfloat16), compared bit for bit."""
    _mix, table = operands
    ids = np.array([3, 0, 23, 3, 17, 5, 23, 23], np.int32)
    ref = jnp.asarray(table)[jnp.asarray(ids)]
    if bf16:
        got = hk.gather_rows_bf16(torch.from_numpy(ids), torch.from_numpy(table))
        assert got.dtype == torch.bfloat16
        ref_bits = np.asarray(ref.astype(jnp.bfloat16)).view(np.uint16)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              ref_bits)
    else:
        got = hk.gather_rows(torch.from_numpy(ids), torch.from_numpy(table))
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(ref).view(np.uint32))


def test_cpu_wrappers_run_plain_versions(operands):
    """CPU tensors go to the plain versions: same results, no kernel
    build, no launch counted, and nothing imports nvcc or triton."""
    mix, table = operands
    hk.reset_launch_counts()
    m, t = torch.from_numpy(mix), torch.from_numpy(table)
    ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    for a, b in zip(hk.heavy_fused3(m, t, fast=True),
                    hk.heavy_fused3_ref(m, t, fast=True)):
        assert torch.equal(a, b)
    assert torch.equal(hk.gather_rows(ids, t), hk.gather_rows_ref(ids, t))
    assert torch.equal(hk.gather_rows_bf16(ids, t),
                       hk.gather_rows_bf16_ref(ids, t))
    assert (hk.heavy_fused3.launches, hk.gather_rows.launches,
            hk.gather_rows_bf16.launches) == (0, 0, 0)
    assert cuda_build._lib is None
    assert "triton" not in sys.modules


def test_wrappers_reject_bad_arguments(operands):
    mix, table = operands
    m, t = torch.from_numpy(mix), torch.from_numpy(table)
    with pytest.raises(ValueError):
        hk.heavy_fused3(m[:, :5], t, fast=False)  # ND mismatch
    with pytest.raises(TypeError):
        hk.heavy_fused3(m.double(), t, fast=False)
    with pytest.raises(ValueError):
        hk.heavy_fused3(m, t[:, :1000].contiguous(), fast=False)  # not % 2048
    with pytest.raises(ValueError):
        hk.heavy_fused3(m, t.T.contiguous().T, fast=False)  # not contiguous
    with pytest.raises(TypeError):
        hk.gather_rows(torch.tensor([0.5]), t)
    with pytest.raises(TypeError):
        hk.gather_rows_bf16(torch.tensor([0]), t.to(torch.bfloat16))
