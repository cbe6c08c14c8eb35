"""K6 (nextsearch_tpu_torch/ops/heavy_kernels.heavy_fused, the 2D fused heavy
kernel) against the JAX package's heavy_fused_pallas (interpret mode) and
heavy_fused_xla, and the mix rounding of K1 and K5 over a bf16 table.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: H and smax within rtol 3e-7 (the CPU dot libraries may order
an f32 sum differently); cnt exact. A bf16 H equals the round-up (or, for
P6, the round-to-nearest) of the port's own f32 H bit for bit, and the
JAX bf16 H within one bf16 step (rtol 2^-7) where the two f32 sums straddle
a bf16 boundary; where the f32 sums agree bit for bit, so do the bf16 H.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.ops import bm25_sparse as jsp
from nextsearch_tpu.ops.heavy_pallas import (
    heavy_fused3_xla,
    heavy_fused_pallas,
    heavy_fused_xla,
)
from nextsearch_tpu_torch.ops import bm25_sparse as tsp
from nextsearch_tpu_torch.ops import heavy_kernels as hk
from test_torch_unified import _entries, _jax_unified, _operands

torch.set_num_threads(1)

N_SLOTS = 4096  # two 2048-doc tiles -> tiles_pad 8, 128 smax rows
ND = 24
Q = 8
RTOL = 3e-7


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def operands():
    """Sparse non-negative mix with weights that bf16 does not hold
    exactly, and a mostly-zero table; the last sub-blocks stay empty."""
    r = np.random.default_rng(17)
    table = np.where(
        r.random((ND, N_SLOTS)) < 0.3, r.uniform(0.05, 6.0, (ND, N_SLOTS)), 0.0,
    ).astype(np.float32)
    table[:, 3000:] = 0.0
    table[ND - 1] = 0.0
    mix = np.zeros((Q, ND), np.float32)
    for q in range(Q - 1):
        cols = r.choice(ND - 1, size=3, replace=False)
        mix[q, cols] = r.uniform(0.2, 1.5, size=3)
    return mix, table


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype != np.float32 else x


def _check_stats(port, ref):
    smax, cnt = _np(port[1]), _np(port[2])
    smax_r, cnt_r = _np(ref[1]), _np(ref[2])
    assert smax.shape == smax_r.shape and cnt.shape == cnt_r.shape
    fin = np.isfinite(smax_r)
    assert np.array_equal(np.isfinite(smax), fin)
    np.testing.assert_allclose(smax[fin], smax_r[fin], rtol=RTOL, atol=0)
    assert np.array_equal(cnt, cnt_r)


def _check_h(port_h, ref_h, port_h32=None, ref_h32=None):
    if port_h.dtype == torch.float32:
        np.testing.assert_allclose(port_h.numpy(), np.asarray(ref_h),
                                   rtol=RTOL, atol=0)
        return
    got, exp = _np(port_h), _np(ref_h)
    np.testing.assert_allclose(got, exp, rtol=2.0 ** -7, atol=0)
    same = port_h32.numpy().view(np.uint32) == np.asarray(ref_h32).view(np.uint32)
    assert same.mean() > 0.9
    assert np.array_equal(got[same], exp[same])


def test_k1_exact_over_bf16_table_rounds_mix(operands):
    """The fault: with a bf16 table in exact mode the reference casts mix
    to bf16 before the product (heavy_pallas.py:774); K1's plain version
    does too and equals heavy_fused3_xla."""
    mix, table = operands
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    port = hk.heavy_fused3(torch.from_numpy(mix), t16, fast=False)
    dense3 = jnp.asarray(table).astype(jnp.bfloat16).reshape(ND, -1, 128)
    h3, smax, cnt = heavy_fused3_xla(jnp.asarray(mix), dense3, fast=False)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(h3).reshape(Q, -1),
                               rtol=RTOL, atol=0)
    _check_stats(port, (None, smax, cnt))
    # the unrounded product is off by the mix's bf16 rounding (~2^-9)
    plain = torch.from_numpy(mix) @ t16.float()
    assert float((plain - port[0]).abs().max()) > 1e-4


def test_k5_exact_over_bf16_table_rounds_mix():
    """The fault in K5: unified_fused over a bf16 table in exact mode
    equals unified_fused_xla fed mix.astype(bf16), as the reference's
    unified path casts it (bm25_sparse.py:921)."""
    r = np.random.default_rng(70)
    n_slots = 2 * 2048
    mix, dense = _operands(r, Q, 16, n_slots, 2)
    sd, sq, sv = _entries(r, Q, n_slots, unique=True)
    dense_b = _bf16(dense)
    tot, smax, cnt = hk.unified_fused(
        torch.from_numpy(mix), torch.from_numpy(dense_b).to(torch.bfloat16),
        torch.from_numpy(sd), torch.from_numpy(sq), torch.from_numpy(sv),
        fast=False)
    mix_b = np.asarray(jnp.asarray(mix).astype(jnp.bfloat16).astype(jnp.float32))
    rt, rs, rc = _jax_unified(mix_b, dense_b, sd, sq, sv, n_slots,
                              interpret=False)
    np.testing.assert_allclose(tot.numpy(), rt, rtol=2e-6, atol=0)
    _check_stats((tot, smax, cnt), (rt, rs, rc))


def test_unified_impl_over_bf16_rows_matches_reference():
    """unified_impl over bf16 dense rows (compact bf16 table, mix rounded
    to bf16, v2 rescore over the bucket tables) bit-identical to
    bm25_search_sparse_unified(use_pallas=False) on a bf16-rows index."""
    from test_torch_bf16rows import bf16_index, run_unified

    di = bf16_index()
    got, ref = run_unified(di, seed=35)
    assert (ref[:, 2 * 10] > 0).sum() > 15
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def _jax_k6(mix, table, *, fast, h_dtype, interpret, bf16_table):
    dense = jnp.asarray(table)
    if bf16_table:
        dense = dense.astype(jnp.bfloat16)
    jd = jnp.bfloat16 if h_dtype == torch.bfloat16 else jnp.float32
    if interpret:
        return heavy_fused_pallas(jnp.asarray(mix), dense, fast=fast,
                                  interpret=True, h_dtype=jd)
    return heavy_fused_xla(jnp.asarray(mix), dense, fast=fast, h_dtype=jd)


@pytest.mark.parametrize("h_bf16", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("bf16_table", [False, True])
@pytest.mark.parametrize("interpret", [True, False])
def test_heavy_fused_matches_jax(operands, interpret, bf16_table, fast, h_bf16):
    """K6 over f32/bf16 tables, exact/fast, f32/bf16 H. The JAX CPU dot
    does not round f32 operands in fast mode, so a fast f32-table case
    feeds both bf16-exact inputs; a bf16 table rounds mix on both sides."""
    mix, table = operands
    if fast and not bf16_table:
        mix, table = _bf16(mix), _bf16(table)
    h_dtype = torch.bfloat16 if h_bf16 else torch.float32
    t = torch.from_numpy(table)
    if bf16_table:
        t = t.to(torch.bfloat16)
    m = torch.from_numpy(mix)
    port = hk.heavy_fused(m, t, fast=fast, h_dtype=h_dtype)
    ref = _jax_k6(mix, table, fast=fast, h_dtype=h_dtype,
                  interpret=interpret, bf16_table=bf16_table)
    assert port[0].dtype == h_dtype and port[0].shape == (Q, N_SLOTS)
    port32 = hk.heavy_fused(m, t, fast=fast)[0]
    ref32 = _jax_k6(mix, table, fast=fast, h_dtype=torch.float32,
                    interpret=interpret, bf16_table=bf16_table)[0]
    _check_h(port[0], ref[0], port32, ref32)
    _check_stats(port, ref)
    if h_bf16:
        assert torch.equal(port[0].view(torch.int16),
                           hk.round_up_bf16(port32).view(torch.int16))


def test_round_up_bf16_bit_rule():
    """(bits + 0xFFFF) >> 16: exact bf16 values and zero stay, others go up
    to the next bf16, a carry rolls into the exponent, and the result is
    the JAX _round_up_store's bit for bit."""
    from nextsearch_tpu.ops.heavy_pallas import _round_up_store

    vals = np.array([0.0, 1.0, 1.0 + 2.0 ** -20, 1.5, 3.99999, 2.0 ** -130,
                     255.9, 6.1e-5, 3.4e38], np.float32)
    r = np.random.default_rng(3)
    vals = np.concatenate([vals, r.uniform(0, 50, 500).astype(np.float32)])
    got = hk.round_up_bf16(torch.from_numpy(vals))
    ref = np.asarray(_round_up_store(jnp.asarray(vals), jnp.bfloat16))
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          ref.view(np.uint16))
    up = got.float().numpy()
    assert np.all(up >= vals) and up[0] == 0.0 and up[1] == 1.0
    assert up[2] == np.float32(1.0 + 2.0 ** -7)


def test_heavy_candidates_on_bf16_h(operands):
    """heavy_candidates reads a bf16 H (h_bf16): the same candidates and
    f32 values as the reference's bf16 branch (pair-word unpacking)."""
    mix, table = operands
    h, smax, _cnt = hk.heavy_fused(torch.from_numpy(mix),
                                   torch.from_numpy(table), fast=False,
                                   h_dtype=torch.bfloat16)
    h3 = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16).reshape(Q, -1, 128)
    for k2 in (4, 32):
        rv, rd = jsp.heavy_candidates(h3, jnp.asarray(smax.numpy()), k2, Q,
                                      N_SLOTS)
        gv, gd = tsp.heavy_candidates(h, smax, k2, Q, N_SLOTS)
        assert gv.dtype == torch.float32
        assert np.array_equal(gd.numpy(), np.asarray(rd))
        assert np.array_equal(gv.numpy().view(np.uint32),
                              np.asarray(rv).view(np.uint32))


def test_k6_counts_its_own_launches_and_checks_arguments(operands):
    """K6 shares K1's kernel but not its counter; CPU tensors launch
    nothing."""
    mix, table = operands
    m, t = torch.from_numpy(mix), torch.from_numpy(table)
    hk.reset_launch_counts()
    for a, b in zip(hk.heavy_fused(m, t, fast=True, h_dtype=torch.bfloat16),
                    hk.heavy_fused_ref(m, t, fast=True, h_dtype=torch.bfloat16)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert hk.heavy_fused.launches == hk.heavy_fused3.launches == 0
    with pytest.raises(TypeError):
        hk.heavy_fused(m, t, h_dtype=torch.float16)
    with pytest.raises(ValueError):
        hk.heavy_fused(m[:, :5], t)
