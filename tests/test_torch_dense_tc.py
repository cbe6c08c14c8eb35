"""What the tensor-core dense kernel changes, as far as the CPU can show it.

The kernel sums the heavy product in another order than the FFMA loop and
the gather, so H's last bits differ between the paths of one launch. These
tests show that (i) no reported score, doc or `found` depends on those bits:
with the heavy product of packed_impl, unified_impl and the bf16-rows path
replaced by one that sums in another order (f64 sums rounded to f32, or the
contraction reversed), the results are bit-equal to the unpatched run and to
the JAX package's bm25_search_sparse_packed / _unified (use_pallas=False),
tolerance 0; (ii) the bf16 rounding and column padding of mix that the
pre-pass hands the kernel equal mix.to(bfloat16) and leave the product
unchanged at ragged Q and ND; (iii) the timing helpers divide a span of
`inner` calls by `inner`.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from nextsearch_tpu_torch.benchmarks import common
from nextsearch_tpu_torch.ops import heavy_kernels as hk
from test_torch_bf16rows import bf16_index, run_packed, run_unified
from test_torch_sparse_ops import K, _arrays, _queries, _run_both, _t
from test_torch_sparse_ops import di, segs  # noqa: F401 - fixtures
from test_torch_unified import _unified_both

torch.set_num_threads(1)

_product = hk._product_ref


def _reordered(order: str, seen: dict):
    """hk._product_ref with the sums taken in another order; seen["bits"]
    counts the elements of H whose bits that changed."""
    def product(mix, table, *, fast):
        ref = _product(mix, table, fast=fast)
        if fast or table.dtype == torch.bfloat16:
            mix = mix.to(torch.bfloat16).float()
        if fast:
            table = table.to(torch.bfloat16)
        if order == "f64":
            h = (mix.double() @ table.double()).float()
        else:
            h = mix.flip(1) @ table.float().flip(0)
        seen["bits"] += int((h != ref).sum())
        seen["calls"] += 1
        # a sum of non-negative terms is positive in any order
        assert torch.equal(h > 0, ref > 0)
        return h
    return product


def _bf16_exact(di):
    return _t(_arrays(di)["dense2"]).to(torch.bfloat16).float().numpy()


_BF16_WEIGHTS = dict(weights=[0.5, 0.75, 1.0, 1.25, 1.5], distinct=True)


def _packed(di, seed, *, use_compact, fast):
    kw = _BF16_WEIGHTS if fast else {}
    plan, U = di.plan_sparse(_queries(seed, **kw))
    return _run_both(di, plan, U, use_compact=use_compact, fast=fast,
                     dense2=_bf16_exact(di) if fast else None)


def _unified(di, seed, *, fast):
    kw = _BF16_WEIGHTS if fast else {}
    plan, U = di.plan_sparse(_queries(seed, **kw))
    return _unified_both(di, plan, U, fast=fast,
                         dense2=_bf16_exact(di) if fast else None)


def _bf16_packed(seed, *, use_compact):
    bi = bf16_index()
    plan, U = bi.plan_sparse(_queries(seed))
    return run_packed(bi, plan, U, use_compact=use_compact)


# path -> (runs the port and the JAX package on one plan, fast mode)
PATHS = {
    "packed exact compact": (lambda di: _packed(di, 21, use_compact=True, fast=False), False),
    "packed exact full table": (lambda di: _packed(di, 21, use_compact=False, fast=False), False),
    "packed fast": (lambda di: _packed(di, 22, use_compact=True, fast=True), True),
    "unified exact": (lambda di: _unified(di, 33, fast=False), False),
    "unified fast": (lambda di: _unified(di, 34, fast=True), True),
    "bf16 rows compact": (lambda di: _bf16_packed(41, use_compact=True), False),
    "bf16 rows full table": (lambda di: _bf16_packed(41, use_compact=False), False),
    "bf16 rows unified": (lambda di: run_unified(bf16_index(), 43), False),
}


@pytest.mark.parametrize("order", ["f64", "reversed"])
@pytest.mark.parametrize("path", list(PATHS))
def test_no_result_bit_comes_from_h(di, path, order, monkeypatch):  # noqa: F811
    """Scores, docs and found of a path whose heavy product sums in another
    order equal the unpatched run's and the JAX package's bit for bit. In
    fast mode a query whose guard trips is relaunched exactly by the caller,
    so the rows compared are those whose guard passes in both runs."""
    run, fast = PATHS[path]
    base, ref = run(di)
    seen = dict(bits=0, calls=0)
    monkeypatch.setattr(hk, "_product_ref", _reordered(order, seen))
    got, _ref = run(di)
    assert seen["calls"] == 1
    cols = 2 * K + 1
    rows = np.ones(len(base), bool)
    if fast:
        assert base.shape[1] == cols + 1
        rows = (base[:, -1] == 1.0) & (got[:, -1] == 1.0)
        assert rows.sum() > 10
    assert (base[:, 2 * K] > 0).sum() > 10  # most queries find documents
    for other in (base, ref):
        assert np.array_equal(got[rows, :cols].view(np.uint32),
                              other[rows, :cols].view(np.uint32))


def test_reordered_products_do_change_h(di):  # noqa: F811
    """The patched products are not the plain one in disguise: on the
    exact full-table launch's operands each changes some of H's bits."""
    from nextsearch_tpu_torch.ops.bm25_sparse import heavy_operands

    plan, U = di.plan_sparse(_queries(21))
    table = _t(_arrays(di)["dense2"])
    mix, _ids = heavy_operands(_t(plan), table.shape[0], nd=di.n_dense, U=U,
                               use_compact=False)
    changed = {}
    for order in ("f64", "reversed"):
        seen = dict(bits=0, calls=0)
        _reordered(order, seen)(mix, table, fast=False)
        changed[order] = seen["bits"]
    assert changed["f64"] > 0 or changed["reversed"] > 0, changed


# ------------------------------------------------ (ii) the kernel's A operand


@pytest.mark.parametrize("q,nd", [(37, 20), (200, 1877), (64, 384), (5, 32)])
def test_mix_bf16_padded_is_rounded_mix_with_zero_columns(q, nd):
    g = torch.Generator().manual_seed(q + nd)
    mix = torch.rand(q, nd, generator=g) * 3
    mix[torch.rand(q, nd, generator=g) < 0.5] = 0.0
    got = hk.mix_bf16_padded_ref(mix)
    assert got.dtype == torch.bfloat16 and got.shape[0] == q
    assert got.shape[1] % hk.MIX_PAD == 0 and 0 <= got.shape[1] - nd < hk.MIX_PAD
    assert torch.equal(got[:, :nd].view(torch.int16),
                       mix.to(torch.bfloat16).view(torch.int16))
    assert not bool(got[:, nd:].any())


@pytest.mark.parametrize("q,nd", [(37, 20), (200, 1877)])
def test_padded_product_is_the_unpadded_product(q, nd):
    """Padding columns of mix meet table rows that the kernel zero-fills:
    the product over the padded contraction, in blocks of MIX_PAD rows as
    the kernel takes them, is the unpadded one (integer-valued operands, so
    every sum is exact in any order)."""
    g = torch.Generator().manual_seed(nd)
    mix = torch.randint(0, 4, (q, nd), generator=g).float()
    table = torch.randint(0, 8, (nd, 256), generator=g).to(torch.bfloat16)
    a = hk.mix_bf16_padded_ref(mix).float()
    pad = a.shape[1] - nd
    b = torch.nn.functional.pad(table.float(), (0, 0, 0, pad))
    h = torch.zeros(q, 256)
    for k0 in range(0, a.shape[1], hk.MIX_PAD):
        h += a[:, k0:k0 + hk.MIX_PAD] @ b[k0:k0 + hk.MIX_PAD]
    assert torch.equal(h, _product(mix, table, fast=True))


@pytest.mark.parametrize("cap", [None, 0, 5])
def test_mix_lists_with_bf16_rows_on_cpu(cap):
    g = torch.Generator().manual_seed(3)
    mix = torch.rand(37, 20, generator=g)
    mix[mix < 0.6] = 0.0
    count, cols, vals, rows = hk.mix_lists(mix, True, cap, with_bf16=True)
    for a, b in zip((count, cols, vals), hk.mix_lists_ref(mix, True, cap)):
        assert torch.equal(a, b)
    assert torch.equal(rows.view(torch.int16),
                       hk.mix_bf16_padded_ref(mix).view(torch.int16))
    with pytest.raises(ValueError, match="with_bf16"):
        hk.mix_lists(mix, False, cap, with_bf16=True)


# ------------------------------------------------ (iii) the timing helpers


@pytest.mark.parametrize("change,rtol,ok", [
    (None, 0.0, True),          # the same outputs pass bit for bit
    ("h", 1e-6, True),          # H off by 2^-22 relative, inside the tolerance
    ("h", 0.0, False),          # and outside bit equality
    ("cnt", 1e-3, False),       # a count may never differ
    ("sign", 1e-3, False),      # nor H > 0
])
def test_chip_smoke_compare(change, rtol, ok):
    g = torch.Generator().manual_seed(1)
    mix = torch.rand(8, 16, generator=g)
    table = torch.rand(16, 2048, generator=g).to(torch.bfloat16)
    old = hk.heavy_fused_ref(mix, table, fast=True)
    new = [t.clone() for t in old]
    if change == "h":
        new[0][3, 5] *= 1 + 2.0 ** -22
    elif change == "cnt":
        new[2][0, 0] += 1
    elif change == "sign":
        new[0][3, 5] = 0.0
    if ok:
        assert chip_smoke.compare(new, old, rtol) <= rtol
    else:
        with pytest.raises(AssertionError):
            chip_smoke.compare(new, old, rtol)


class _Event:
    """torch.cuda.Event on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _sleeper(ms: float):
    calls = []

    def fn():
        calls.append(1)
        time.sleep(ms / 1e3)
    return fn, calls


@pytest.mark.parametrize("inner", [1, 4, 9])
def test_event_ms_divides_a_span_by_inner(inner, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    fn, calls = _sleeper(2.0)
    ms = common.event_ms(fn, 3, warm=2, inner=inner)
    assert len(calls) == 2 + 3 * inner
    assert 1.9 < ms < 6.0  # one call's time, whatever the span holds


@pytest.mark.parametrize("inner", [1, 5])
def test_chip_smoke_timed_divides_by_inner_on_the_cpu(inner):
    fn, calls = _sleeper(2.0)
    ms = chip_smoke.timed(fn, torch.device("cpu"), 2, inner)
    assert len(calls) == 1 + 2 * inner
    assert 1.9 < ms < 6.0


@pytest.mark.parametrize("once_ms,inner", [
    (10.7, 1), (2.0, 1), (1.0, 2), (0.5, 4), (0.03, 67), (0.004, 500),
    (1e-9, common.INNER_MAX),
])
def test_pick_inner_fills_the_span(once_ms, inner):
    assert common.pick_inner(once_ms) == inner
    assert common.pick_inner(once_ms) * once_ms >= min(
        common.SPAN_MS, common.INNER_MAX * once_ms) - 1e-9


def test_timed_small_uses_one_inner_for_every_row():
    """The kernel, its plain version, its library call and the raw launch
    are timed over the same number of calls per span, picked from the raw
    launch."""
    cpu = torch.device("cpu")
    fns = {name: _sleeper(ms) for name, ms in
           (("kern", 1.0), ("plain", 0.2), ("library", 0.2), ("raw", 0.2))}
    out = chip_smoke.timed_small(cpu, 2, *(fns[n][0] for n in
                                           ("kern", "plain", "library", "raw")))
    assert set(out) == {"ms", "plain_ms", "library_ms", "raw_ms", "inner"}
    assert out["inner"] > 1
    # 1 warm call and 2 spans each; the raw launch also picked the span
    for name in ("kern", "plain", "library"):
        assert len(fns[name][1]) == 1 + 2 * out["inner"]
    assert len(fns["raw"][1]) > 1 + 2 * out["inner"]
    assert out["ms"] > out["raw_ms"] > 0.19
    none = chip_smoke.timed_small(cpu, 1, fns["kern"][0], fns["plain"][0])
    assert none["library_ms"] is None and none["raw_ms"] is None
