"""Heavy-term kernels of the sparse path: K1 and K6 (fused matmul +
selection epilogue), K5 (the same with the light entries folded into the
product), K2/K3 (row gathers) and the attribution variants of the product
(P6), as hand-written CUDA for Hopper, and mix_lists, the pre-pass that the
K1/K5/K6/P6 wrappers launch: each query's nonzero mix entries, over which
the product gathers table rows instead of running a dense product over a
mostly-zero mix, and the mix rounded to bf16 for the 64-query blocks that do
take the dense product, which runs on the tensor cores when both operands
are bf16 values.

Each public wrapper checks its arguments, runs the plain PyTorch version
when the tensors lie on the CPU (the CPU tests), and launches its CUDA
kernel when they lie on a CUDA device, raising if the launch fails. There is
no switch that routes a CUDA tensor to the plain version. Each wrapper
counts its own kernel launches in ``<wrapper>.launches``.

The kernels live in ``nextsearch_tpu_torch/csrc/heavy.cu``, built at first
use by ops/cuda_build.py.

Layouts: the dense table is ``[rows, n_slots]`` and H is ``[Q, n_slots]``
(the JAX package's 3D ``[.., n_slots/128, 128]`` layouts are free views of
these). smax ``[tiles_pad * 16, Q]`` and cnt ``[tiles_pad, Q]`` keep the JAX
layouts, with tiles_pad = round_up(n_slots / 2048, 8).
"""

from __future__ import annotations

import torch

from .cuda_build import check_aligned, check_rc, counted, library, stream

TILE = 2048  # docs per count tile (cnt rows)
CSUB = 128  # docs per selection sub-block (smax rows)
_CPT = TILE // CSUB
GATHER_CUT = 32  # csrc/heavy.cu's GATHER_CUT: the longest list gathered over
MIX_PAD = 32  # csrc/heavy.cu's TC_BK: the bf16 mix's columns pad to this


def _pads(n_slots: int):
    n_tiles = n_slots // TILE
    tiles_pad = ((n_tiles + 7) // 8) * 8
    return n_tiles, tiles_pad, tiles_pad * _CPT


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


# ---------------------------------------------------------------- mix lists


def _list_capacity(nd: int, cap=None) -> int:
    return min(nd, GATHER_CUT) if cap is None else cap


def mix_lists_ref(mix: torch.Tensor, round_bf16: bool, cap=None):
    """Plain PyTorch version of mix_lists."""
    q, nd = mix.shape
    width = _list_capacity(nd, cap)
    v = mix.to(torch.bfloat16).float() if round_bf16 else mix
    nz = v != 0
    count = nz.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(nz.to(torch.int32), dim=1) - 1
    r, c = torch.nonzero(nz & (pos < width), as_tuple=True)
    cols = torch.zeros((q, width), dtype=torch.int32, device=mix.device)
    vals = torch.zeros((q, width), dtype=torch.float32, device=mix.device)
    cols[r, pos[r, c]] = c.to(torch.int32)
    vals[r, pos[r, c]] = v[r, c]
    return count, cols, vals


def mix_bf16_padded_ref(mix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pre-pass's bf16 rows: mix rounded to bf16
    (round-to-nearest-even), its columns zero-padded to a multiple of
    MIX_PAD. The tensor-core kernel's A operand; padding columns multiply
    table rows that the kernel zero-fills, so the product is the unpadded
    one."""
    nd = mix.shape[1]
    return torch.nn.functional.pad(mix.to(torch.bfloat16),
                                   (0, -nd % MIX_PAD))


def mix_lists(mix: torch.Tensor, round_bf16: bool, cap=None, *,
              with_bf16: bool = False):
    """Each mix row's nonzero entries, in ascending column order.

    The pre-pass of the heavy product (K1, K5, K6, P6), whose wrappers launch
    it; it has no TPU counterpart. mix f32 [Q, ND]; round_bf16 rounds the
    values to bf16 first (round-to-nearest-even), where the product rounds
    mix (fast mode, or a bf16 table). Returns (count int32 [Q], the row's
    whole nonzero count; cols int32 [Q, L] and vals f32 [Q, L], its first L
    nonzero columns and values, zero past the count). L = min(ND,
    GATHER_CUT), or cap. A row with count > L makes the product take its
    dense kernel for that row's 64-query block. with_bf16 (only with
    round_bf16) adds a fourth result from the same launch: the rounded mix
    as bf16 [Q, round_up(ND, MIX_PAD)], zero-padded (mix_bf16_padded_ref).
    """
    if mix.dim() != 2 or mix.dtype != torch.float32:
        raise TypeError("mix_lists: mix must be 2D float32")
    if not mix.is_contiguous():
        raise ValueError("mix_lists: mix must be contiguous")
    if not 0 <= _list_capacity(mix.shape[1], cap) <= GATHER_CUT:
        raise ValueError(f"mix_lists: capacity {cap} outside [0, {GATHER_CUT}]")
    if with_bf16 and not round_bf16:
        raise ValueError("mix_lists: with_bf16 needs round_bf16")
    if mix.device.type == "cpu":
        lists = mix_lists_ref(mix, round_bf16, cap)
        return (*lists, mix_bf16_padded_ref(mix)) if with_bf16 else lists
    if mix.device.type != "cuda":
        raise ValueError(f"mix_lists: unsupported device {mix.device}")
    q, nd = mix.shape
    width = _list_capacity(nd, cap)
    dev = mix.device
    count = torch.empty((q,), dtype=torch.int32, device=dev)
    cols = torch.empty((q, width), dtype=torch.int32, device=dev)
    vals = torch.empty((q, width), dtype=torch.float32, device=dev)
    nd_pad = nd + -nd % MIX_PAD
    mixb = (torch.empty((q, nd_pad), dtype=torch.bfloat16, device=dev)
            if with_bf16 else None)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ns_mix_lists(mix.data_ptr(), int(bool(round_bf16)), q, nd,
                              width, count.data_ptr(), cols.data_ptr(),
                              vals.data_ptr(),
                              mixb.data_ptr() if with_bf16 else None,
                              nd_pad if with_bf16 else 0, stream(dev))
    check_rc(rc, "mix_lists")
    mix_lists.launches += 1
    return (count, cols, vals, mixb) if with_bf16 else (count, cols, vals)


def _lists_args(mix, round_bf16: bool, list_cap):
    """ctypes arguments (count, cols, vals, L, bf16 mix, its columns) of a
    product launch, and the tensors, which the caller keeps alive until the
    launch is queued. The bf16 mix goes with every launch that rounds mix
    (null and 0 otherwise).

    Every product wrapper takes list_cap for the card tests and the probes,
    which compare and time its paths on the same operands: the lists'
    capacity (None takes min(ND, GATHER_CUT); 0 sends every block with a
    nonzero mix entry down the dense product)."""
    lists = mix_lists(mix, round_bf16, list_cap, with_bf16=round_bf16)
    mixb = lists[3] if round_bf16 else None
    return (lists[0].data_ptr(), lists[1].data_ptr(), lists[2].data_ptr(),
            lists[1].shape[1], mixb.data_ptr() if round_bf16 else None,
            mixb.shape[1] if round_bf16 else 0), lists


# ---------------------------------------------------------------- K1


def _product_ref(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """mix @ table as K1 computes it. fast rounds both operands to bf16
    (round-to-nearest-even) first, as the TPU's one-pass DEFAULT dot does;
    a bf16 table in exact mode rounds mix to bf16, as the JAX callers cast
    mix.astype(table.dtype) before the dot. A bf16 x bf16 product is exact
    in f32, so only the sums round. TF32 is off
    (torch.backends.cuda.matmul.allow_tf32 = False) so exact mode is a true
    fp32 product on a card as well."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if fast or table.dtype == torch.bfloat16:
        mix = mix.to(torch.bfloat16).float()
    if fast:
        table = table.to(torch.bfloat16)
    return mix @ table.float()


def round_up_bf16(h: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 rounded toward +inf for non-negative values, by the JAX
    package's _round_up_store bit rule: (bits + 0xFFFF) >> 16 in uint32
    arithmetic. A stored value is then an upper bound on its f32 value, and
    zero stays zero."""
    bits = h.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    up = ((bits + 0xFFFF) & 0xFFFFFFFF) >> 16
    return torch.where(up >= 1 << 15, up - (1 << 16), up).to(
        torch.int16).view(torch.bfloat16)


def _store_ref(h32: torch.Tensor, h_dtype, *, up: bool) -> torch.Tensor:
    if h_dtype == torch.float32:
        return h32
    return round_up_bf16(h32) if up else h32.to(torch.bfloat16)


def _check_h_dtype(name: str, h_dtype) -> None:
    if h_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: h_dtype must be float32 or bfloat16")


def _tile_stats_ref(h: torch.Tensor):
    """K1's epilogue: per-sub-block max (-inf padded) and per-tile count of
    h > 0 (zero padded), in the JAX layouts."""
    q, n_slots = h.shape
    n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    n_sub = n_slots // CSUB
    smax = torch.full(
        (sub_pad, q), float("-inf"), dtype=torch.float32, device=h.device
    )
    smax[:n_sub] = h.view(q, n_sub, CSUB).amax(dim=2).T
    cnt = torch.zeros((tiles_pad, q), dtype=torch.float32, device=h.device)
    cnt[:n_tiles] = (h.view(q, n_tiles, TILE) > 0).sum(dim=2).T.float()
    return smax, cnt


def heavy_fused3_ref(mix: torch.Tensor, table: torch.Tensor, *, fast: bool,
                     h_dtype=torch.float32):
    """Plain PyTorch version of heavy_fused3 (the JAX heavy_fused3_xla):
    smax and cnt from the f32 product, H stored in h_dtype (bf16 rounded
    up)."""
    h = _product_ref(mix, table, fast=fast)
    return (_store_ref(h, h_dtype, up=True), *_tile_stats_ref(h))


def _check_heavy_operands(name: str, mix: torch.Tensor, table: torch.Tensor):
    if mix.dim() != 2 or table.dim() != 2:
        raise ValueError(f"{name}: mix and table must be 2D")
    if mix.dtype != torch.float32:
        raise TypeError(f"{name}: mix must be float32, got {mix.dtype}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: table dtype {table.dtype}")
    q, nd = mix.shape
    if table.shape[0] != nd:
        raise ValueError(f"{name}: mix {tuple(mix.shape)} vs table "
                         f"{tuple(table.shape)}")
    n_slots = table.shape[1]
    if n_slots % TILE or q == 0 or nd == 0:
        raise ValueError(f"{name}: bad shapes Q={q} ND={nd} "
                         f"n_slots={n_slots}")
    if mix.device != table.device:
        raise ValueError(f"{name}: mix and table on different devices")
    if not (mix.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")


def _heavy_outputs(q: int, n_slots: int, dev, h_dtype=torch.float32):
    """H/totals, smax pre-filled with -inf and cnt with 0 (the kernels
    write only the real sub-blocks and tiles)."""
    _n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    return (
        torch.empty((q, n_slots), dtype=h_dtype, device=dev),
        torch.full((sub_pad, q), float("-inf"), dtype=torch.float32, device=dev),
        torch.zeros((tiles_pad, q), dtype=torch.float32, device=dev),
    )


def _rounds_mix(table, fast: bool) -> bool:
    """Whether the product rounds mix to bf16: fast mode, or a bf16 table."""
    return bool(fast) or table.dtype == torch.bfloat16


def _launch_fused(fn, name, mix, table, fast, h_dtype, list_cap):
    """One ns_heavy_fused3 launch (K1 or K6) after its mix_lists pre-pass,
    counted on fn."""
    _check_heavy_operands(name, mix, table)
    _check_h_dtype(name, h_dtype)
    if table.device.type == "cpu":
        return heavy_fused3_ref(mix, table, fast=fast, h_dtype=h_dtype)
    check_aligned(mix, table)
    lib = library()
    dev = table.device
    (q, nd), n_slots = mix.shape, table.shape[1]
    largs, _lists = _lists_args(mix, _rounds_mix(table, fast), list_cap)
    h, smax, cnt = _heavy_outputs(q, n_slots, dev, h_dtype)
    with torch.cuda.device(dev):
        rc = lib.ns_heavy_fused3(
            mix.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), int(bool(fast)),
            int(h_dtype == torch.bfloat16), *largs,
            h.data_ptr(), smax.data_ptr(), cnt.data_ptr(),
            q, nd, n_slots, stream(dev),
        )
    check_rc(rc, name)
    fn.launches += 1
    return h, smax, cnt


def heavy_fused3(mix: torch.Tensor, table: torch.Tensor, *, fast: bool,
                 h_dtype=torch.float32, list_cap=None):
    """H = mix @ table, per-128-doc sub-block max and per-tile count of H > 0.

    Replaces nextsearch_tpu/ops/heavy_pallas.py heavy_fused3_pallas (K1).
    mix f32 [Q, ND]; table f32 or bf16 [ND, n_slots], n_slots % 2048 == 0.
    Returns (H [Q, n_slots] in h_dtype, smax f32 [tiles_pad*16, Q] padded
    with -inf, cnt f32 [tiles_pad, Q] padded with 0). fast=True is the
    guarded one-pass mode (bf16 operands, f32 accumulation); fast=False is
    fp32, with mix rounded to bf16 over a bf16 table. h_dtype bf16 stores H
    rounded up (round_up_bf16); smax and cnt come from the f32 sums.

    On a card the launch is the pre-pass mix_lists (counted in its own
    mix_lists.launches), then the product, which gathers the table rows of
    each query's nonzero mix entries, or runs a dense product in a 64-query
    block holding a list longer than min(ND, GATHER_CUT). In f32-exact mode
    (fast=False over an f32 table) the dense product is an fp32 FFMA loop
    and both paths give the same bits. With bf16 operands (fast, or a bf16
    table) it runs on the tensor cores: the same exact bf16 x bf16 products
    summed in the tensor cores' order (one rounding per 16-term step), so
    its H and smax agree with the gather's and the plain version's within
    (ND / 8 + 8) * 2^-23 relative, while H > 0 and cnt are
    the same bit for bit (the operands are non-negative), smax is the max
    of the launch's own H and a bf16 H the rounding of its own f32 sums.
    K5, K6 and P6 launch it the same way. list_cap: _lists_args.
    """
    return _launch_fused(heavy_fused3, "heavy_fused3", mix, table, fast,
                         h_dtype, list_cap)


# ---------------------------------------------------------------- K6


def heavy_fused_ref(mix: torch.Tensor, dense: torch.Tensor, *, fast: bool,
                    h_dtype=torch.float32):
    """Plain PyTorch version of heavy_fused (the JAX heavy_fused_xla)."""
    return heavy_fused3_ref(mix, dense, fast=fast, h_dtype=h_dtype)


def heavy_fused(mix: torch.Tensor, dense: torch.Tensor, *, fast: bool = False,
                h_dtype=torch.float32, list_cap=None):
    """The 2D fused heavy kernel: heavy_fused3's function over a 2D table.

    Replaces nextsearch_tpu/ops/heavy_pallas.py heavy_fused_pallas (K6). On
    the TPU the 2D and 3D kernels differ only in how Mosaic tiles the table
    and H; on Hopper both layouts are the same row-major memory, so K6
    launches K1's CUDA kernel (``ns_heavy_fused3``) and is counted in its
    own ``heavy_fused.launches``. Same arguments and results as
    heavy_fused3: mix f32 [Q, ND], dense f32/bf16 [ND, n_slots], H in
    h_dtype (bf16 rounded up), smax [sub_pad, Q], cnt [tiles_pad, Q].
    """
    return _launch_fused(heavy_fused, "heavy_fused", mix, dense, fast,
                         h_dtype, list_cap)


# ---------------------------------------------------------------- P6

_EPI_FULL, _EPI_NONE, _EPI_REDUCED = 0, 1, 2


def heavy_fused_variant_ref(mix: torch.Tensor, dense: torch.Tensor, *,
                            epilogue: bool = True, store_h: bool = True,
                            smax_store: bool = True, h_dtype=torch.float32):
    """Plain PyTorch version of heavy_fused_variant."""
    h32 = _product_ref(mix, dense, fast=True)
    q, n_slots = h32.shape
    n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    if not epilogue:
        smax = torch.full((sub_pad, q), float("-inf"), dtype=torch.float32,
                          device=h32.device)
        cnt = torch.zeros((tiles_pad, q), dtype=torch.float32, device=h32.device)
    elif smax_store:
        smax, cnt = _tile_stats_ref(h32)
    else:
        _sm, ct = _tile_stats_ref(h32)
        tile_max = h32.view(q, n_tiles, TILE).amax(dim=(0, 2))
        v = tile_max + ct[:n_tiles].amin(dim=1)
        smax = torch.full((sub_pad, q), float("-inf"), dtype=torch.float32,
                          device=h32.device)
        smax[:n_tiles * _CPT] = v.repeat_interleave(_CPT)[:, None].expand(-1, q)
        cnt = torch.zeros_like(ct)
    h = h32 if store_h else torch.zeros_like(h32)
    return _store_ref(h, h_dtype, up=False), smax, cnt


def heavy_fused_variant(mix: torch.Tensor, dense: torch.Tensor, *,
                        epilogue: bool = True, store_h: bool = True,
                        smax_store: bool = True, h_dtype=torch.float32,
                        list_cap=None):
    """K6's one-pass (fast) launch with a part taken out, for timing.

    Replaces nextsearch_tpu's benchmarks/probe_fusedmm.py fused_variant
    (P6), each switch removing what it removes there: epilogue=False skips
    smax/cnt (smax stays -inf, cnt 0); smax_store=False keeps the
    epilogue's reductions but, in place of the per-query stores, writes
    each 2048-doc tile's max(H) + min over queries of its positive count
    into the tile's 16 smax rows and leaves cnt 0 (a tile-wide reduction
    that no 64 x 128 block owns: blocks write partial maxima and a second
    small kernel folds them); store_h=False writes zeros for H. h_dtype
    bf16 stores H rounded to nearest (astype), not up. Returns K6's
    layouts: (H [Q, n_slots], smax [sub_pad, Q], cnt [tiles_pad, Q]).
    """
    name = "heavy_fused_variant"
    _check_heavy_operands(name, mix, dense)
    _check_h_dtype(name, h_dtype)
    kw = dict(epilogue=epilogue, store_h=store_h, smax_store=smax_store,
              h_dtype=h_dtype)
    if dense.device.type == "cpu":
        return heavy_fused_variant_ref(mix, dense, **kw)
    check_aligned(mix, dense)
    lib = library()
    dev = dense.device
    (q, nd), n_slots = mix.shape, dense.shape[1]
    epi = (_EPI_NONE if not epilogue
           else _EPI_FULL if smax_store else _EPI_REDUCED)
    h, smax, cnt = _heavy_outputs(q, n_slots, dev, h_dtype)
    if epi == _EPI_REDUCED:
        cnt_s = torch.zeros_like(cnt)
        part = torch.empty(((n_slots // CSUB) * ((q + 63) // 64),),
                           dtype=torch.float32, device=dev)
    else:
        cnt_s = part = cnt
    largs, _lists = _lists_args(mix, True, list_cap)
    with torch.cuda.device(dev):
        rc = lib.ns_heavy_variant(
            mix.data_ptr(), dense.data_ptr(),
            int(dense.dtype == torch.bfloat16), int(h_dtype == torch.bfloat16),
            int(bool(store_h)), epi, *largs, h.data_ptr(), smax.data_ptr(),
            cnt.data_ptr(), cnt_s.data_ptr(), part.data_ptr(),
            q, nd, n_slots, stream(dev),
        )
    check_rc(rc, name)
    heavy_fused_variant.launches += 1
    return h, smax, cnt


# ---------------------------------------------------------------- K5


def _entry_runs(sd, sq, sv, n_slots: int):
    """Each (doc, q) run of a (doc, q)-sorted entry stream with its values
    summed in stream order (a left fold, as the kernel's run-start thread
    adds them); sentinel entries (doc >= n_slots) are dropped. Returns
    (doc, q, sum) per run."""
    live = sd < n_slots
    sd, sq, sv = sd[live], sq[live], sv[live]
    n = sd.numel()
    if n == 0:
        return sd, sq, sv
    change = (sd[1:] != sd[:-1]) | (sq[1:] != sq[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=sd.device)
    starts = torch.nonzero(torch.cat([one, change])).flatten()
    ends = torch.cat([starts[1:], torch.full((1,), n, device=sd.device)])
    total = sv[starts]
    for o in range(1, int((ends - starts).max())):
        idx = starts + o
        total = torch.where(idx < ends, total + sv[idx.clamp(max=n - 1)], total)
    return sd[starts], sq[starts], total


def unified_fused_ref(mix, table, sd, sq, sv, *, fast: bool):
    """Plain PyTorch version of unified_fused: H as heavy_fused3_ref
    computes it, each (q, doc) run's stream-order sum added once, then K1's
    epilogue of the totals."""
    totals = _product_ref(mix, table, fast=fast)
    d, q, run = _entry_runs(sd.long(), sq.long(), sv, table.shape[1])
    totals[q, d] = totals[q, d] + run  # runs are distinct cells
    return (totals, *_tile_stats_ref(totals))


def unified_fused(mix: torch.Tensor, table: torch.Tensor, sd: torch.Tensor,
                  sq: torch.Tensor, sv: torch.Tensor, *, fast: bool,
                  list_cap=None):
    """Unified totals: mix @ table plus every light entry, and K1's
    per-sub-block max and per-tile positive count of the sum.

    Replaces nextsearch_tpu/ops/heavy_pallas.py unified_fused_pallas (K5).
    mix f32 [Q, uc] and table f32/bf16 [uc, n_slots] as heavy_fused3 takes
    them (fast rounds both to bf16). The entries are the light
    contributions as streams sorted by (doc, q): sd int [N] doc slots
    (sentinel n_slots for dead lanes), sq int [N] query rows in [0, Q), sv
    f32 [N] values. Returns (totals f32 [Q, n_slots], smax, cnt) in
    heavy_fused3's layouts. The entry sums are exact f32 in both modes;
    entries of one (q, doc) are summed in stream order and added to the
    product once, so the result does not depend on the launch.
    """
    _check_heavy_operands("unified_fused", mix, table)
    if sd.dim() != 1 or sq.shape != sd.shape or sv.shape != sd.shape:
        raise ValueError("unified_fused: sd, sq and sv must be 1D of one length")
    if sv.dtype != torch.float32 or sd.dtype not in (torch.int32, torch.int64) \
            or sq.dtype not in (torch.int32, torch.int64):
        raise TypeError("unified_fused: int sd/sq and float32 sv required")
    if not (sd.device == sq.device == sv.device == table.device):
        raise ValueError("unified_fused: entries and table on different devices")
    if table.device.type == "cpu":
        return unified_fused_ref(mix, table, sd, sq, sv, fast=fast)
    check_aligned(mix, table)
    lib = library()
    dev = table.device
    (q, nd), n_slots = mix.shape, table.shape[1]
    sd32 = sd.to(torch.int32).contiguous()
    sq32 = sq.to(torch.int32).contiguous()
    sv = sv.contiguous()
    # entry offsets per 128-doc sub-block (the kernel's grid column)
    edges = torch.arange(0, n_slots + 1, CSUB, dtype=torch.int32, device=dev)
    eoff = torch.searchsorted(sd32, edges).to(torch.int32)
    largs, _lists = _lists_args(mix, _rounds_mix(table, fast), list_cap)
    totals, smax, cnt = _heavy_outputs(q, n_slots, dev)
    with torch.cuda.device(dev):
        rc = lib.ns_unified_fused(
            mix.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), int(bool(fast)), *largs,
            sd32.data_ptr(), sq32.data_ptr(), sv.data_ptr(), eoff.data_ptr(),
            totals.data_ptr(), smax.data_ptr(), cnt.data_ptr(),
            q, nd, n_slots, stream(dev),
        )
    check_rc(rc, "unified_fused")
    unified_fused.launches += 1
    return totals, smax, cnt


# ---------------------------------------------------------------- K2 / K3


def gather_rows_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows and gather_bf16_rows."""
    return table[ids]


def gather_rows_bf16_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows_bf16."""
    return table[ids].to(torch.bfloat16)


def _gather(ids, table, out_dtype, name, fn):
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: ids must be a 1D integer tensor")
    in_dtype = torch.bfloat16 if fn is gather_bf16_rows else torch.float32
    if table.dim() != 2 or table.dtype != in_dtype:
        raise TypeError(f"{name}: table must be 2D {in_dtype}")
    if ids.device != table.device:
        raise ValueError(f"{name}: ids and table on different devices")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if table.device.type == "cpu":
        ref = gather_rows_bf16_ref if fn is gather_rows_bf16 else gather_rows_ref
        return ref(ids, table)
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    n_rows, n_slots = table.shape
    if n_slots % 8 or ids.numel() == 0 or n_rows == 0:
        raise ValueError(f"{name}: bad shapes ids={ids.numel()} "
                         f"table={tuple(table.shape)}")
    check_aligned(table)
    lib = library()
    dev = table.device
    ids32 = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.numel(), n_slots), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ns_gather_rows(
            ids32.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), out.data_ptr(),
            int(out_dtype == torch.bfloat16), ids.numel(), n_rows, n_slots,
            stream(dev),
        )
    check_rc(rc, name)
    fn.launches += 1
    return out


def gather_rows(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] as f32 whole-row copies.

    Replaces nextsearch_tpu/ops/heavy_pallas.py gather_rows_pallas (K3).
    ids int [uc] (clipped to the table's rows by the caller, clamped again
    by the kernel); table f32 [rows, n_slots] -> f32 [uc, n_slots]. The
    compact table of the sparse mode's exact launch, and the row gather of
    the fused mode's heavy_scores (ops/bm25.py).
    """
    return _gather(ids, table, torch.float32, "gather_rows", gather_rows)


def gather_bf16_rows(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] of a bf16 table, kept bf16: K3 over the bf16 dense rows.

    Replaces gather_rows_pallas (K3) where the table is bf16
    (DeviceConfig.dense_rows_bf16): the compact table of every launch of
    that configuration. The same byte copy as gather_rows over rows of
    half the bytes, counted in gather_bf16_rows.launches.
    """
    return _gather(ids, table, torch.bfloat16, "gather_bf16_rows",
                   gather_bf16_rows)


def gather_rows_bf16(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] rounded to bf16 (round-to-nearest-even) in the same pass.

    Replaces nextsearch_tpu/ops/heavy_pallas.py gather_rows_bf16_pallas
    (K2): the compact table of the guarded fast launch.
    """
    return _gather(ids, table, torch.bfloat16, "gather_rows_bf16",
                   gather_rows_bf16)


_WRAPPERS = (heavy_fused3, heavy_fused, heavy_fused_variant, unified_fused,
             gather_rows, gather_rows_bf16, gather_bf16_rows, mix_lists)
counted(*_WRAPPERS)
