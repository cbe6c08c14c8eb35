"""Heavy-term kernels of the sparse path: K1 (fused matmul + selection
epilogue), K5 (the same with the light entries folded into the product) and
K2/K3 (row gathers), as hand-written CUDA for Hopper.

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

from .cuda_build import check_aligned, check_rc, library, stream

TILE = 2048  # docs per count tile (cnt rows)
CSUB = 128  # docs per selection sub-block (smax rows)
_CPT = TILE // CSUB


def _pads(n_slots: int):
    n_tiles = n_slots // TILE
    tiles_pad = ((n_tiles + 7) // 8) * 8
    return n_tiles, tiles_pad, tiles_pad * _CPT


def reset_launch_counts() -> None:
    for fn in (heavy_fused3, unified_fused, gather_rows, gather_rows_bf16):
        fn.launches = 0


# ---------------------------------------------------------------- K1


def _product_ref(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """mix @ table as K1 computes it. fast rounds both operands to bf16
    (round-to-nearest-even) first, as the TPU's one-pass DEFAULT dot does;
    the product then runs in f32. TF32 is off
    (torch.backends.cuda.matmul.allow_tf32 = False) so exact mode is a true
    fp32 product on a card as well."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if fast:
        return mix.to(torch.bfloat16).float() @ table.to(torch.bfloat16).float()
    return mix @ table.float()


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


def heavy_fused3_ref(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """Plain PyTorch version of heavy_fused3 (the JAX heavy_fused3_xla)."""
    h = _product_ref(mix, table, fast=fast)
    return (h, *_tile_stats_ref(h))


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


def _heavy_outputs(q: int, n_slots: int, dev):
    """H/totals, smax pre-filled with -inf and cnt with 0 (the kernels
    write only the real sub-blocks and tiles)."""
    _n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    return (
        torch.empty((q, n_slots), dtype=torch.float32, device=dev),
        torch.full((sub_pad, q), float("-inf"), dtype=torch.float32, device=dev),
        torch.zeros((tiles_pad, q), dtype=torch.float32, device=dev),
    )


def heavy_fused3(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """H = mix @ table, per-128-doc sub-block max and per-tile count of H > 0.

    Replaces nextsearch_tpu/ops/heavy_pallas.py heavy_fused3_pallas (K1).
    mix f32 [Q, ND]; table f32 or bf16 [ND, n_slots], n_slots % 2048 == 0.
    Returns (H f32 [Q, n_slots], smax f32 [tiles_pad*16, Q] padded with
    -inf, cnt f32 [tiles_pad, Q] padded with 0). fast=True is the guarded
    one-pass mode (bf16 operands, f32 accumulation); fast=False is fp32.
    """
    _check_heavy_operands("heavy_fused3", mix, table)
    if table.device.type == "cpu":
        return heavy_fused3_ref(mix, table, fast=fast)
    check_aligned(mix, table)
    lib = library()
    dev = table.device
    (q, nd), n_slots = mix.shape, table.shape[1]
    h, smax, cnt = _heavy_outputs(q, n_slots, dev)
    with torch.cuda.device(dev):
        rc = lib.ns_heavy_fused3(
            mix.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), int(bool(fast)),
            h.data_ptr(), smax.data_ptr(), cnt.data_ptr(),
            q, nd, n_slots, stream(dev),
        )
    check_rc(rc, "heavy_fused3")
    heavy_fused3.launches += 1
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
                  sq: torch.Tensor, sv: torch.Tensor, *, fast: bool):
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
    totals, smax, cnt = _heavy_outputs(q, n_slots, dev)
    with torch.cuda.device(dev):
        rc = lib.ns_unified_fused(
            mix.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), int(bool(fast)),
            sd32.data_ptr(), sq32.data_ptr(), sv.data_ptr(), eoff.data_ptr(),
            totals.data_ptr(), smax.data_ptr(), cnt.data_ptr(),
            q, nd, n_slots, stream(dev),
        )
    check_rc(rc, "unified_fused")
    unified_fused.launches += 1
    return totals, smax, cnt


# ---------------------------------------------------------------- K2 / K3


def gather_rows_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows."""
    return table[ids]


def gather_rows_bf16_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows_bf16."""
    return table[ids].to(torch.bfloat16)


def _gather(ids, table, out_dtype, name, fn):
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: ids must be a 1D integer tensor")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"{name}: table must be 2D float32")
    if ids.device != table.device:
        raise ValueError(f"{name}: ids and table on different devices")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if table.device.type == "cpu":
        ref = gather_rows_bf16_ref if out_dtype == torch.bfloat16 else gather_rows_ref
        return ref(ids, table)
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    n_rows, n_slots = table.shape
    if n_slots % 4 or ids.numel() == 0 or n_rows == 0:
        raise ValueError(f"{name}: bad shapes ids={ids.numel()} "
                         f"table={tuple(table.shape)}")
    check_aligned(table)
    lib = library()
    dev = table.device
    ids32 = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.numel(), n_slots), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ns_gather_rows(
            ids32.data_ptr(), table.data_ptr(), out.data_ptr(),
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
    by the kernel); table f32 [rows, n_slots] -> f32 [uc, n_slots].
    """
    return _gather(ids, table, torch.float32, "gather_rows", gather_rows)


def gather_rows_bf16(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] rounded to bf16 (round-to-nearest-even) in the same pass.

    Replaces nextsearch_tpu/ops/heavy_pallas.py gather_rows_bf16_pallas
    (K2): the compact table of the guarded fast launch.
    """
    return _gather(ids, table, torch.bfloat16, "gather_rows_bf16",
                   gather_rows_bf16)


reset_launch_counts()
