"""Micro-probe: where does heavy candidate extraction spend its time?

Port of nextsearch_tpu's benchmarks/probe_candsel.py at its shapes (Q 512,
n_slots 999,424, K2 32, CSUB 128; random H and sub-block maxima). It times
the three steps of bm25_sparse.heavy_candidates alone

    topk_smax   top-K2 sub-blocks per query from smax [n_sub, Q]
    gather      the K2 chosen 128-doc sub-blocks of H  -> [Q, K2 * 128]
    topk_flat   top-K2 docs of the gathered values

then the whole function, the hierarchical 128 -> 32-doc narrowing and its
32-doc gather, a max-fold as a bandwidth reference, and K6 (the fused
heavy kernel) at its 2048-doc tile over a bf16 table [384, n_slots].

The original also swept the TPU kernel's grid tile (4096, 8192, 16384
docs). That tile is a Mosaic block size; the Hopper kernel's block is fixed
(64 queries x 128 docs) and has no tile to sweep, so that sweep has no
counterpart here.

    python -m nextsearch_tpu_torch.benchmarks.probe_candsel [--reps N]

Times are device milliseconds between CUDA events, median of --reps.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import heavy_kernels as hk
from ..ops.bm25_sparse import _stable_topk, heavy_candidates

Q, N_SLOTS, K2, CSUB, CS2 = 512, 999_424, 32, 128, 32


def operands(device, *, q: int = Q, n_slots: int = N_SLOTS, uc: int = 384,
             seed: int = 0) -> dict:
    """Random H [q, n_slots], smax [sub_pad, q], 32-doc maxima [q,
    n_slots / 32], and K6's mix [q, uc] / bf16 table [uc, n_slots], all
    uniform in [0, 1) and made on the device from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    sub_pad = ((n_slots // 2048 + 7) // 8) * 8 * 16
    return dict(
        H=torch.rand((q, n_slots), generator=g, device=device),
        smax=torch.rand((sub_pad, q), generator=g, device=device),
        smax32=torch.rand((q, n_slots // CS2), generator=g, device=device),
        mix=torch.rand((q, uc), generator=g, device=device),
        table=torch.rand((uc, n_slots), generator=g,
                         device=device).to(torch.bfloat16),
        q=q, n_slots=n_slots,
    )


def topk_smax(smax, n_sub: int, k2: int = K2):
    """Step 1: the top-k2 sub-blocks per query, doc-ascending."""
    _v, tidx = _stable_topk(smax.T[:, :n_sub], k2)
    return torch.sort(tidx, dim=1).values


def gather_tiles(H, tidx, width: int = CSUB):
    """Step 2: the chosen width-doc blocks of H, [Q, k2, width]."""
    q = H.shape[0]
    tiles = H.view(q, -1, width)
    return torch.gather(tiles, 1, tidx[:, :, None].expand(-1, -1, width))


def topk_flat(flat, k2: int = K2):
    """Step 3: the top-k2 values of the gathered blocks."""
    return _stable_topk(flat, k2)


def hier(H, smax, smax32, n_sub: int, k2: int = K2):
    """128-doc sub-blocks -> 32-doc blocks -> docs, each level keeping the
    top k2 (a doc's own block max bounds it at every granularity)."""
    q = H.shape[0]
    per = CSUB // CS2
    tidx = topk_smax(smax, n_sub, k2)
    g32 = torch.gather(smax32.view(q, n_sub, per), 1,
                       tidx[:, :, None].expand(-1, -1, per))
    blk = tidx[:, :, None] * per + torch.arange(per, device=H.device)
    _v2, bi = _stable_topk(g32.reshape(q, k2 * per), k2)
    bidx = torch.sort(torch.gather(blk.reshape(q, k2 * per), 1, bi),
                      dim=1).values
    cand = gather_tiles(H, bidx, CS2)
    vals, pos = _stable_topk(cand.reshape(q, k2 * CS2), k2)
    base = torch.gather(bidx, 1, pos // CS2) * CS2
    return vals, torch.where(vals > 0, base + pos % CS2,
                             torch.full_like(pos, 2 ** 30))


def calls(ops: dict) -> dict:
    """label -> call, every row of the probe."""
    H, smax, smax32 = ops["H"], ops["smax"], ops["smax32"]
    q, n_slots = ops["q"], ops["n_slots"]
    n_sub = n_slots // CSUB
    tidx = topk_smax(smax, n_sub)
    flat = gather_tiles(H, tidx).reshape(q, K2 * CSUB)
    bidx = torch.sort(_stable_topk(smax32[:, :K2 * 4], K2)[1], dim=1).values
    fold = min(n_sub, 7680) // 128 * 128
    return {
        "null launch (floor)": lambda: smax[:8, :8] + 1.0,
        "topk_smax (transpose+top-k)": lambda: topk_smax(smax, n_sub),
        "gather 32x128 H sub-tiles": lambda: gather_tiles(H, tidx),
        "topk_flat [Q, 4096] k=32": lambda: topk_flat(flat),
        "heavy_candidates (current)": lambda: heavy_candidates(
            H, smax, K2, q, n_slots),
        "hier 128->32 narrowing": lambda: hier(H, smax, smax32, n_sub),
        "gather 32x32 H blocks": lambda: gather_tiles(H, bidx, CS2),
        "fold max (bandwidth ref)": lambda: smax.T[:, :fold].reshape(
            q, -1, 128).amax(dim=2),
        "heavy_fused (K6) TILE=2048": lambda: hk.heavy_fused(
            ops["mix"], ops["table"], fast=True),
    }


def run(device, reps: int = 12, **shape) -> dict:
    """Time every row on `device` (a CUDA card); returns label -> ms."""
    from .common import event_ms, row

    ops = operands(device, **shape)
    print(f"[probe] Q={ops['q']} n_slots={ops['n_slots']} "
          f"n_sub={ops['n_slots'] // CSUB} sub_pad={ops['smax'].shape[0]}",
          flush=True)
    times = {}
    for label, fn in calls(ops).items():
        times[label] = event_ms(fn, reps)
        row(label, times[label])
    return times


def main(argv=None) -> int:
    from .common import card_line, require_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)
    device = require_cuda()
    print(card_line(), flush=True)
    run(device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
