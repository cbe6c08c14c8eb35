"""Micro-probe: where does the fused heavy kernel (K6) spend its time?

Port of nextsearch_tpu's benchmarks/probe_fusedmm.py at its shapes (Q 512,
uc 384, n_slots 999,424, a bf16 table of uniform random values, an f32
mix): K6's fast launch, then its attribution variants (P6,
heavy_kernels.heavy_fused_variant) with one part taken out each: the
epilogue, the smax store, the H store, or H stored bf16 to nearest; then
the plain product alone ("bare dot") with an f32 and a bf16 H, and a null
launch as the floor.

    python -m nextsearch_tpu_torch.benchmarks.probe_fusedmm [--reps N]

Times are device milliseconds between CUDA events, median of --reps.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import heavy_kernels as hk

Q, UC, N_SLOTS = 512, 384, 999_424

# label -> heavy_fused_variant switches (the probe's rows, in its order)
VARIANTS = {
    "variant full (parity check)": {},
    "no epilogue (dot + H store)": dict(epilogue=False),
    "epilogue, no smax store": dict(smax_store=False),
    "no H store (dot + epilogue)": dict(store_h=False),
    "bf16 H store": dict(h_dtype=torch.bfloat16),
}


def operands(device, *, q: int = Q, uc: int = UC, n_slots: int = N_SLOTS,
             seed: int = 0):
    """(mix f32 [q, uc], dense bf16 [uc, n_slots]), uniform in [0, 1),
    made on the device from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    dense = torch.rand((uc, n_slots), generator=g, device=device).to(torch.bfloat16)
    mix = torch.rand((q, uc), generator=g, device=device)
    return mix, dense


def bare_dot(mix, dense, h_dtype=torch.float32):
    """The product alone, as the plain version computes it (mix rounded to
    bf16, true f32 sums: TF32 off), H in h_dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = mix.to(torch.bfloat16).float() @ dense.float()
    return h if h_dtype == torch.float32 else h.to(h_dtype)


def calls(mix, dense) -> dict:
    """label -> call, every row of the probe."""
    out = {
        "null launch (floor)": lambda: mix[:8, :8] + 1.0,
        "current heavy_fused fast": lambda: hk.heavy_fused(mix, dense, fast=True),
    }
    for label, kw in VARIANTS.items():
        out[label] = lambda kw=kw: hk.heavy_fused_variant(mix, dense, **kw)
    out["plain bare dot -> f32 H"] = lambda: bare_dot(mix, dense)
    out["plain bare dot -> bf16 H"] = lambda: bare_dot(mix, dense, torch.bfloat16)
    return out


def run(device, reps: int = 12, **shape) -> dict:
    """Time every row on `device` (a CUDA card); returns label -> ms."""
    from .common import event_ms, row

    mix, dense = operands(device, **shape)
    print(f"[probe] Q={mix.shape[0]} uc={mix.shape[1]} n_slots={dense.shape[1]}",
          flush=True)
    times = {}
    for label, fn in calls(mix, dense).items():
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
