"""Bisect the bf16-up H store and the selection sorts: time each piece alone.

Port of nextsearch_tpu's benchmarks/probe_bf16h.py at its shapes: K6's fast
launch over an f32 table [384, 1,001,472] for 512 queries with an f32 H and
with a bf16 H rounded up (heavy_kernels.heavy_fused); the exact and the
quantized flat selection sort (bm25_sparse.per_query_topk_flat) over a
212,992-lane q-sorted stream with k2 = 32; and the windowed selection
kernel K4 (select_kernels.per_query_topk) over the same stream.

    python -m nextsearch_tpu_torch.benchmarks.probe_bf16h [--reps N]

Times are device milliseconds between CUDA events, median of --reps.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import heavy_kernels as hk
from ..ops.bm25_sparse import per_query_topk_flat
from ..ops.select_kernels import per_query_topk

Q, U, S = 512, 384, 1_001_472
N, K2 = 212_992, 32


def operands(device, *, q: int = Q, u: int = U, s: int = S, n: int = N,
             seed: int = 0) -> dict:
    """The probe's operands, made from `seed`: mix and table uniform in
    [0, 1) on the device; the selection stream (q-sorted query rows in
    [0, q], about 30% dead lanes, doc slots below s) from numpy."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = np.random.default_rng(seed)
    sq = np.sort(r.integers(0, q + 1, n)).astype(np.int64)
    sc = (r.random(n) * (r.random(n) > 0.3)).astype(np.float32)
    sd = r.integers(0, s, n).astype(np.int64)
    sq_t = torch.from_numpy(sq).to(device)
    return dict(
        mix=torch.rand((q, u), generator=g, device=device),
        table=torch.rand((u, s), generator=g, device=device),
        sq=sq_t, sc=torch.from_numpy(sc).to(device),
        sd=torch.from_numpy(sd).to(device),
        bounds=torch.searchsorted(
            sq_t, torch.arange(q + 1, dtype=torch.int64, device=device)),
        q=q,
    )


def calls(ops: dict) -> dict:
    """label -> call, every row of the probe."""
    m, t, q = ops["mix"], ops["table"], ops["q"]
    sq, sc, sd, bounds = ops["sq"], ops["sc"], ops["sd"], ops["bounds"]
    return {
        "fused fast H=f32": lambda: hk.heavy_fused(m, t, fast=True)[0].sum(),
        "fused fast H=bf16-up": lambda: hk.heavy_fused(
            m, t, fast=True, h_dtype=torch.bfloat16)[0].float().sum(),
        "sort2 exact (two stable passes)": lambda: per_query_topk_flat(
            sq, sc, sd, q, K2, quantized=False)[0].sum(),
        "sort2 quantized (packed key)": lambda: per_query_topk_flat(
            sq, sc, sd, q, K2, quantized=True)[0].sum(),
        "select kernel (K4)": lambda: per_query_topk(sc, bounds, K2)[0].sum(),
    }


def run(device, reps: int = 8, **shape) -> dict:
    """Time every row on `device` (a CUDA card); returns label -> ms."""
    from .common import event_ms, row

    ops = operands(device, **shape)
    times = {}
    for label, fn in calls(ops).items():
        times[label] = event_ms(fn, reps)
        row(label, times[label])
    return times


def main(argv=None) -> int:
    from .common import card_line, require_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    device = require_cuda()
    print(card_line(), flush=True)
    run(device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
