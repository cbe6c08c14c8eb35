"""Run the five lowering probes P1-P5 on the card, each against its plain
PyTorch version, and print PASS/FAIL per probe.

Port of nextsearch_tpu's benchmarks/mosaic_probe.py, with its shapes (Q
128, W 512, TILE 1024, f32). The original fed constants (ones, twos) where
only lowering mattered; here every operand is seeded random, so a kernel
that reads the wrong rows, lanes or layout fails:

  1. NT dot: [Q, W] x [TILE, W]^T
  2. a [1, 512] row at an index read on the device, broadcast to [8, 512], x2
  3. the one-hot window op: a scatter-add of W (query, doc, value) entries
     into [Q, TILE], checked against numpy's np.add.at as the original was
  4. reshape (4, 128, Q) -> (512, Q)
  5. transpose [1, 128] -> [128, 1], and [37, 300] -> [300, 37] (a [1, 128]
     transpose has the bytes of a copy; the second shape is not a multiple
     of the kernel's 16 x 16 tile)

    python -m nextsearch_tpu_torch.benchmarks.kernel_probe

Exits non-zero if a probe fails. Tolerances: P1 within 2 * W * 2^-24
relative (two orders of a W-term positive sum), P3 within 1e-6 relative,
P2, P4 and P5 bit for bit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_kernels as pk

Q, W, TILE = 128, 512, 1024


def inputs(device) -> dict:
    """Each probe's operands, as mosaic_probe's t1..t5 build them."""
    rng = np.random.default_rng(0)
    wq = rng.integers(0, Q, (1, W))
    wd = rng.integers(0, TILE, (1, W))
    wv = rng.uniform(0.5, 1.5, (1, W)).astype(np.float32)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def rand(*shape):
        return dev(rng.random(shape, dtype=np.float32))

    return {
        "nt_dot": (rand(Q, W), rand(TILE, W)),
        "row_copy": (dev(np.arange(16 * 512).reshape(16, 512)),
                     dev([3], torch.int32)),
        "window_op": (dev(wq[0], torch.int32), dev(wv[0]),
                      dev(wd[0], torch.int32)),
        "reshape_copy": (rand(4, 128, Q),),
        "transpose": (rand(1, 128),),
        "transpose_wide": (rand(37, 300),),
    }


def calls(args: dict) -> dict:
    """name -> (label, kernel call, plain call, relative tolerance); the
    transpose runs twice, as "transpose" and "transpose_wide"."""
    a, b = args["nt_dot"]
    e, off = args["row_copy"]
    wq, wv, wd = args["window_op"]
    (r,) = args["reshape_copy"]
    (t,) = args["transpose"]
    (tw,) = args["transpose_wide"]
    return {
        "nt_dot": ("1 NT dot_general", lambda: pk.nt_dot(a, b),
                   lambda: pk.nt_dot_ref(a, b), 2 * W * 2.0 ** -24),
        "row_copy": ("2 dynamic [1,512] row copy",
                     lambda: pk.row_copy(e, off, 8),
                     lambda: pk.row_copy_ref(e, off, 8), 0.0),
        "window_op": ("3 full window op (onehot+NTdot, checked)",
                      lambda: pk.window_op(wq, wv, wd, q=Q, tile=TILE),
                      lambda: pk.window_op_ref(wq, wv, wd, q=Q, tile=TILE),
                      1e-6),
        "reshape_copy": ("4 reshape (4,128,Q)->(512,Q)",
                         lambda: pk.reshape_copy(r, (512, Q)),
                         lambda: pk.reshape_copy_ref(r, (512, Q)), 0.0),
        "transpose": ("5 transpose [1,128]->[128,1]",
                      lambda: pk.transpose(t), lambda: pk.transpose_ref(t),
                      0.0),
        "transpose_wide": ("5 transpose [37,300]->[300,37]",
                           lambda: pk.transpose(tw),
                           lambda: pk.transpose_ref(tw), 0.0),
    }


def check(got: torch.Tensor, exp: torch.Tensor, rtol: float) -> float:
    """Max abs error of got against exp; raises past rtol (0: bit for
    bit)."""
    if got.shape != exp.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(exp.shape)}")
    diff = (got - exp).abs()
    if rtol == 0.0:
        if not torch.equal(got, exp):
            raise AssertionError("not bit-exact")
    elif bool((diff > rtol * exp.abs()).any()):
        raise AssertionError(f"max abs err {float(diff.max()):.3g} past rtol {rtol}")
    return float(diff.max()) if diff.numel() else 0.0


def window_numpy(args: dict) -> np.ndarray:
    """mosaic_probe t3's own check: np.add.at of the entries."""
    wq, wv, wd = (x.cpu().numpy() for x in args["window_op"])
    ref = np.zeros((Q, TILE), np.float32)
    np.add.at(ref, (wq, wd), wv)
    return ref


def run(device) -> dict:
    """Launch each probe once and hold it against its plain version; prints
    a PASS/FAIL line per probe and the summary, returns name -> passed."""
    args = inputs(device)
    result = {}
    for name, (label, kernel, plain, rtol) in calls(args).items():
        try:
            got = kernel()
            check(got, plain(), rtol)
            if name == "window_op":
                ref = torch.from_numpy(window_numpy(args)).to(device)
                check(got, ref, 1e-6)
            print(f"PASS {label}: {got.flatten()[:4].cpu().numpy()}", flush=True)
            result[name] = True
        except Exception as e:  # noqa: BLE001 - the probe reports, as the original
            msg = str(e).split("\n")[0][:300]
            print(f"FAIL {label}: {type(e).__name__}: {msg}", flush=True)
            result[name] = False
    print("SUMMARY:", result, flush=True)
    return result


def main() -> int:
    from .common import card_line, require_cuda

    device = require_cuda()
    print(card_line(), flush=True)
    return 0 if all(run(device).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
