"""Micro-probe: the heavy product's dense kernels, old against new.

At probe_fusedmm's shapes (Q 512, uc 384, n_slots 999,424, a dense
torch.rand mix, so every 64-query block takes a dense kernel): K6's fast
launch on the tensor-core kernel and on the first port's FFMA loop
(the wrappers' ffma=True), its bf16-up H store and P6's no-epilogue
variant; then K1 f32-exact over the table widened to f32, on the cp.async-fed
FFMA kernel and on the older loop, beside the fp32 torch.matmul of the same
operands. Rows alternate old, new, new, old. Each pair is first compared:
cnt and H > 0 bit for bit, H within the tensor cores' tolerance for bf16
operands and bit for bit in f32-exact mode.

    python -m nextsearch_tpu_torch.benchmarks.probe_dense [--reps N]

To sweep a kernel constant, run it with PYTHONPATH set to a copy of the
package whose csrc/heavy.cu was edited; it prints the dense kernels'
registers and spills from that build first.

Times are device milliseconds between CUDA events, median of --reps.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import heavy_kernels as hk
from . import probe_fusedmm


def compare(new, old, rtol: float) -> float:
    """Max relative difference of H; raises unless cnt and H > 0 are equal
    and H is within rtol (0: bit for bit; a bf16 H within one bf16 step)."""
    if not (torch.equal(new[2], old[2]) and torch.equal(new[0] > 0, old[0] > 0)):
        raise AssertionError("cnt or positivity differs")
    if new[0].dtype == torch.bfloat16:
        # two f32 sums on either side of a rounding boundary are stored one
        # bf16 step apart
        rtol = max(rtol, 2.0 ** -7)
    a, b = new[0].float(), old[0].float()
    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    if rel > rtol:
        raise AssertionError(f"H differs by {rel:.3g} relative (rtol {rtol:.3g})")
    return rel


def build_report() -> list:
    """The dense kernels' lines of nvcc's -Xptxas -v report."""
    from ..ops import cuda_build

    lines = cuda_build.build()["ptxas"].splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling" in line and ("heavy_dense_tc" in line
                                    or "heavy_dense_exact" in line):
            name = "tensor cores" if "heavy_dense_tc" in line else "f32 exact"
            out.append(f"{name}: " + " ".join(
                x.strip().replace("ptxas info    : ", "")
                for x in lines[i + 2:i + 4]))
    return sorted(set(out))


def run(device, reps: int = 10, **shape) -> dict:
    """Compare and time every row on `device` (a CUDA card); returns
    label -> ms."""
    from .common import event_ms, row

    for line in build_report():
        print(f"[probe] {line}", flush=True)
    mix, dense = probe_fusedmm.operands(device, **shape)
    uc = mix.shape[1]
    print(f"[probe] Q={mix.shape[0]} uc={uc} n_slots={dense.shape[1]}", flush=True)
    bf16 = torch.bfloat16
    wide = dense.float()
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = {
        "K6 fast": lambda ffma: hk.heavy_fused(mix, dense, fast=True,
                                              ffma=ffma),
        "K6 fast, bf16-up H": lambda ffma: hk.heavy_fused(
            mix, dense, fast=True, h_dtype=bf16, ffma=ffma),
        "P6 no epilogue": lambda ffma: hk.heavy_fused_variant(
            mix, dense, epilogue=False, ffma=ffma),
        "K1 f32 exact": lambda ffma: hk.heavy_fused3(mix, wide, fast=False,
                                                     ffma=ffma),
    }
    times = {}
    for label, fn in calls.items():
        exact = label == "K1 f32 exact"
        rel = compare(fn(False), fn(True),
                      0.0 if exact else (uc / 8 + 8) * 2.0 ** -23)
        print(f"[probe] {label}: new against old, max rel diff of H {rel:.3g}",
              flush=True)
        for n, ffma in enumerate((True, False, False, True)):
            key = f"{label}, {'old' if ffma else 'new'} kernel ({n + 1})"
            times[key] = event_ms(lambda: fn(ffma), reps)
            row(key, times[key])
    times["torch.matmul fp32"] = event_ms(lambda: torch.matmul(mix, wide), reps)
    row("torch.matmul fp32", times["torch.matmul fp32"])
    return times


def main(argv=None) -> int:
    from .common import card_line, require_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = require_cuda()
    print(card_line(), flush=True)
    run(device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
