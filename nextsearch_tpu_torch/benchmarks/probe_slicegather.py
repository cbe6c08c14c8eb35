"""Does a slice gather (16 contiguous elements per index) cost like one
random access or like 16? (Port of nextsearch_tpu's
benchmarks/probe_slicegather.py, as torch ops on one card.)

The rescore's bucket binary search makes dependent single-element gather
rounds per (candidate, term); fetching each candidate's whole 16-element
bucket in one slice gather and comparing in registers would replace them
if slices are priced like accesses. Over a 46,770,456-element f32 array
(the 1M corpus's postings) and 512 * 4 * 32 indices:

    6 dependent element-gather rounds   (the binary search's cost model)
    1 slice gather [n, 16]              (an as_strided [P - 15, 16] view,
                                         indexed once)
    16 elementwise gathers              (control)

    python -m nextsearch_tpu_torch.benchmarks.probe_slicegather [--device cpu]

Env (small runs only): NEXTSEARCH_PROBE_P (46770456). Times are device
milliseconds between CUDA events (median of 10; CPU: host ms). Prints the
card line first, one row each, and last one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    from .common import card_line
    from .probe_depth import device_arg
    from .probe_light import timer

    device = device_arg(argv)
    card = card_line() if device.type == "cuda" else "cpu (no device measured)"
    print(card, flush=True)
    r = np.random.default_rng(0)
    P = int(os.environ.get("NEXTSEARCH_PROBE_P", 46_770_456))
    n = 512 * 4 * 32  # [Q, T, kc] flattened
    arr = torch.from_numpy(r.random(P, np.float32)).to(device)
    idx = torch.from_numpy(r.integers(0, P - 16, n)).to(device)
    timeit, results = timer(device)

    def elem6(a, i):
        acc = torch.zeros(n, dtype=torch.float32, device=a.device)
        ii = i
        for _ in range(6):
            v = a[ii.clamp(0, P - 1)]
            acc = acc + v
            ii = ii + (v > 0.5).to(ii.dtype)  # the next index depends on v
        return acc.sum()

    def slice16(a, i):
        return a.as_strided((P - 15, 16), (1, 1))[i].sum()

    def elem16(a, i):
        off = torch.arange(16, device=a.device)
        return a[(i[:, None] + off).clamp(0, P - 1)].sum()

    timeit("6 dependent element-gather rounds", elem6, arr, idx)
    timeit("1 slice-gather [n, 16]", slice16, arr, idx)
    timeit("16 elementwise gathers (control)", elem16, arr, idx)
    print(json.dumps({"probe": "slicegather", "device": card, "P": P, "n": n,
                      "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
