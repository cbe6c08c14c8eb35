"""Micro-probe: the light chain's component costs and their replacements,
as torch ops on one card (port of nextsearch_tpu's
benchmarks/probe_light.py).

Times each candidate standalone at serving shapes (Q 512, C 3072 chunks of
64 lanes = 196,608 flat entries, ~1.6 entries per (q, doc) group, 1,000,064
doc slots):

  segsum paths   the bounded left fold (the port's segmented_cumsum_bounded
                 over T lanes), cumsum + cummax difference and cumsum +
                 gather (approximate group totals)
  sort paths     1 key + 1 value, the 2-key composite sort (the quantized
                 sort2's), 1 key + 1 value stable, the exact sort2's two
                 stable passes, 1 key only
  hgather paths  the full N-lane element gather of H, the same lanes masked
                 to 0, a compacted gather into a smaller static buffer, and
                 half the lanes (count reference)

    python -m nextsearch_tpu_torch.benchmarks.probe_light [--device cpu]

Env (small runs only): NEXTSEARCH_PROBE_C (3072), NEXTSEARCH_PROBE_SLOTS
(1000064), NEXTSEARCH_PROBE_T (8, the fold's bound). Times are device
milliseconds between CUDA events (median of 12; CPU: host ms). Prints the
card line first, one row per candidate, and last one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..ops.bm25 import f32_order_key
from ..ops.bm25_sparse import segmented_cumsum_bounded


def timer(device):
    from .common import event_ms, row
    from .profile_unified import host_ms

    results = {}

    def timeit(name, fn, *args):
        ms = (event_ms(lambda: fn(*args), 12, warm=1) if device.type == "cuda"
              else host_ms(lambda: fn(*args), 3))
        row(name, ms)
        results[name] = round(ms, 4)
        return ms

    return timeit, results


def main(argv=None) -> int:
    from .common import card_line
    from .probe_depth import device_arg

    device = device_arg(argv)
    card = card_line() if device.type == "cuda" else "cpu (no device measured)"
    print(card, flush=True)
    env = os.environ.get
    Q = 512
    C = int(env("NEXTSEARCH_PROBE_C", 3072))
    block = 64
    N = C * block
    n_slots = int(env("NEXTSEARCH_PROBE_SLOTS", 1_000_064))
    T = int(env("NEXTSEARCH_PROBE_T", 8))
    r = np.random.default_rng(0)
    # synthetic (q, doc)-sorted light entries with duplicate-doc runs
    qs = np.sort(r.integers(0, Q, N)).astype(np.int64)
    ds = np.zeros(N, np.int64)
    bounds = np.searchsorted(qs, np.arange(Q + 1))
    for q in range(Q):
        lo, hi = bounds[q], bounds[q + 1]
        ds[lo:hi] = np.sort(r.integers(0, n_slots, hi - lo))
    sc = (r.random(N, np.float32) * 8.0).astype(np.float32)
    first_np = np.concatenate([[True], (qs[1:] != qs[:-1]) | (ds[1:] != ds[:-1])])
    dev = device
    sq = torch.from_numpy(qs).to(dev)
    sd = torch.from_numpy(ds).to(dev)
    svals = torch.from_numpy(sc).to(dev)
    first = torch.from_numpy(first_np).to(dev)
    last = torch.from_numpy(np.concatenate([first_np[1:], [True]])).to(dev)
    H = torch.rand((Q, n_slots), generator=torch.Generator().manual_seed(0)).to(dev)
    n_groups = int(first_np.sum())
    print(f"[probe] Q={Q} N={N} groups={n_groups} ({N / n_groups:.2f}/group)",
          flush=True)
    timeit, results = timer(device)

    timeit("null launch (floor)", lambda x: x[:8] + 1.0, svals)

    # --- segsum paths
    timeit(f"segsum bounded fold, T={T} (current)",
           segmented_cumsum_bounded, svals, first, T)

    def segsum_cumsum_diff(sv, first):
        cs = torch.cumsum(sv, 0)
        csz = torch.cat([torch.zeros(1, device=sv.device), cs])[:-1]
        # cs is monotone (contributions >= 0): the exclusive prefix at each
        # group start carries forward as a running max
        base = torch.cummax(torch.where(first, csz, torch.full_like(csz, -1.0)),
                            0).values
        return cs - base

    timeit("segsum cumsum+cummax (approx)", segsum_cumsum_diff, svals, first)

    def segsum_cumsum_gather(sv, first):
        cs = torch.cumsum(sv, 0)
        iota = torch.arange(sv.shape[0], device=sv.device)
        gstart = torch.cummax(torch.where(first, iota, torch.zeros_like(iota)),
                              0).values
        csz = torch.cat([torch.zeros(1, device=sv.device), cs])
        return cs - csz[gstart]

    timeit("segsum cumsum+gather (approx)", segsum_cumsum_gather, svals, first)

    # --- selection sort paths
    bits = svals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key1 = (sq << 22) | (bits >> 10)
    pay = sd

    def sort_kv(k, v, stable=False):
        s, o = torch.sort(k, stable=stable)
        return s, v[o]

    timeit("sort 1key+1val (lsort shape)", sort_kv, key1, svals)
    timeit("sort 2key (current sort2, composite)",
           lambda k, p: torch.sort((k << 31) | p).values, key1, pay)
    timeit("sort 1key+1val stable", lambda k, p: sort_kv(k, p, True), key1, pay)

    def sort_wide(q, s, p):
        o1 = torch.sort(p, stable=True).indices
        k = (q[o1] << 32) | f32_order_key(-s[o1])
        return o1[torch.sort(k, stable=True).indices]

    timeit("sort 3op 2key (wide sort2, two passes)", sort_wide, sq, svals, pay)
    timeit("sort 1key only", lambda k: torch.sort(k).values, key1)

    # --- hgather paths
    def hgather_full(H, sq, sd):
        return H[sq.clamp(0, Q - 1), sd.clamp(0, n_slots - 1)]

    timeit("hgather full N lanes (current)", hgather_full, H, sq, sd)

    def hgather_lastmask(H, sq, sd, last):
        qq = torch.where(last, sq.clamp(0, Q - 1), torch.zeros_like(sq))
        dd = torch.where(last, sd.clamp(0, n_slots - 1), torch.zeros_like(sd))
        return H[qq, dd]

    timeit("hgather masked-to-0 (same lanes)", hgather_lastmask, H, sq, sd, last)
    L3 = ((n_groups + 4095) // 4096) * 4096

    def hgather_compact(H, sq, sd, last):
        lidx = torch.cumsum(last.to(torch.int64), 0) - 1
        lidx = torch.where(last, lidx.clamp(max=L3), torch.full_like(lidx, L3))
        gq = torch.zeros(L3 + 1, dtype=torch.int64, device=H.device)
        gd = torch.zeros(L3 + 1, dtype=torch.int64, device=H.device)
        gq[lidx] = sq
        gd[lidx] = sd
        hv = H[gq.clamp(0, Q - 1), gd.clamp(0, n_slots - 1)]
        return hv[lidx]

    timeit(f"hgather compact L3={L3}", hgather_compact, H, sq, sd, last)
    timeit("hgather half lanes (count ref)", hgather_full, H, sq[: N // 2],
           sd[: N // 2])

    # --- the current pair for reference
    def chain_current(sv, first, key1, pay):
        stot = segmented_cumsum_bounded(sv, first, T)
        return stot, torch.sort((key1 << 31) | pay).values

    timeit("segsum+2keysort (current pair)", chain_current, svals, first, key1,
           pay)
    print(json.dumps({"probe": "light", "device": card, "Q": Q, "N": N,
                      "n_slots": n_slots, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
