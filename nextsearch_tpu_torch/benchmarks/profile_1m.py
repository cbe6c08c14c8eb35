"""Fused-mode stage profiling at 1M docs by full-launch variants (port of
nextsearch_tpu's benchmarks/profile_1m.py).

A mirror of ops/bm25.bm25_search_packed with per-stage toggles, timed as
whole launches over one batch stream; the delta of a variant against
"full" attributes the dropped stage (results wrong by design):

    full        the fused packed launch (scatter, heavy product, the
                score epilogue: add, found and tile maxima in one kernel,
                tiled top-k, exact rescore, canonical order)
    no_rescore  exact rescore and canonical order off
    no_topk     candidate selection off (fixed candidates), no rescore
    plain_topk  one top-k over the whole score row instead of tiled_topk
    no_found    the found count dropped: with the heavy stage on, the
                epilogue counts in the pass that adds H, which still runs
                (its count costs nothing apart); with it off, the
                epilogue's read pass goes
    no_scatter  the light terms' scatter off
    no_heavy    the heavy rows' gather (K3), product and add off (the
                epilogue reads the scores for found and the tile maxima)
    base        everything off

The configuration is the reference's: fused mode, posting block 512,
dense df ratio 1/256, 2 GiB of dense rows, bf16 pass-1 scores
(NEXTSEARCH_PROF_BF16=0 for f32), K2 32.

    python -m nextsearch_tpu_torch.benchmarks.profile_1m [--device cpu]

Env: NEXTSEARCH_PROF_DOCS (1000000), NEXTSEARCH_PROF_VOCAB (200000),
NEXTSEARCH_PROF_BATCH (512), NEXTSEARCH_PROF_BF16 (1),
NEXTSEARCH_PROF_VARIANTS (comma list). Each variant is timed as
profile_unified.py times its own: the CUDA-event span of one launch
(median of 12; host-bound) and the device ms of a trace of 12 launches;
on the CPU host ms only. Prints the card line first, the stage table, and
last one JSON line.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..ops.bm25 import (
    canonical_sort, exact_rescore, expand_chunks, heavy_scores,
    scatter_scores, tiled_topk, topk_low_index,
)
from ..ops.score_kernels import score_epilogue

VARIANTS = {
    "full": {},
    "no_rescore": {"do_rescore": False},
    "no_topk": {"topk": "none", "do_rescore": False},
    "plain_topk": {"topk": "plain"},
    "no_found": {"do_found": False},
    "no_scatter": {"do_scatter": False},
    "no_heavy": {"do_heavy": False},
    "base": {"do_scatter": False, "do_heavy": False, "do_found": False,
             "topk": "none", "do_rescore": False},
}


def variant_kernel(post_doc, post_score, dense_rows, plan_ints, plan_f32, *,
                   n_slots, K, K2, C, block, bs_steps, scores_bf16,
                   do_scatter=True, do_heavy=True, do_found=True,
                   topk="tiled", do_rescore=True):
    """Keep in step with ops/bm25.bm25_search_packed."""
    starts, dfs, light_dfs = plan_ints[0], plan_ints[1], plan_ints[2]
    Q, T = starts.shape
    weights = plan_f32[:Q, :T].contiguous()
    heavy_mix = plan_f32[:Q, T:].contiguous()
    unique_heavy = plan_f32[Q, T:].to(torch.int32)
    dev = post_doc.device
    sdtype = torch.bfloat16 if scores_bf16 else torch.float32
    if do_scatter:
        chunks = expand_chunks(starts, light_dfs, weights, C=C, block=block)
        scores = scatter_scores(post_doc, post_score, *chunks, Q=Q,
                                n_slots=n_slots, block=block, dtype=sdtype)
    else:
        scores = torch.zeros((Q, n_slots), dtype=sdtype, device=dev)
    found = tile_max = None
    if do_heavy:
        found, tile_max = score_epilogue(
            scores, heavy_scores(dense_rows, unique_heavy, heavy_mix))
    elif do_found:
        found, tile_max = score_epilogue(scores)
    if not do_found:
        found = torch.zeros((Q,), dtype=torch.int32, device=dev)
    k2 = min(K2, n_slots)
    if topk == "tiled":
        _fv, cand = tiled_topk(scores, k2, tile_max=tile_max)
    elif topk == "plain":
        _fv, cand = topk_low_index(scores, k2)
    else:  # fixed candidates, downstream shapes kept
        cand = torch.arange(k2, device=dev)[None, :].expand(Q, k2)
    cand = cand.to(torch.int32)
    if do_rescore:
        exact = exact_rescore(post_doc, post_score, starts, dfs, weights, cand,
                              bs_steps=bs_steps)
        sval, sdoc = canonical_sort(exact, cand)
    else:
        sval = torch.zeros((Q, k2), dtype=torch.float32, device=dev)
        sdoc = cand
    return torch.cat([sval[:, :K], sdoc[:, :K].to(torch.float32),
                      found[:, None].to(torch.float32)], dim=1)


def pack_plans(ti, batches, block: int):
    """Each batch's fused plan in bm25_search_packed's two arrays, and the
    shared chunk budget C (the largest live chunk count, rounded to 128)."""
    plans, max_live = [], 1
    for b in batches:
        s, d, w, ld, uh, hm = ti.plan_full(b)
        live = int(np.sum((ld.astype(np.int64) + block - 1) // block))
        max_live = max(max_live, live)
        Qb, T = s.shape
        U = uh.shape[0]
        pi = np.stack([s, d, ld])
        pf = np.zeros((Qb + 1, T + U), np.float32)
        pf[:Qb, :T] = w
        pf[:Qb, T:] = hm
        pf[Qb, T:] = uh.astype(np.float32)
        plans.append((pi, pf))
    return plans, ((max_live + 127) // 128) * 128


def main(argv=None) -> int:
    from ..config import DeviceConfig, EngineConfig
    from ..index.segment import TorchIndex
    from ..tools.synthetic import sample_queries
    from .probe_depth import device_arg, setup
    from .profile_unified import json_line, stage_table, time_variant

    device = device_arg(argv)
    card, seg, probs = setup(device, "NEXTSEARCH_PROF")
    env = os.environ.get
    batch = int(env("NEXTSEARCH_PROF_BATCH", 512))
    names = env("NEXTSEARCH_PROF_VARIANTS")
    names = names.split(",") if names else list(VARIANTS)
    blk = 512
    cfg = EngineConfig(device=DeviceConfig(
        mode="fused", posting_block=blk, heavy_buckets=(512,),
        dense_df_ratio=1 / 256, dense_max_bytes=2 << 30,
        scores_bf16=env("NEXTSEARCH_PROF_BF16", "1") == "1",
    ))
    t0 = time.time()
    ti = TorchIndex([seg], config=cfg, device=device)
    print(f"[prof] {seg.N} docs {seg.num_postings} postings "
          f"n_dense={ti.n_dense} n_slots={ti.n_slots} "
          f"(build {time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    batches = sample_queries(probs, n_queries=20 * batch, batch=batch)
    plans, C = pack_plans(ti, batches, blk)
    st = dict(n_slots=ti.n_slots, K=10, K2=32, C=C, block=blk,
              bs_steps=max(2, ti.n_slots.bit_length() + 1),
              scores_bf16=cfg.device.scores_bf16)
    print(f"[prof] C={C} T={plans[0][0].shape[2]} U={plans[0][1].shape[1] - plans[0][0].shape[2]}",
          file=sys.stderr, flush=True)
    dev_plans = [(torch.from_numpy(pi).to(device), torch.from_numpy(pf).to(device))
                 for pi, pf in plans]
    results = {}
    for name in names:
        it = iter(range(10 ** 9))

        def call(name=name, it=it):
            pi, pf = dev_plans[next(it) % len(dev_plans)]
            return variant_kernel(ti.post_doc, ti.post_score, ti.dense_rows,
                                  pi, pf, **st, **VARIANTS[name])

        results[name] = time_variant(call, device)
        print(f"[prof] {name}: {results[name]} ms/batch (span, device)",
              file=sys.stderr, flush=True)
    stage_table(results, "fused stage attribution")
    print(json_line("fused_1m", card, batch, results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
