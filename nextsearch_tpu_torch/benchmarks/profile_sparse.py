"""Sparse-kernel stage profiling at 1M docs by whole-pipeline variants.

Port of nextsearch_tpu's benchmarks/profile_sparse.py: a copy of the
packed pipeline whose stages each variant can drop (the heavy product, the
light chain, the H gather feeding `found`, the heavy candidates, the exact
rescore), timed whole. The heavy product is K6 (heavy_kernels.heavy_fused)
over the full dense table, exact, and the rescore is exact_rescore_v2, which
reads the heavy bucket table: the one configuration that has that table is
the bf16-dense-rows index (DeviceConfig.dense_rows_bf16), so this script
builds one, at the original's settings: posting block 512, dense df ratio
1/256, dense_max_bytes 7 GiB.

    python -m nextsearch_tpu_torch.benchmarks.profile_sparse

Env: NEXTSEARCH_PROF_DOCS (1000000), NEXTSEARCH_PROF_VOCAB (200000),
NEXTSEARCH_PROF_BATCH (512), NEXTSEARCH_PROF_VARIANTS (comma list; default
all), NEXTSEARCH_PROF_DENSE (ratio, 1/256), NEXTSEARCH_PROF_DENSE_BYTES
(7 GiB). Plans are uploaded before timing; times are device milliseconds
between CUDA events, median over 12 batches.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops.bm25 import PAD_DOC, canonical_sort
from ..ops.bm25_sparse import (
    LIGHT_BUCKET_LOG2, dedup_sorted, exact_rescore_v2, heavy_candidates,
    heavy_operands, light_totals, per_query_counts, per_query_topk_flat,
)
from ..ops.heavy_kernels import heavy_fused

K, K2 = 10, 32

VARIANTS = {
    "full": {},
    "no_rescore": {"do_rescore": False},
    "no_hgather": {"do_hgather": False},
    "no_cand_heavy": {"do_cand_heavy": False},
    "no_light": {"do_light": False, "do_hgather": False},
    "no_heavy": {"do_heavy": False, "do_cand_heavy": False},
    "base": {"do_heavy": False, "do_light": False, "do_hgather": False,
             "do_cand_heavy": False, "do_rescore": False},
}


def variant_kernel(post_doc, post_score, dense_rows, bucket_pos,
                   light_bucket_pos, plan, *, n_slots: int, K: int, K2: int,
                   C: int, block: int, bs_steps: int, nd: int, nl: int,
                   lb_log2: int = LIGHT_BUCKET_LOG2, do_heavy: bool = True,
                   do_light: bool = True, do_hgather: bool = True,
                   do_cand_heavy: bool = True, do_rescore: bool = True):
    """The original's variant_kernel: packed f32 [Q, 2K+1] (vals | doc
    slots | found). With every stage on it is the exact packed pipeline
    over the full table (K6, exact) with the v2 rescore; lb_log2 is the
    index's light bucket granularity (the original passed the default)."""
    dev = plan.device
    starts, light_dfs = plan[0], plan[1]
    weights = plan[5].contiguous().view(torch.float32)
    Q = starts.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if do_heavy:
        mix, _ids = heavy_operands(plan, dense_rows.shape[0], nd=nd, U=0,
                                   use_compact=False)
        H, smax_sq, cnt_tq = heavy_fused(mix, dense_rows)
        heavy_found = cnt_tq.sum(dim=0).to(torch.int64)
    else:
        H = torch.zeros((Q, n_slots), dtype=torch.float32, device=dev)
        smax_sq = torch.zeros((-(-n_slots // 512), Q), dtype=torch.float32,
                              device=dev)
        heavy_found = torch.zeros((Q,), dtype=torch.int64, device=dev)

    if do_light:
        sq, sd, stot, last = light_totals(
            post_doc, post_score, starts, light_dfs, weights,
            C=C, block=block, Q=Q, n_slots=n_slots,
        )
        sd_clip = sd.clamp(0, n_slots - 1)
        if do_hgather:
            hval = H[sq.clamp(0, Q - 1), sd_clip].float()
        else:
            hval = torch.zeros(sq.shape, dtype=torch.float32, device=dev)
        valid_last = last & (sq < Q)
        found = heavy_found + per_query_counts(sq, valid_last & (hval == 0.0), Q)
        sel_score = torch.where(valid_last, stot + hval, zero)
        ldocs, _lvals = per_query_topk_flat(sq, sel_score, sd, Q, K2)
    else:
        found = heavy_found
        ldocs = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)

    if do_cand_heavy:
        _hvals, hdocs = heavy_candidates(H, smax_sq, K2, Q, n_slots)
    else:
        hdocs = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)

    cand = torch.cat([ldocs, hdocs], dim=1)
    cand = torch.where(cand >= n_slots, torch.full_like(cand, PAD_DOC), cand)
    safe_cand = cand.clamp(0, n_slots - 1)
    if do_rescore:
        exact = exact_rescore_v2(
            post_doc, post_score, bucket_pos, light_bucket_pos, starts,
            plan[2], plan[3], weights, safe_cand, bs_steps=bs_steps, nd=nd,
            nl=nl, lb_log2=lb_log2,
        )
        exact = torch.where(cand < n_slots, exact, zero)
    else:
        exact = (cand < n_slots).to(torch.float32)
    sval, sdoc = canonical_sort(exact, safe_cand)
    sval, sdoc = dedup_sorted(sval, sdoc)
    return torch.cat([sval[:, :K], sdoc[:, :K].to(torch.float32),
                      found[:, None].to(torch.float32)], dim=1)


def chunk_budget(ti, plans) -> int:
    """The original's C: the largest live chunk count over the plans,
    rounded up to 128."""
    block = ti.config.device.posting_block
    live = max(int(np.sum((p[1].astype(np.int64) + block - 1) // block))
               for p in plans)
    return ((max(live, 1) + 127) // 128) * 128


def statics(ti, C: int) -> dict:
    """variant_kernel's static arguments for index `ti` and chunk budget C."""
    return dict(n_slots=ti.n_slots, K=K, K2=K2, C=C,
                block=ti.config.device.posting_block, bs_steps=ti._bs_depth,
                nd=ti.n_dense, nl=ti.n_light, lb_log2=ti._lb_log2)


def launch(ti, plan_dev, C: int, **variant):
    """One variant_kernel launch on index ti's tables."""
    return variant_kernel(ti.post_doc, ti.post_score, ti.dense_rows,
                          ti.bucket_pos, ti.light_bucket_pos, plan_dev,
                          **statics(ti, C), **variant)


def main() -> int:
    from nextsearch_tpu.config import DeviceConfig, EngineConfig

    from ..index.segment import TorchIndex
    from ..tools.synthetic import sample_queries
    from .common import bench_corpus, card_line, event_ms, require_cuda

    device = require_cuda()
    print(card_line(), flush=True)
    env = os.environ.get
    n_docs = int(env("NEXTSEARCH_PROF_DOCS", 1_000_000))
    vocab = int(env("NEXTSEARCH_PROF_VOCAB", 200_000))
    batch = int(env("NEXTSEARCH_PROF_BATCH", 512))
    names = env("NEXTSEARCH_PROF_VARIANTS")
    names = names.split(",") if names else list(VARIANTS)
    seg, probs = bench_corpus(n_docs, vocab)
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=512, dense_rows_bf16=True,
        dense_df_ratio=float(env("NEXTSEARCH_PROF_DENSE", 1 / 256)),
        dense_max_bytes=int(env("NEXTSEARCH_PROF_DENSE_BYTES", 7 << 30)),
    ))
    ti = TorchIndex([seg], config=cfg, device=device)
    print(f"[prof] {n_docs} docs {seg.num_postings} postings "
          f"n_dense={ti.n_dense} n_slots={ti.n_slots} bs_depth={ti._bs_depth}",
          file=sys.stderr, flush=True)
    batches = sample_queries(probs, n_queries=20 * batch, batch=batch)
    plans = [ti.plan_sparse(b)[0] for b in batches]
    C = chunk_budget(ti, plans)
    dev_plans = [torch.from_numpy(p).to(device) for p in plans]
    print(f"[prof] C={C} T={plans[0].shape[2]}", file=sys.stderr, flush=True)
    results = {}
    for name in names:
        it = iter(range(2, 10 ** 9))
        launch(ti, dev_plans[0], C, **VARIANTS[name])  # warm

        def call(name=name, it=it):
            return launch(ti, dev_plans[next(it) % len(dev_plans)], C,
                          **VARIANTS[name])

        results[name] = event_ms(call, 12, warm=0)
        print(f"[prof] {name}: {results[name]:.3f} ms/batch "
              f"({batch / results[name] * 1000:.0f} qps)", file=sys.stderr,
              flush=True)
    print("\n=== sparse stage attribution (ms/batch) ===")
    full = results.get("full")
    for name, ms in results.items():
        delta = (f"  (full - this = {full - ms:+.3f})"
                 if full and name != "full" else "")
        print(f"{name:14s} {ms:10.3f}{delta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
