"""Unified-pipeline stage profiling at the serving operating point (port of
nextsearch_tpu's benchmarks/profile_unified.py).

A mirror of ops/bm25_sparse.unified_impl with per-stage toggles, timed as
whole launches; the delta of a variant against "full" attributes the
dropped stage (the dropped stages' results are wrong by design):

    full           the serving unified launch (guarded fast: K2 table, K5)
    no_rescore     exact rescore off (candidates scored 1.0)
    no_cand        heavy candidates off (selection gather + top-k)
    no_entries     light entry expansion and sort off; K5 sees no entries:
                   the whole light-entry feed
    no_entry_sort  the expansion runs, its sort is skipped; K5 takes the
                   plan's entries sorted once before timing (an unsorted
                   stream would send entries outside their tile)
    no_kernel      K5 replaced by zeros (totals, sub-block maxima, counts)
    base           everything off (launch and plan transport floor)

    python -m nextsearch_tpu_torch.benchmarks.profile_unified [--device cpu]

Env: NEXTSEARCH_PROF_DOCS (1000000), NEXTSEARCH_PROF_VOCAB (200000),
NEXTSEARCH_PROF_BATCH (512), NEXTSEARCH_PROF_BLOCK (64),
NEXTSEARCH_PROF_HEAVYB (512), NEXTSEARCH_PROF_VARIANTS (comma list).
Two times per variant: the span between CUDA events around one launch,
median over 12 batches, which holds the host's issue gaps (the loop is
host-bound: PERF.md), and the device ms per batch of a torch.profiler
trace of 12 launches (the union of kernel, memcpy and memset intervals,
benchmarks/common.traced). On the CPU: host milliseconds, no device
measured. Prints the card line first, the stage table, and last one JSON
line of the times.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..ops.bm25 import PAD_DOC, canonical_sort
from ..ops.bm25_sparse import (
    LIGHT_BUCKET_LOG2, _compact_table, _guard_column, _rescore,
    heavy_candidates, heavy_operands, light_entries, unified_entries,
)
from ..ops.heavy_kernels import CSUB, unified_fused

VARIANTS = {
    "full": {},
    "no_rescore": {"do_rescore": False},
    "no_cand": {"do_cand": False},
    "no_entry_sort": {"do_entry_sort": False},
    "no_entries": {"do_entries": False, "do_entry_sort": False},
    "no_kernel": {"do_kernel": False},
    "base": {"do_kernel": False, "do_entries": False, "do_entry_sort": False,
             "do_cand": False, "do_rescore": False},
}


def variant_unified(post_doc, post_score, dense_rows, light_bucket_pos, plan,
                    *, n_slots, K, K2, C, block, bs_steps, nd, nl, U, L2,
                    guard_eps, sorted_entries=None, do_kernel=True,
                    do_entries=True, do_entry_sort=True, do_cand=True,
                    do_rescore=True):
    """Keep in step with ops/bm25_sparse.unified_impl (fast_heavy=True)."""
    Q = plan.shape[1]
    dev = plan.device
    mix, ids = heavy_operands(plan, dense_rows.shape[0], nd=nd, U=U,
                              use_compact=True)
    table = _compact_table(ids, dense_rows, fast=True)
    N = C * block
    if not do_entries:
        sd = torch.full((N,), n_slots, dtype=torch.int64, device=dev)
        sq = torch.zeros((N,), dtype=torch.int64, device=dev)
        sv = torch.zeros((N,), dtype=torch.float32, device=dev)
    elif do_entry_sort:
        sd, sq, sv = unified_entries(post_doc, post_score, plan, C=C,
                                     block=block, n_slots=n_slots)
    else:
        weights = plan[5].contiguous().view(torch.float32)
        light_entries(post_doc, post_score, plan[0], plan[1], weights,
                      C=C, block=block, n_slots=n_slots)
        sd, sq, sv = sorted_entries
    if do_kernel:
        totals, smax_sq, cnt_tq = unified_fused(mix, table, sd, sq, sv,
                                                fast=True)
        found = cnt_tq.sum(dim=0)
    else:
        totals = torch.zeros((Q, n_slots), dtype=torch.float32, device=dev)
        smax_sq = torch.zeros((n_slots // CSUB, Q), dtype=torch.float32,
                              device=dev)
        found = torch.zeros((Q,), dtype=torch.int32, device=dev)
    if do_cand:
        pool_vals, cand = heavy_candidates(totals, smax_sq, K2, Q, n_slots)
        cand = torch.where(cand >= n_slots, torch.full_like(cand, PAD_DOC), cand)
    else:
        pool_vals = torch.zeros((Q, K2), dtype=torch.float32, device=dev)
        cand = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)
    if do_rescore:
        exact, safe_cand = _rescore(
            post_doc, post_score, dense_rows, None, light_bucket_pos, plan,
            cand, n_slots=n_slots, bs_steps=bs_steps, nd=nd, nl=nl, L2=L2,
            H2=0, lb_log2=LIGHT_BUCKET_LOG2, heavy_direct=True,
        )
    else:
        safe_cand = cand.clamp(0, n_slots - 1)
        exact = (cand < n_slots).to(torch.float32)
    sval, sdoc = canonical_sort(exact, safe_cand)
    return torch.cat([
        sval[:, :K], sdoc[:, :K].to(torch.float32),
        found[:, None].to(torch.float32),
        _guard_column(sval, pool_vals[:, K2 - 1], K, guard_eps),
    ], dim=1)


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of fn() (CPU runs; no device measured)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000)
    return sorted(times)[len(times) // 2]


def time_variant(call, device, n: int = 12):
    """(event-span ms, device ms) per launch of call(), which runs one
    launch; (host ms, None) on the CPU."""
    from .common import event_ms, traced

    if device.type != "cuda":
        return host_ms(call, 3), None
    span = event_ms(call, n, warm=1)
    return span, traced(lambda: [call() for _ in range(n)], n)["device_ms_per_batch"]


def stage_table(results: dict, label: str) -> None:
    """results: variant -> (span ms, device ms or None)."""
    print(f"\n=== {label} (ms/batch: event span, device) ===")
    full = results.get("full")
    for name, (ms, dev) in results.items():
        delta = ""
        if full and name != "full":
            delta = f"  (full - this = {full[0] - ms:+.3f}"
            if dev is not None:
                delta += f", device {full[1] - dev:+.3f}"
            delta += ")"
        print(f"{name:14s} {ms:10.3f} "
              + ("not measured" if dev is None else f"{dev:10.3f}") + delta)


def json_line(kind: str, card: str, batch: int, results: dict) -> str:
    return json.dumps({
        "profile": kind, "device": card, "batch": batch,
        "ms_per_batch": {k: round(v[0], 4) for k, v in results.items()},
        "device_ms_per_batch": {k: None if v[1] is None else round(v[1], 4)
                                for k, v in results.items()},
    })


def main(argv=None) -> int:
    from ..tools.synthetic import sample_queries
    from .probe_depth import device_arg, setup, sparse_bench_index

    device = device_arg(argv)
    card, seg, probs = setup(device, "NEXTSEARCH_PROF")
    env = os.environ.get
    batch = int(env("NEXTSEARCH_PROF_BATCH", 512))
    blk = int(env("NEXTSEARCH_PROF_BLOCK", 64))
    names = env("NEXTSEARCH_PROF_VARIANTS")
    names = names.split(",") if names else list(VARIANTS)
    t0 = time.time()
    ti = sparse_bench_index(seg, device, posting_block=blk, unified=True,
                            heavy_buckets=(int(env("NEXTSEARCH_PROF_HEAVYB",
                                                   512)),))
    print(f"[prof] index build+upload: {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)
    batches = sample_queries(probs, n_queries=20 * batch, batch=batch)
    pins = ti.pin_shapes(batches)
    # serving answers 1-term head queries on the host before planning
    plans = [ti.plan_sparse(ti._shortcut_single_heavy(b, 10)[0])
             for b in batches]
    dcfg = ti.config.device
    K = 10
    st = dict(
        n_slots=ti.n_slots, K=K, K2=min(max(2 * K, dcfg.rescore_margin),
                                        ti.n_slots),
        C=max(ti._chunk_budget(p[1], blk) for p, _u in plans),
        L2=max(ti._light_budget(p) for p, _u in plans), U=plans[0][1],
        block=blk, bs_steps=ti._bs_depth, nd=ti.n_dense, nl=ti.n_light,
        guard_eps=dcfg.fast_heavy_eps,
    )
    print(f"[prof] {seg.N} docs n_dense={ti.n_dense} n_slots={ti.n_slots} "
          f"pins={pins} bs_steps={ti._bs_depth} C={st['C']} U={st['U']} "
          f"T={plans[0][0].shape[2]}", file=sys.stderr, flush=True)
    dev_plans = [torch.from_numpy(p).to(device) for p, _u in plans]
    sorted_entries = [unified_entries(ti.post_doc, ti.post_score, p,
                                      C=st["C"], block=blk, n_slots=ti.n_slots)
                      for p in dev_plans]
    results = {}
    for name in names:
        it = iter(range(10 ** 9))

        def call(name=name, it=it):
            i = next(it) % len(dev_plans)
            return variant_unified(
                ti.post_doc, ti.post_score, ti.dense_rows, ti.light_bucket_pos,
                dev_plans[i], sorted_entries=sorted_entries[i],
                **st, **VARIANTS[name])

        results[name] = time_variant(call, device)
        print(f"[prof] {name}: {results[name]} ms/batch (span, device)",
              file=sys.stderr, flush=True)
    stage_table(results, "unified serving-point stage attribution")
    print(json_line("unified", card, batch, results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
