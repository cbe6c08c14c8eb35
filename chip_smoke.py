#!/usr/bin/env python3
"""Smoke run of the torch port's sparse BM25 search path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each timed; any failure exits
non-zero before the last line:

1. device: require CUDA, print the card's name and power limit, build the
   CUDA kernels from nextsearch_tpu_torch/csrc/heavy.cu (one nvcc).
2. index: the bench corpus (1M docs, 200k-term Zipf vocabulary) and a
   TorchIndex at the bench configuration (posting_block 64, dense ratio
   1/1024, 7 GiB dense rows, heavy bucket 512, K2 margin 32), pinned on the
   batch-512 envelope.
3. kernels: each kernel against its plain PyTorch version on operands of a
   real batch-512 plan (K2/K3/K4 bit-exact; K1 cnt bit-exact, H and
   smax within rtol 1e-6 because the fp32 sums run in another order than
   cuBLAS's; K5 cnt bit-exact, totals and smax within rtol 2e-6), with
   median times beside the plain versions' and the measured relative error
   of fast (one-pass bf16) H against exact H. Then the probe kernels at the
   probes' shapes: K6 (fast with f32 H, fast with bf16-up H, exact over a
   bf16 table) and each P6 variant at probe_fusedmm's (Q 512, uc 384,
   n_slots 999,424, bf16 table), cnt bit-exact, H and smax within
   2 * uc * 2^-24 relative (two orders of a uc-term positive sum), a bf16
   H bit-equal to the rounding of the kernel's own f32 H; P1-P5 at
   mosaic_probe's on seeded random operands, plus a [37, 300] transpose,
   as benchmarks/kernel_probe.py holds them.
4. main path: batch 512 / k 10 through search_batch_async /
   search_batch_gather, the launch counters reset before each launch and
   read after it, each launch spot-checked bit-exact against the oracle:
   (a) the guarded fast launch, (b) fast_heavy off (compact exact), (c) a
   forced guard trip that relaunches the full-table exact kernel, (d) the
   unified launch (unified=True, K5) guarded fast, (e) unified exact, (f)
   unified with a forced trip (relaunching the packed full-table kernel),
   (g) the windowed selection kernel (NEXTSEARCH_SELECT_PALLAS=1, K4)
   guarded fast, (h) K4 compact exact. Then 5 s pipelined loops at depth
   2 on the default path, under unified and under K4.
5. bf16 rows: the f32 index is freed and a TorchIndex with
   dense_rows_bf16 is built over the same corpus and configuration; (i)
   the compact launch (K3 over bf16 rows, K1 exact), (j) the full-table
   launch, (k) the unified launch, and (l) one launch of
   nextsearch_tpu_torch/benchmarks/profile_sparse.py's "full" variant (K6
   over the full table, v2 rescore) are each held to the bf16 gate: every
   returned score bit-equal to the oracle's score for that doc, `found`
   equal, and the doc list equal unless the oracle's top K2+1 scores hold
   two within 2^-8 relative of each other (the false-tie class of
   config.py's dense_rows_bf16 note), and then only inside the band that
   bf16 rows' rounding allows (see bf16_gate); such exempt queries are
   counted.
   Then a 5 s loop at depth 2.
6. probe paths: benchmarks/kernel_probe.py (P1-P5, all PASS) and one
   short run of benchmarks/probe_fusedmm.py (K6 and every P6 variant).
7. server: a small on-disk index served over HTTP by the port's Engine;
   /api/search answers must match the oracle and run K1 and K2.

Every path's launches are counted from zero just before it and read just
after; a kernel of the path that never launched fails the run.

The line before the last is a JSON object of the kernels' launch counts,
errors and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
N_DOCS = 1_000_000
VOCAB = 200_000
BATCH = 512
K = 10
K2 = 32  # the bench configuration's candidate pool: max(2K, rescore margin)
SPOT = 32  # queries per launch checked against the oracle


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0

    def done(self, name: str) -> None:
        now = time.perf_counter()
        say(f"phase {name}: {now - self.last:.1f}s")
        self.last = now


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timed(fn, device, reps: int) -> float:
    """Median milliseconds of fn() over reps runs (CUDA events on a card,
    the host clock in a CPU rehearsal)."""
    from nextsearch_tpu_torch.benchmarks.common import event_ms

    if device.type == "cuda":
        return event_ms(fn, reps)
    fn()  # warm
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def build_index(device, n_docs: int, vocab: int, batch: int, n_batches: int,
                **device_fields):
    """Bench corpus (artifact-cached under the temp dir), TorchIndex at the
    bench configuration (with device_fields on top), and batch-envelope
    pins from the query stream."""
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.benchmarks.common import bench_corpus
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import sample_queries

    seg, probs = bench_corpus(n_docs, vocab)
    say(f"corpus: {n_docs} docs, {vocab} terms, {seg.num_postings} postings")
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, heavy_buckets=(512,),
        dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30, rescore_margin=32,
        **device_fields,
    ))
    batches = sample_queries(probs, n_queries=n_batches * batch, batch=batch)
    ti = TorchIndex([seg], config=cfg, device=device)
    pins = ti.pin_shapes(batches, scope_q=True)
    say(f"index{' ' + str(device_fields) if device_fields else ''}: "
        f"n_slots={ti.n_slots} n_dense={ti.n_dense} n_light={ti.n_light} "
        f"bs_depth={ti._bs_depth} pins={pins}")
    return seg, ti, batches


def check_kernels(ti, batch, device, reps: int):
    """Each kernel against its plain version on one real plan's operands."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops.bm25_sparse import heavy_operands

    plan, U = ti.plan_sparse(ti._shortcut_single_heavy(batch, K)[0])
    plan = torch.as_tensor(plan, device=device)
    rows = ti.dense_rows.shape[0]
    mix_c, ids = heavy_operands(plan, rows, nd=ti.n_dense, U=U, use_compact=True)
    mix_f, _ = heavy_operands(plan, rows, nd=ti.n_dense, U=U, use_compact=False)
    table = ti.dense_rows
    say(f"kernel shapes: Q={plan.shape[1]} uc={ids.numel()} rows={rows} "
        f"n_slots={ti.n_slots}")
    out = {}

    for name, fn, ref, dt in (
        ("gather_rows_bf16", hk.gather_rows_bf16, hk.gather_rows_bf16_ref,
         torch.int16),
        ("gather_rows", hk.gather_rows, hk.gather_rows_ref, torch.int32),
    ):
        got, exp = fn(ids, table), ref(ids, table)
        if not torch.equal(got.view(dt), exp.view(dt)):
            raise AssertionError(f"{name} is not bit-exact")
        out[name] = dict(
            max_abs_err=float((got.float() - exp.float()).abs().max()),
            ms=timed(lambda: fn(ids, table), device, reps),
            plain_ms=timed(lambda: ref(ids, table), device, reps),
        )
        del got, exp
    t_bf16 = hk.gather_rows_bf16(ids, table)
    t_f32 = hk.gather_rows(ids, table)

    def k1(mix, tab, fast):
        got = hk.heavy_fused3(mix, tab, fast=fast)
        exp = hk.heavy_fused3_ref(mix, tab, fast=fast)
        h, smax, cnt = got
        q, n = h.shape
        n_sub, n_tiles = n // 128, n // 2048
        if not torch.equal(cnt, exp[2]):
            raise AssertionError(f"K1 fast={fast}: cnt differs")
        if not torch.equal(smax[:n_sub], h.view(q, n_sub, 128).amax(2).T):
            raise AssertionError(f"K1 fast={fast}: smax != max of own H")
        if not (torch.all(smax[n_sub:] == float("-inf"))
                and torch.all(cnt[n_tiles:] == 0)):
            raise AssertionError(f"K1 fast={fast}: padding rows")
        if not torch.equal(h > 0, exp[0] > 0):
            raise AssertionError(f"K1 fast={fast}: positivity differs")
        err = 0.0
        for a, b in ((h, exp[0]), (smax[:n_sub], exp[1][:n_sub])):
            diff = (a - b).abs()
            tol = 1e-6 * b.abs()
            if bool((diff > tol).any()):
                raise AssertionError(
                    f"K1 fast={fast}: max rel err "
                    f"{float((diff / b.abs().clamp_min(1e-30)).max()):.3g}"
                )
            err = max(err, float(diff.max()))
        del exp, diff, tol
        return got, err

    (h_fast, _, _), err_fast = k1(mix_c, t_bf16, True)
    (h_exact_c, _, _), _ = k1(mix_c, t_f32, False)
    pos = h_exact_c > 0
    rel = ((h_fast - h_exact_c).abs()[pos] / h_exact_c[pos]).max()
    say(f"fast H vs exact H (compact, 1M shapes): max rel err {float(rel):.6g} "
        f"(guard eps {ti.config.device.fast_heavy_eps})")
    del h_fast, h_exact_c, pos
    _, err_exact = k1(mix_f, table, False)
    out["heavy_fused3"] = dict(
        max_abs_err=err_fast,
        ms=timed(lambda: hk.heavy_fused3(mix_c, t_bf16, fast=True), device, reps),
        plain_ms=timed(lambda: hk.heavy_fused3_ref(mix_c, t_bf16, fast=True),
                       device, reps),
        exact_full_max_abs_err=err_exact,
        exact_full_ms=timed(lambda: hk.heavy_fused3(mix_f, table, fast=False),
                            device, max(2, reps // 2)),
        exact_full_plain_ms=timed(
            lambda: hk.heavy_fused3_ref(mix_f, table, fast=False), device,
            max(2, reps // 2)),
        fast_vs_exact_h_max_rel_err=float(rel),
    )
    del t_f32
    out["unified_fused"] = check_unified(ti, plan, mix_c, ids, device, reps)
    out["per_query_topk"] = check_select(ti, plan, mix_c, t_bf16, device, reps)
    for name, v in out.items():
        say(f"kernel {name}: " + " ".join(f"{k}={x:.6g}" for k, x in v.items()))
    return out


def _bits(t):
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _heavy_check(label, got, exp, rtol):
    """K6/P6 outputs against the plain version's: cnt bit-exact, the same
    smax padding, H (f32) and finite smax within rtol; returns the max abs
    error."""
    import torch

    h, smax, cnt = got
    if not torch.equal(cnt, exp[2]):
        raise AssertionError(f"{label}: cnt differs")
    fin = torch.isfinite(exp[1])
    if not torch.equal(torch.isfinite(smax), fin):
        raise AssertionError(f"{label}: smax padding differs")
    pairs = [(smax[fin], exp[1][fin])]
    if h.dtype == torch.float32:
        pairs.append((h, exp[0]))
    return _rel_check(label, pairs, rtol)


def check_probe_kernels(device, reps: int, shape: dict):
    """K6 and P6 at probe_fusedmm's shapes, P1-P5 at mosaic_probe's, each
    against its plain version, with median times."""
    import torch

    from nextsearch_tpu_torch.benchmarks import kernel_probe, probe_fusedmm
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    bf16 = torch.bfloat16
    mix, dense = probe_fusedmm.operands(device, **shape)
    q, uc = mix.shape
    n_sub = dense.shape[1] // 128
    rtol = 2 * uc * 2.0 ** -24  # two orders of a uc-term positive sum
    say(f"probe shapes: Q={q} uc={uc} n_slots={dense.shape[1]} bf16 table, "
        f"rtol {rtol:.3g}")
    out = {}
    f32 = hk.heavy_fused(mix, dense, fast=True)
    err = _heavy_check("K6 fast", f32, hk.heavy_fused_ref(mix, dense, fast=True),
                       rtol)
    if not torch.equal(f32[1][:n_sub], f32[0].view(q, n_sub, 128).amax(2).T):
        raise AssertionError("K6: smax != max of own H")
    up = hk.heavy_fused(mix, dense, fast=True, h_dtype=bf16)
    if not (torch.equal(_bits(up[0]), _bits(hk.round_up_bf16(f32[0])))
            and torch.equal(up[1], f32[1]) and torch.equal(up[2], f32[2])):
        raise AssertionError("K6 bf16-up H != round-up of its own f32 H")
    exact = hk.heavy_fused(mix, dense, fast=False)
    err = max(err, _heavy_check("K6 exact (bf16 table)", exact,
                                hk.heavy_fused_ref(mix, dense, fast=False), rtol))
    # over a bf16 table both modes round mix and multiply bf16 values
    if not torch.equal(exact[0], f32[0]):
        raise AssertionError("K6 exact and fast differ over a bf16 table")
    del up, exact
    out["heavy_fused"] = dict(
        max_abs_err=err,
        ms=timed(lambda: hk.heavy_fused(mix, dense, fast=True), device, reps),
        plain_ms=timed(lambda: hk.heavy_fused_ref(mix, dense, fast=True),
                       device, reps),
        bf16_up_ms=timed(lambda: hk.heavy_fused(mix, dense, fast=True,
                                                h_dtype=bf16), device, reps),
        bf16_up_plain_ms=timed(lambda: hk.heavy_fused_ref(
            mix, dense, fast=True, h_dtype=bf16), device, reps),
        exact_ms=timed(lambda: hk.heavy_fused(mix, dense, fast=False),
                       device, reps),
        exact_plain_ms=timed(lambda: hk.heavy_fused_ref(mix, dense, fast=False),
                             device, reps),
    )
    p6, err = {}, 0.0
    for label, kw in probe_fusedmm.VARIANTS.items():
        got = hk.heavy_fused_variant(mix, dense, **kw)
        err = max(err, _heavy_check(f"P6 {label}", got,
                                    hk.heavy_fused_variant_ref(mix, dense, **kw),
                                    rtol))
        if got[0].dtype == bf16 and not torch.equal(
                _bits(got[0]), _bits(f32[0].to(bf16))):
            raise AssertionError("P6 bf16 H != nearest bf16 of the f32 H")
        if kw.get("store_h") is False and bool(got[0].any()):
            raise AssertionError("P6 no H store: H is not zero")
        if not kw and not torch.equal(got[0], f32[0]):
            raise AssertionError("P6 full variant's H differs from K6's")
        del got
        key = "_".join(f"{k}_{v}" for k, v in kw.items()).replace(
            "torch.bfloat16", "bf16") or "full"
        p6[f"{key}_ms"] = timed(lambda kw=kw: hk.heavy_fused_variant(
            mix, dense, **kw), device, reps)
        p6[f"{key}_plain_ms"] = timed(lambda kw=kw: hk.heavy_fused_variant_ref(
            mix, dense, **kw), device, reps)
    del f32
    out["heavy_fused_variant"] = dict(max_abs_err=err, ms=p6["full_ms"],
                                      plain_ms=p6["full_plain_ms"], **p6)
    args = kernel_probe.inputs(device)
    for name, (label, kern, plain, tol) in kernel_probe.calls(args).items():
        out[name] = dict(max_abs_err=kernel_probe.check(kern(), plain(), tol),
                         ms=timed(kern, device, reps),
                         plain_ms=timed(plain, device, reps))
    wide = out.pop("transpose_wide")
    out["transpose"].update({f"wide_{k}": v for k, v in wide.items()})
    for name, v in out.items():
        say(f"kernel {name}: " + " ".join(f"{k}={x:.6g}" for k, x in v.items()))
    return out


def _rel_check(label, pairs, rtol):
    """Max abs error over (got, expected) pairs; raises past rtol."""
    err = 0.0
    for a, b in pairs:
        if a.numel() == 0:
            continue
        diff = (a - b).abs()
        if bool((diff > rtol * b.abs()).any()):
            raise AssertionError(
                f"{label}: max rel err "
                f"{float((diff / b.abs().clamp_min(1e-30)).max()):.3g}")
        err = max(err, float(diff.max()))
    return err


def check_unified(ti, plan, mix_c, ids, device, reps):
    """K5 against its plain version on the plan's light entries and compact
    tables, in both modes: cnt bit-exact, totals and smax within 2e-6."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops.bm25_sparse import unified_entries

    block = ti.config.device.posting_block
    C = ti._chunk_budget(plan[1].cpu().numpy(), block)
    sd, sq, sv = unified_entries(ti.post_doc, ti.post_score, plan, C=C,
                                 block=block, n_slots=ti.n_slots)
    say(f"K5 entries: {sd.numel()} lanes, "
        f"{int((sd < ti.n_slots).sum())} live")
    err = 0.0
    for fast, gather in ((True, hk.gather_rows_bf16), (False, hk.gather_rows)):
        table = gather(ids, ti.dense_rows)
        tot, smax, cnt = hk.unified_fused(mix_c, table, sd, sq, sv, fast=fast)
        again = hk.unified_fused(mix_c, table, sd, sq, sv, fast=fast)
        exp = hk.unified_fused_ref(mix_c, table, sd, sq, sv, fast=fast)
        q, n = tot.shape
        n_sub, n_tiles = n // 128, n // 2048
        if not all(torch.equal(a, b) for a, b in zip((tot, smax, cnt), again)):
            raise AssertionError(f"K5 fast={fast}: two launches differ")
        if not torch.equal(cnt, exp[2]):
            raise AssertionError(f"K5 fast={fast}: cnt differs")
        if not torch.equal(tot > 0, exp[0] > 0):
            raise AssertionError(f"K5 fast={fast}: positivity differs")
        if not torch.equal(smax[:n_sub], tot.view(q, n_sub, 128).amax(2).T):
            raise AssertionError(f"K5 fast={fast}: smax != max of own totals")
        if not (bool((smax[n_sub:] == float("-inf")).all())
                and bool((cnt[n_tiles:] == 0).all())):
            raise AssertionError(f"K5 fast={fast}: padding rows")
        err = max(err, _rel_check(f"K5 fast={fast}", (
            (tot, exp[0]), (smax[:n_sub], exp[1][:n_sub])), 2e-6))
        del tot, smax, cnt, again, exp
        if fast:
            times = dict(
                ms=timed(lambda: hk.unified_fused(mix_c, table, sd, sq, sv,
                                                  fast=True), device, reps),
                plain_ms=timed(lambda: hk.unified_fused_ref(
                    mix_c, table, sd, sq, sv, fast=True), device, reps),
            )
        del table
    return dict(max_abs_err=err, **times)


def check_select(ti, plan, mix_c, t_bf16, device, reps):
    """K4 against its plain version on the plan's light selection scores
    (light totals + fast H at each (q, doc)): bit-exact."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import select_kernels as sk
    from nextsearch_tpu_torch.ops.bm25_sparse import light_totals

    plan_np = plan.cpu().numpy()
    with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1"):
        w_max = ti._sel_window(plan_np[1])
    block = ti.config.device.posting_block
    q = plan.shape[1]
    h, _smax, _cnt = hk.heavy_fused3(mix_c, t_bf16, fast=True)
    sq, sd, stot, last = light_totals(
        ti.post_doc, ti.post_score, plan[0], plan[1],
        plan[5].contiguous().view(torch.float32),
        C=ti._chunk_budget(plan_np[1], block), block=block, Q=q,
        n_slots=ti.n_slots,
    )
    hval = h[sq.clamp(0, q - 1), sd.clamp(0, ti.n_slots - 1)]
    sel = torch.where(last & (sq < q), stot + hval, torch.zeros((), device=device))
    del h, hval
    bounds = torch.searchsorted(sq, torch.arange(q + 1, dtype=sq.dtype,
                                                 device=device))
    k2 = max(2 * K, ti.config.device.rescore_margin)  # the path's K2
    wins = (bounds[1:] - bounds[:-1]).cpu()
    say(f"K4 operands: {sel.numel()} lanes, w_max={w_max}, longest window "
        f"{int(wins.max())}, k2={k2}")
    exp = sk.per_query_topk_ref(sel, bounds, k2)
    got = sk.per_query_topk(sel, bounds, k2)
    if not (torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])):
        raise AssertionError("K4 differs from plain")
    return dict(
        max_abs_err=float((got[0] - exp[0]).abs().max()),
        ms=timed(lambda: sk.per_query_topk(sel, bounds, k2), device, reps),
        plain_ms=timed(lambda: sk.per_query_topk_ref(sel, bounds, k2),
                       device, reps),
    )


def spot_check(ti, oracle_segs, queries, results, memo):
    """Results equal the oracle: f32 scores, (segment, doc), found."""
    import numpy as np

    from nextsearch_tpu.index.oracle import oracle_search

    for terms, res in zip(queries, results):
        key = tuple(terms)
        if key not in memo:
            memo[key] = oracle_search(oracle_segs, terms, k=K)
        hits, found = memo[key]
        if res.found != found or len(res.scores) != len(hits):
            raise AssertionError(f"oracle mismatch (found/len) for {terms}")
        for (o_s, o_seg, o_doc), d_s, slot in zip(hits, res.scores, res.doc_slots):
            if ti.locate(int(slot)) != (o_seg, o_doc) or \
                    np.float32(d_s) != np.float32(o_s):
                raise AssertionError(f"oracle mismatch (hit) for {terms}")


# name -> the TPU kernel it replaces; every kernel's CUDA source is SOURCE
SOURCE = "nextsearch_tpu_torch/csrc/heavy.cu"
KERNELS = {
    "heavy_fused3": "nextsearch_tpu/ops/heavy_pallas.py:706",
    "gather_rows_bf16": "nextsearch_tpu/ops/heavy_pallas.py:611",
    "gather_rows": "nextsearch_tpu/ops/heavy_pallas.py:537",
    "per_query_topk": "nextsearch_tpu/ops/select_pallas.py:218",
    "unified_fused": "nextsearch_tpu/ops/heavy_pallas.py:389",
    "heavy_fused": "nextsearch_tpu/ops/heavy_pallas.py:115",
    "gather_bf16_rows": "nextsearch_tpu/ops/heavy_pallas.py:537",
    "heavy_fused_variant": "benchmarks/probe_fusedmm.py:57",
    "nt_dot": "benchmarks/mosaic_probe.py:45",
    "row_copy": "benchmarks/mosaic_probe.py:63",
    "window_op": "benchmarks/mosaic_probe.py:95",
    "reshape_copy": "benchmarks/mosaic_probe.py:117",
    "transpose": "benchmarks/mosaic_probe.py:129",
}
PROBES = ("nt_dot", "row_copy", "window_op", "reshape_copy", "transpose")


def _wrappers():
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import probe_kernels as pk
    from nextsearch_tpu_torch.ops import select_kernels as sk

    module = {"per_query_topk": sk, **dict.fromkeys(PROBES, pk)}
    return {name: getattr(module.get(name, hk), name) for name in KERNELS}


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, by name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def launched(counts: dict) -> dict:
    """The nonzero entries of a launch count: what a path ran."""
    return {k: v for k, v in counts.items() if v}


def serving_loop(ti, batches, device, secs: float, label: str, card: str):
    """Depth-2 pipelined loop over the stream's batches (batch 0 is the
    spot-check batch); returns the launch counts it made and its QPS and
    p50 milliseconds."""
    import numpy as np
    import torch

    trips0, rel0 = ti.rescue_trips, ti.relaunches
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ti.search_batch(batches[1], k=K)  # warm
    reset_counts()
    window, lat, done, i = [], [], 0, 1
    t0 = time.perf_counter()
    while True:
        b0 = time.perf_counter()
        batch = batches[1 + i % (len(batches) - 1)]
        window.append((b0, ti.search_batch_async(batch, k=K)))
        if len(window) > 2:
            s0, h = window.pop(0)
            ti.search_batch_gather(h)
            lat.append(time.perf_counter() - s0)
            done += BATCH
        i += 1
        if time.perf_counter() - t0 >= secs and done:
            break
    while window:
        s0, h = window.pop(0)
        ti.search_batch_gather(h)
        lat.append(time.perf_counter() - s0)
        done += BATCH
    el = time.perf_counter() - t0
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    qps, p50 = done / el, float(np.median(lat)) * 1e3
    say(f"[{card}] serving loop {label}: batch {BATCH} depth 2 k {K}: "
        f"qps={qps:.1f} p50_ms={p50:.2f} "
        f"batches={len(lat)} host_rescued_queries={ti.rescue_trips - trips0} "
        f"relaunched_batches={ti.relaunches - rel0} peak_allocated={peak} "
        f"launches {launched(counts)}")
    return counts, dict(qps=qps, p50_ms=p50)


def _config(ti, cfg, **device_fields):
    ti.config = replace(cfg, device=replace(cfg.device, **device_fields))


def main_path(ti, oracle_segs, batches, device, loop_secs: float, card: str):
    """Launches (a)-(h), then the pipelined loops; returns each kernel's
    launch count summed over all of them."""
    memo: dict = {}
    spot = batches[0]
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, c in counts.items():
            total[name] += c

    def run(label, *expect):
        reset_counts()
        t = time.perf_counter()
        res = ti.search_batch(spot, k=K)
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        spot_check(ti, oracle_segs, spot[:SPOT], res[:SPOT], memo)
        if counts not in expect:
            raise AssertionError(f"{label}: launches {counts} not in {expect}")
        add(counts)
        say(f"launch {label}: {dt * 1e3:.1f} ms, {SPOT} queries oracle-exact, "
            f"launches {counts}")

    cfg = ti.config
    config = lambda **kw: _config(ti, cfg, **kw)  # noqa: E731

    def tripped(label, *expect):
        r0 = ti.relaunches
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="0"):
            run(label, *expect)
        if ti.relaunches != r0 + 1:
            raise AssertionError(f"{label}: did not relaunch")

    k1, k2, k3, k4, k5 = ("heavy_fused3", "gather_rows_bf16", "gather_rows",
                          "per_query_topk", "unified_fused")
    try:
        # more than 8 tripped queries relaunch the batch exactly (K1 again)
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            trips0 = ti.rescue_trips
            run("(a) guarded fast", {k1: 1, k2: 1}, {k1: 2, k2: 1})
            if ti.rescue_trips != trips0:
                say(f"(a) host-rescued {ti.rescue_trips - trips0} queries")
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(b) compact exact", {k1: 1, k3: 1})
        config(fast_heavy_eps=1e9)
        tripped("(c) tripped -> full-table exact relaunch", {k1: 2, k2: 1})
        config(unified=True)
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            run("(d) unified guarded fast", {k2: 1, k5: 1},
                {k1: 1, k2: 1, k5: 1})
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(e) unified exact", {k3: 1, k5: 1})
        config(unified=True, fast_heavy_eps=1e9)
        tripped("(f) unified tripped -> packed full-table exact relaunch",
                {k1: 1, k2: 1, k5: 1})
        config()
        with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1",
                             NEXTSEARCH_TRIP_RESCUE="8"):
            run("(g) K4 guarded fast", {k1: 1, k2: 1, k4: 1},
                {k1: 2, k2: 1, k4: 2})
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(h) K4 compact exact", {k1: 1, k3: 1, k4: 1})
        add(serving_loop(ti, batches, device, loop_secs, "default", card)[0])
        config(unified=True)
        add(serving_loop(ti, batches, device, loop_secs, "unified", card)[0])
        config()
        with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1"):
            add(serving_loop(ti, batches, device, loop_secs, "K4", card)[0])
    finally:
        ti.config = cfg
    hbm = ti.hbm_bytes()
    say(f"[{card}] index bytes: " + " ".join(f"{k}={v}" for k, v in hbm.items()))
    for name in (k1, k2, k3, k4, k5):
        if total[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    return total


def oracle_table(oseg, terms):
    """One query's oracle: its top K2 + 1 hits and found count
    (oracle_search_vec), and every doc's f32 score, accumulated as the
    oracle accumulates (term order, multiply then add)."""
    import numpy as np

    from nextsearch_tpu.index.oracle import oracle_posting_scores, oracle_search_vec

    hits, found = oracle_search_vec([oseg], terms, k=K2 + 1)
    score = np.zeros(oseg["N"], np.float32)
    for term, w in terms:
        entry = oseg["postings"].get(term)
        if entry is None or len(entry[0]) == 0:
            continue
        doc_ids, tfs = entry
        s = oracle_posting_scores(oseg["N"], oseg["avgdl"], len(doc_ids), tfs,
                                  oseg["doc_len"][doc_ids])
        score[doc_ids] = score[doc_ids] + np.float32(w) * s
    if any(np.float32(sc) != score[d] for sc, _g, d in hits):
        raise AssertionError(f"oracle score table disagrees for {terms}")
    return hits, found, score


def bf16_gate(ti, oseg, queries, results, memo):
    """The bf16-rows gate: every returned score bit-equal to the oracle's
    score for that doc and `found` equal; the doc list equal unless the
    oracle's top K2 + 1 scores hold two within 2^-8 relative of each other
    (the false-tie class of bf16 rows). Even then a list may differ only
    inside the swap band: no oracle top-K doc it lacks scores above SWAP
    times its K-th score, and none of its scores is below the oracle's K-th
    over SWAP. Returns (queries in that class, queries whose doc list
    differed there)."""
    import numpy as np

    # The candidate preselection reads bf16 rows: each doc's score there is
    # within 2^-8 relative of its true score (row values rounded to
    # nearest; the query weights, 1.0, are exact in bf16; light terms are
    # exact). A true top-K doc drops out of the K2 pool only behind K2 docs
    # preselected above it, each with a true score at least its own over
    # SWAP, and so at least the oracle's K-th over SWAP.
    swap = (1 + 2.0 ** -8) / (1 - 2.0 ** -8)
    near_ties = exempt = 0
    for terms, res in zip(queries, results):
        key = tuple(terms)
        if key not in memo:
            memo[key] = oracle_table(oseg, terms)
        hits, found, score = memo[key]
        if res.found != found:
            raise AssertionError(f"bf16 gate: found {res.found} != {found} "
                                 f"for {terms}")
        docs = [ti.locate(int(s))[1] for s in res.doc_slots]
        if any(np.float32(v) != score[d] for v, d in zip(res.scores, docs)):
            raise AssertionError(f"bf16 gate: a score is not the oracle's "
                                 f"for {terms}")
        top = [np.float32(h[0]) for h in hits]
        near = any(a - b <= np.float32(2.0 ** -8) * a
                   for a, b in zip(top, top[1:]))
        near_ties += near
        want = [d for _s, _g, d in hits[:K]]
        if docs != want:
            if not near or len(docs) != len(want) or len(set(docs)) != len(docs):
                raise AssertionError(f"bf16 gate: doc list differs for {terms}")
            kth_ret = min(float(v) for v in res.scores)
            kth_oracle = float(hits[len(want) - 1][0])
            lost = set(want) - set(docs)
            if any(float(score[d]) > swap * kth_ret for d in lost) or \
                    kth_ret * swap < kth_oracle:
                raise AssertionError(f"bf16 gate: doc list differs outside "
                                     f"the swap band for {terms}")
            exempt += 1
    return near_ties, exempt


def unpack(out, nq: int):
    """QueryResults of a packed [Q, 2K+1] launch output."""
    from nextsearch_tpu.index.segment import QueryResult

    out = out.cpu().numpy()
    res = []
    for qi in range(nq):
        keep = out[qi, :K] > 0
        res.append(QueryResult(scores=out[qi, :K][keep],
                               doc_slots=out[qi, K:2 * K].astype("int32")[keep],
                               found=int(out[qi, 2 * K])))
    return res


def bf16_phase(oseg, device, n_docs, vocab, n_batches, loop_secs, card, reps):
    """The bf16-dense-rows index: its kernels at its shapes, launches
    (i)-(l) under the bf16 gate, and a loop. Returns (launch totals, kernel
    checks, numbers)."""
    import torch

    from nextsearch_tpu_torch.benchmarks import profile_sparse as ps
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops.bm25_sparse import heavy_operands

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _seg, ti, batches = build_index(device, n_docs, vocab, BATCH, n_batches,
                                    dense_rows_bf16=True)
    hbm = ti.hbm_bytes()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    say(f"[{card}] bf16 rows index: n_dense={ti.n_dense} bytes: "
        + " ".join(f"{k}={v}" for k, v in hbm.items())
        + f" peak_allocated={peak}")
    spot = batches[0]

    # K3 over bf16 rows and K1 exact over its bf16 compact table (mix
    # rounded to bf16), at this index's shapes
    plan, U = ti.plan_sparse(spot)
    plan = torch.as_tensor(plan, device=device)
    mix_c, ids = heavy_operands(plan, ti.dense_rows.shape[0], nd=ti.n_dense,
                                U=U, use_compact=True)
    got = hk.gather_bf16_rows(ids, ti.dense_rows)
    if not torch.equal(_bits(got), _bits(hk.gather_rows_ref(ids, ti.dense_rows))):
        raise AssertionError("K3 over bf16 rows is not bit-exact")
    kern = {"gather_bf16_rows": dict(
        max_abs_err=0.0,
        ms=timed(lambda: hk.gather_bf16_rows(ids, ti.dense_rows), device, reps),
        plain_ms=timed(lambda: hk.gather_rows_ref(ids, ti.dense_rows), device,
                       reps))}
    k1 = hk.heavy_fused3(mix_c, got, fast=False)
    err = _heavy_check("K1 exact over bf16 rows", k1,
                       hk.heavy_fused3_ref(mix_c, got, fast=False), 1e-6)
    kern["heavy_fused3_bf16_rows"] = dict(
        max_abs_err=err,
        ms=timed(lambda: hk.heavy_fused3(mix_c, got, fast=False), device, reps),
        plain_ms=timed(lambda: hk.heavy_fused3_ref(mix_c, got, fast=False),
                       device, reps))
    say(f"K3/K1 over bf16 rows: uc={ids.numel()} " + " ".join(
        f"{n}.{k}={x:.6g}" for n, v in kern.items() for k, x in v.items()))
    del got, k1, mix_c, ids

    memo: dict = {}
    total = dict.fromkeys(KERNELS, 0)
    info = dict(n_dense=ti.n_dense, hbm_bytes=hbm["total"], peak_allocated=peak)

    def run(label, expect, launch):
        reset_counts()
        t = time.perf_counter()
        res = launch()
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        near, exempt = bf16_gate(ti, oseg, spot[:SPOT], res[:SPOT], memo)
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts} != {expect}")
        for name, c in counts.items():
            total[name] += c
        info[label.split()[0] + "_exempt"] = exempt
        say(f"launch {label}: {dt * 1e3:.1f} ms, {SPOT} queries pass the bf16 "
            f"gate ({near} in the near-tie class, {exempt} of them exempted), "
            f"launches {counts}")

    cfg = ti.config
    search = lambda: ti.search_batch(spot, k=K)  # noqa: E731
    try:
        run("(i) bf16 rows compact exact",
            {"heavy_fused3": 1, "gather_bf16_rows": 1}, search)
        with mock.patch.dict(os.environ, NEXTSEARCH_COMPACT_HEAVY="0"):
            run("(j) bf16 rows full-table exact", {"heavy_fused3": 1}, search)
        _config(ti, cfg, unified=True)
        run("(k) bf16 rows unified", {"unified_fused": 1, "gather_bf16_rows": 1},
            search)
    finally:
        ti.config = cfg
    raw = ti.plan_sparse(spot)[0]  # profile_sparse plans without shortcuts
    C = ps.chunk_budget(ti, [raw])
    raw = torch.as_tensor(raw, device=device)
    run("(l) profile_sparse full (K6, v2)", {"heavy_fused": 1},
        lambda: unpack(ps.launch(ti, raw, C), len(spot)))
    counts, perf = serving_loop(ti, batches, device, loop_secs, "bf16 rows",
                                card)
    for name, c in counts.items():
        total[name] += c
    info.update(perf)
    del ti
    return total, kern, info


def probe_paths(device, shape: dict):
    """benchmarks/kernel_probe.py (P1-P5) and a short
    benchmarks/probe_fusedmm.py run (K6, P6), each counted from zero."""
    from nextsearch_tpu_torch.benchmarks import kernel_probe, probe_fusedmm

    total = dict.fromkeys(KERNELS, 0)
    reset_counts()
    passed = kernel_probe.run(device)
    counts = launched(launch_counts())
    want = {**dict.fromkeys(PROBES, 1), "transpose": 2}
    if not all(passed.values()) or counts != want:
        raise AssertionError(f"kernel_probe: {passed}, launches {counts}")
    for name, c in counts.items():
        total[name] += c
    reset_counts()
    probe_fusedmm.run(device, reps=2, **shape)
    counts = launched(launch_counts())
    n_var = len(probe_fusedmm.VARIANTS)
    if counts != {"heavy_fused": 3, "heavy_fused_variant": 3 * n_var}:
        raise AssertionError(f"probe_fusedmm: launches {counts}")
    for name, c in counts.items():
        total[name] += c
    say(f"probe paths: kernel_probe all PASS, probe_fusedmm ran; launches "
        f"{launched(total)}")
    return total


def server_phase(device):
    """Port Engine + reference HTTP front over a small on-disk index."""
    import http.client

    import numpy as np

    from nextsearch_tpu.api.ai import AzureOpenAIConfig
    from nextsearch_tpu.api.feedback import FeedbackManager
    from nextsearch_tpu.api.server import ServerContext, make_server
    from nextsearch_tpu.api.stats import StatsTracker
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu.index.builder import build_segment_arrays
    from nextsearch_tpu.index.oracle import oracle_search
    from nextsearch_tpu.index.segmentio import save_manifest, write_segment
    from nextsearch_tpu_torch.engine import Engine
    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    r = np.random.default_rng(5)
    vocab = 600
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    docs = [{"cord_uid": f"doc{i:05d}",
             "tokens": [f"w{t:04d}" for t in r.choice(vocab, size=int(r.poisson(50)) + 1, p=p)]}
            for i in range(3000)]
    seg = build_segment_arrays(docs)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "index"
        (d / "segments").mkdir(parents=True)
        write_segment(seg, d / "segments" / "seg_000001")
        save_manifest(d / "manifest.bin", ["seg_000001"])
        cfg = EngineConfig(device=DeviceConfig(mode="sparse", dense_df_ratio=1 / 64))
        eng = Engine(d, config=cfg, cache_dir=Path(tmp), device=device)
        if not eng.reload() or eng.index.n_dense == 0:
            raise AssertionError("server index: reload failed or no dense rows")
        ctx = ServerContext(eng, StatsTracker(Path(tmp) / "stats.json"),
                            FeedbackManager(Path(tmp) / "feedback.json"),
                            AzureOpenAIConfig("", "", ""))
        srv = make_server(ctx, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            def get(path):
                conn = http.client.HTTPConnection(
                    "127.0.0.1", srv.server_address[1], timeout=120)
                conn.request("GET", path)
                resp = conn.getresponse()
                body = json.loads(resp.read())
                conn.close()
                if resp.status != 200:
                    raise AssertionError(f"{path}: HTTP {resp.status}")
                return body

            if not get("/api/health").get("ok"):
                raise AssertionError("/api/health not ok")
            c0 = (hk.heavy_fused3.launches, hk.gather_rows_bf16.launches)
            oseg = [seg.to_oracle_segment()]
            queries = [["w0001", "w0150"], ["w0000", "w0003", "w0400"],
                       ["w0002", "w0250"], ["w0010", "w0020", "w0030"],
                       ["w0005", "w0599"]]
            for terms in queries:
                body = get(f"/api/search?q={'+'.join(terms)}&k={K}")
                hits, found = oracle_search(oseg, [(t, 1.0) for t in terms], k=K)
                got = [(np.float32(x["score"]), x["docId"]) for x in body["results"]]
                exp = [(np.float32(s), doc) for s, _sg, doc in hits]
                if body["found"] != found or got != exp:
                    raise AssertionError(f"/api/search {terms} != oracle")
            c1 = (hk.heavy_fused3.launches, hk.gather_rows_bf16.launches)
            if not (c1[0] > c0[0] and c1[1] > c0[1]):
                raise AssertionError(f"server requests ran no K1/K2: {c0}->{c1}")
            say(f"server: {len(queries)} /api/search answers oracle-exact; "
                f"K1 +{c1[0] - c0[0]}, K2 +{c1[1] - c0[1]} launches")
        finally:
            srv.shutdown()
            srv.server_close()
            ctx.batcher.shutdown()
            ctx.suggest_batcher.shutdown()
            th.join(timeout=30)


def run(device_name="cuda", n_docs=N_DOCS, vocab=VOCAB, n_batches=64,
        loop_secs=5.0, reps=10, probe_shape=None):
    import torch

    from nextsearch_tpu_torch.ops import cuda_build

    device = torch.device(device_name)
    ph = Phases()
    card = card_line() if device.type == "cuda" else "cpu rehearsal"
    print(card, flush=True)
    if device.type == "cuda":
        info = cuda_build.build()
        say(f"kernel build: {info['seconds']:.1f}s -> {info['library']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas: {line.strip()}")
    ph.done("device+build")
    seg, ti, batches = build_index(device, n_docs, vocab, BATCH, n_batches)
    ph.done("corpus+index")
    shape = probe_shape or {}
    kern = check_kernels(ti, batches[0], device, reps)
    kern.update(check_probe_kernels(device, reps, shape))
    ph.done("kernels")
    oseg = seg.to_oracle_segment()
    launches = main_path(ti, [oseg], batches, device, loop_secs, card)
    ph.done("main path")
    del ti
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counts, bf16_kern, bf16 = bf16_phase(oseg, device, n_docs, vocab, n_batches,
                                         loop_secs, card, reps)
    kern.update(bf16_kern)
    for name, c in counts.items():
        launches[name] += c
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ph.done("bf16 rows")
    for name, c in probe_paths(device, shape).items():
        launches[name] += c
    ph.done("probe paths")
    server_phase(device)
    ph.done("server")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on its path")
    say(f"bf16 rows: {json.dumps(bf16)}")
    say(f"total {time.perf_counter() - ph.t0:.1f}s on {card}")
    kern["heavy_fused3"].update(
        {f"bf16_rows_exact_{k}": v for k, v in kern.pop("heavy_fused3_bf16_rows").items()})
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
             launches=launches[name], **kern[name])
        for name in KERNELS
    ]}), flush=True)
    return device


def main() -> int:
    if not (REPO / "nextsearch_tpu_torch").is_dir() or \
            not (REPO / "nextsearch_tpu").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a card only",
              file=sys.stderr)
        return 2
    run("cuda")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
