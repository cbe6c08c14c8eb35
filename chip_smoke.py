#!/usr/bin/env python3
"""Smoke run of the torch port's BM25 search paths (the sparse mode and the
fused, exact and fast modes), its build switches and 2-level selection sort,
its autocomplete, semantic expansion and hybrid rerank, its sharded backend,
and its HTTP server with its device trace and load generator on one CUDA
card.

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
   real batch-512 plan (K2/K3/K4 and mix_lists, the heavy product's
   pre-pass, bit-exact; K1 cnt bit-exact, H and smax within rtol 1e-6
   because the fp32 sums run in another order than cuBLAS's; K5 cnt
   bit-exact, totals and smax within rtol 2e-6), with median times beside
   the plain versions', the library call's where one PyTorch call computes
   the same function (library_ms, never called by the port), the bound
   computed from the run's inputs (bound_ms, bound_by: bytes over 3.35
   TB/s or operations over the peak of their type, a sparse product
   counted by the entries it uses), and the measured relative error of
   fast (one-pass bf16) H against exact H. Then the probe kernels at the
   probes' shapes: K6 (fast with f32 H, fast with bf16-up H, exact over a
   bf16 table) and each P6 variant at probe_fusedmm's (Q 512, uc 384,
   n_slots 999,424, bf16 table), whose dense mixes take the tensor-core
   dense kernel: cnt bit-exact, H and smax within tc_rtol (the tensor
   cores round once per 16-term step), cnt and H > 0 bit for bit and H
   within tc_rtol by `compare` (h_max_rel_err), a bf16 H bit-equal to the
   rounding of the kernel's own f32 H; K1 on the same dense mix, fast and
   f32-exact over the table widened to f32 (the cp.async-fed FFMA kernel,
   against cuBLAS within ffma_rtol); P1-P5 at mosaic_probe's on seeded
   random operands, plus a [37, 300] transpose, as
   benchmarks/kernel_probe.py holds them. K4, P1-P5 and mix_lists (all
   under 0.1 ms) are timed over many launches per event pair, as the
   wrapper (ms) and as the bare C entry point on preallocated outputs
   (raw_ms). K4 is timed beside the flat selection sort
   that its path replaces (replaced_exact_ms, replaced_quantized_ms: a
   yardstick, not a library call). The kernels line carries
   launch_floor_ms, P5's raw time at [1, 128]: one 16 x 16 block moving
   512 bytes.
4. main path: batch 512 / k 10 through search_batch_async /
   search_batch_gather, the launch counters reset before each launch and
   read after it, each launch spot-checked bit-exact against the oracle:
   (a) the guarded fast launch, (b) fast_heavy off (compact exact), (c) a
   forced guard trip that relaunches the full-table exact kernel, (d) the
   unified launch (unified=True, K5) guarded fast, (e) unified exact, (f)
   unified with a forced trip (relaunching the packed full-table kernel),
   (g) the windowed selection kernel (NEXTSEARCH_SELECT_PALLAS=1, K4)
   guarded fast, (h) K4 compact exact. Then 3 s pipelined loops at depth
   2 on the default path, under unified and under K4.
   Then, on the same index (each path's launches counted from zero):
   (p) autocomplete over the bench lexicon (df summed): 512 prefixes of
   lengths 1-7 through the per-prefix cache and host ranges, then with
   no cache and no host ranges through the window top-k and, for ranges
   wider than 16,384, the full-table top-k on the card; every answer
   equal to the host range top-k, ms per batch of each path. (q)
   clustered embeddings made here from a seed: dim 128, the term of df
   rank r in cluster r // 8, centre + 0.65 * noise (in-cluster cosine
   about 0.7, cross-cluster about 0). (r) bench batches expanded through
   Engine._weighted_terms: one batch oracle-exact over its expanded
   weighted terms, its expansions equal to SemanticIndex.expand over
   float64 similarities (near-ties within 2e-6 exempt and counted), and a
   3 s depth-2 loop that expands each batch in its requests' time. (s) 512
   questions of 10 distinct df-head terms expanded to the 40-term cap:
   the 64-query blocks whose heavy mix holds a row longer than
   GATHER_CUT (K1's dense kernel), reckoned from the launch's plan, must
   be > 0; all 512 results oracle-exact under the fast guard; K1 on those
   operands against its plain version within the dense kernels'
   tolerance, with its time and bound. (t) HybridIndex (beta 0.5) over
   the index: the doc-embedding build, 16 queries against
   _host_hybrid_row (doc order exact, scores rtol 2e-5), a 3 s depth-4 loop
   of batches of 128 at 100 candidates, and a batch with every heavy
   row's guard tripped (fast_heavy_eps 1e9), fixed up on the host.
   (u) the sharded backend (nextsearch_tpu_torch/parallel/), each path's
   launches counted from zero: (u1) a ShardedIndex on a (1,1) mesh of the
   card at the bench sparse configuration, pinned from the same batches:
   the guarded fast launch (K2 + K1), fast off (K3 + K1) and a forced trip
   of more than 8 queries (the full-table K1 relaunch), each spot-checked
   against the oracle and equal to the TorchIndex's results for the batch
   (scores bit for bit, (segment, doc), found); its device ms per batch
   (profile_paths.py's trace); a 3 s depth-2 loop beside the main path's
   default loop, then 2 s loops in turns (TorchIndex, sharded, sharded,
   TorchIndex). (u2) a (1,4) mesh with all four shards on the card, over
   the bench corpus cut by doc range into four 250k-doc segments (each with
   its own N, avgdl and scores): n_dense per shard, index bytes and peak
   memory; the guarded fast launch (K2 + K1 per shard) and a forced trip of
   8 queries rescued on the host, oracle-exact across the merge; device ms
   per batch and the merge's ms; one batch of a fused (1,4) index at
   bench.py's fused configuration (K3 and score_epilogue once per shard).
   (u3) dryrun_multichip(4): the toy and the production passes on (2,2)
   and (1,4), oracle-exact.
   (v) the build switches, each index built once over the same corpus and
   configuration and held to the main index: (v1)
   NEXTSEARCH_LIGHT_BUILD=device and NEXTSEARCH_ROW_TOPK_BUILD=device: the
   light table and the search depth bit-equal, the row top-k's values
   bit-equal on every row whose df >= k (slots equal above each row's last
   value: the host path cuts a tie run that crosses lane k at any of its
   members), a guarded fast launch (K2 + K1) oracle-exact and bit-equal to
   the main index's, 64 one-term head queries answered by the row top-k
   shortcut with no launch, oracle-exact; (v2) NEXTSEARCH_DEVICE_BUILD=0:
   the host-built dense rows bit-equal to the device build, a guarded fast
   launch as (v1)'s; each path's build seconds beside the default's, and
   (v2)'s host memory. (w) NEXTSEARCH_SORT2_2LEVEL=1 on the main index: the
   guarded fast launch takes the 2-level branch (its counter), its packed
   output equals the one-level launch's bit for bit and is oracle-exact;
   device ms per batch both ways and 2 s loops in turns.
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
   Then a 3 s loop at depth 2.
6. fused, exact, fast: the bf16 index is freed and a fused-mode TorchIndex
   (the library default) is built over the same corpus at bench.py's fused
   configuration (dense ratio 1/256, 2 GiB of rows, block 64, K2 32). K3
   on this path's operands (the batch's unique heavy rows, padded to the
   pinned U) against its plain version and index_select; score_epilogue
   (the add of the heavy product, found and the tile maxima in one pass)
   on the spot batch's light scatter, in f32 and in bf16, and f32 product,
   bit-exact against its plain version (scores' bits, found, tile_max),
   timed beside it with its bytes' bound, and its found-only form; (m) one
   batch-512 launch spot-checked bit-exact against the oracle, with K3 and
   score_epilogue launched once each and no other kernel; a 3 s loop at
   depth 2 (QPS, p50, stream span per batch, peak memory; K3 and
   score_epilogue once per batch); (n) one batch of 64 in exact mode,
   bit-exact and run twice for the same bits, and (o) one in fast mode
   (found equal, scores within 1e-5, docs equal outside near-ties), both
   at the library's posting block of 2048 and launching score_epilogue
   once; one hybrid batch of 128 over this index under (t)'s gate.
7. probe paths: benchmarks/kernel_probe.py (P1-P5, all PASS) and one
   short run of benchmarks/probe_fusedmm.py (K6 and every P6 variant).
8. server: a small on-disk index served over HTTP by the port's Engine, in
   sparse mode (answers run K1 and K2) and in the mode the server's main
   starts in with no NEXTSEARCH_MODE, the library default (fused; answers
   run K3 and score_epilogue); /api/search answers must match the oracle, ?hybrid=1
   (there is no embeddings file) must answer the same, and
   /api/suggest?q=w00 the autocomplete table's list. The first sparse
   serve runs its requests with NEXTSEARCH_PROFILE_DIR set: (x) the
   torch.profiler traces under search/ must name K1's and K2's kernels;
   then (y) benchmarks/load_http.py --mode batch loads it for 3 s
   (--reuse-server), its spot-check oracle-exact. Then with an
   embeddings.vec in the index directory, in both modes: searches equal
   the oracle over the engine's expanded terms, ?hybrid=1 answers the
   reference's hybrid body with HybridIndex.search_batch's docs, cached
   under "q|K|hybrid". (u4) Both again in sparse mode over --mesh 1,1
   (serving_mesh: a ShardedIndex), where ?hybrid=1 takes the "hybrid_host"
   path.

Every path's launches are counted from zero just before it and read just
after; a kernel of the path that never launched fails the run.

The line before the last is a JSON object of the kernels' launch counts,
errors, times, bounds and library times; the last line is {"ok": true,
"device": {...}}. Nothing here imports jax or the JAX package: the oracle,
builder and HTTP front are the port's own copies.
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


def timed(fn, device, reps: int, inner: int = 1) -> float:
    """Median milliseconds of one fn() over reps timings, each spanning
    `inner` back-to-back calls (CUDA events on a card, the host clock in a
    CPU rehearsal)."""
    from nextsearch_tpu_torch.benchmarks.common import event_ms

    if device.type == "cuda":
        return event_ms(fn, reps, inner=inner)
    fn()  # warm
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / inner)
    return statistics.median(times)


def inner_for(fn, device) -> int:
    """How many calls of fn an event pair should span (about 2 ms of device
    work): 1 for a multi-millisecond kernel, some hundreds for the probes.
    A short call is first timed 50 to a pair, since one call alone reads as
    the host's time to issue it."""
    from nextsearch_tpu_torch.benchmarks.common import pick_inner

    once = timed(fn, device, 3)
    if once >= 0.5:
        return pick_inner(once)
    return pick_inner(timed(fn, device, 3, 50))


def timed_small(device, reps: int, kern, plain, library=None, raw=None) -> dict:
    """Times of a kernel under ~0.1 ms: `ms` (its wrapper: what a caller
    pays, allocations and argument copies included), `plain_ms`,
    `library_ms` and `raw_ms` (the C entry point alone on preallocated
    outputs: what the kernel takes), all over the same `inner` calls per
    event pair. The operands of these kernels fit in the card's 50 MB L2
    and are not flushed between calls."""
    inner = inner_for(raw or kern, device)
    return dict(ms=timed(kern, device, reps, inner),
                plain_ms=timed(plain, device, reps, inner),
                library_ms=library and timed(library, device, reps, inner),
                raw_ms=raw and timed(raw, device, reps, inner), inner=inner)


def raw_entry(entry: str, dev, *args):
    """A call of the kernel library's C entry point on fixed arguments
    (tensors already allocated) and the stream current now: the kernel
    without its wrapper."""
    from nextsearch_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.library(), entry)
    stream = cuda_build.stream(dev)

    def call():
        cuda_build.check_rc(fn(*args, stream), entry)
    return call


# Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W):
# device memory, and operations by the type of the operands.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12}


def bound(nbytes: float, ops: float = 0.0, kind: str = "fp32") -> dict:
    """The least time the card could take for a function: the larger of
    the bytes it must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate of
    their type, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rounded_mix(mix, table, fast: bool):
    """mix as the heavy product uses it: rounded to bf16 in fast mode or
    over a bf16 table."""
    import torch

    if fast or table.dtype == torch.bfloat16:
        return mix.to(torch.bfloat16).float()
    return mix


def heavy_bound(mix, table, fast: bool, outs, extra: int = 0) -> dict:
    """K1/K5/K6/P6's bound on this run's inputs: the table rows that the
    mix's nonzero entries use, each read once, plus mix, the outputs and
    any extra input bytes; operations are the multiply-adds of the nonzero
    entries (2 per entry per doc), bf16 where the product rounds to bf16."""
    import torch

    m = _rounded_mix(mix, table, fast) != 0
    rows_used, nnz = int(m.any(dim=0).sum()), int(m.sum())
    n_slots = table.shape[1]
    return bound(rows_used * n_slots * table.element_size()
                 + nbytes(mix, *outs) + extra,
                 2.0 * nnz * n_slots,
                 "bf16" if fast or table.dtype == torch.bfloat16 else "fp32")


def heavy_library_ms(mix, table, fast: bool, device, reps: int) -> float:
    """The library yardstick of the heavy product: one torch.matmul of the
    operands as the kernel rounds them, widened to f32 before the timed
    region, TF32 off (the product alone, no epilogue)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    a = _rounded_mix(mix, table, fast).contiguous()
    b = table.to(torch.bfloat16).float() if fast else table.float()
    ms = timed(lambda: torch.matmul(a, b), device, reps)
    del a, b
    return ms


def prefixed(prefix: str, d: dict) -> dict:
    return {f"{prefix}{k}": v for k, v in d.items()}


def check_mix_lists(mixes, device, reps: int) -> dict:
    """mix_lists against its plain version, bit for bit, on the main
    path's mixes (label -> (mix, round_bf16)); timed on the first."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    for label, (mix, rnd) in mixes.items():
        got, exp = hk.mix_lists(mix, rnd), hk.mix_lists_ref(mix, rnd)
        if not all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, exp)):
            raise AssertionError(f"mix_lists ({label}) is not bit-exact")
        say(f"mix lists ({label}): Q={mix.shape[0]} ND={mix.shape[1]} "
            f"L={got[1].shape[1]} entries per row max={int(got[0].max())} "
            f"mean={float(got[0].float().mean()):.3f}")
        if rnd:
            mixb = hk.mix_lists(mix, rnd, with_bf16=True)[3]
            if not torch.equal(_bits(mixb), _bits(hk.mix_bf16_padded_ref(mix))):
                raise AssertionError(f"mix_lists ({label}): bf16 rows differ")
    mix, rnd = next(iter(mixes.values()))
    got = hk.mix_lists(mix, rnd)
    raw = None
    if device.type == "cuda":
        raw = raw_entry("ns_mix_lists", device, mix.data_ptr(), int(rnd),
                        *mix.shape, got[1].shape[1], *(t.data_ptr() for t in got),
                        None, 0)
    return dict(max_abs_err=0.0, **bound(nbytes(mix, *got)), **timed_small(
        device, reps, lambda: hk.mix_lists(mix, rnd),
        lambda: hk.mix_lists_ref(mix, rnd), raw=raw))


def build_index(device, n_docs: int, vocab: int, batch: int, n_batches: int,
                mode: str = "sparse", **device_fields):
    """Bench corpus (artifact-cached under the temp dir), TorchIndex at the
    bench configuration (with device_fields on top), and batch-envelope
    pins from the query stream."""
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.benchmarks.common import bench_corpus
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import sample_queries

    seg, probs = bench_corpus(n_docs, vocab)
    say(f"corpus: {n_docs} docs, {vocab} terms, {seg.num_postings} postings")
    # bench.py's configuration for the mode: dense ratio 1/1024 and 7 GiB of
    # rows in sparse mode, 1/256 and 2 GiB otherwise
    sparse = mode == "sparse"
    cfg = EngineConfig(device=DeviceConfig(
        mode=mode, posting_block=64, heavy_buckets=(512,),
        dense_df_ratio=1 / 1024 if sparse else 1 / 256,
        dense_max_bytes=7 << 30 if sparse else 2 << 30, rescore_margin=32,
        **device_fields,
    ))
    batches = sample_queries(probs, n_queries=n_batches * batch, batch=batch)
    ti = TorchIndex([seg], config=cfg, device=device)
    pins = ti.pin_shapes(batches, scope_q=True)
    say(f"index {mode}{' ' + str(device_fields) if device_fields else ''}: "
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

    rows_read = int(torch.unique(ids).numel()) * ti.n_slots * 4
    for name, fn, ref, dt, library in (
        ("gather_rows_bf16", hk.gather_rows_bf16, hk.gather_rows_bf16_ref,
         torch.int16, None),
        ("gather_rows", hk.gather_rows, hk.gather_rows_ref, torch.int32,
         lambda: torch.index_select(table, 0, ids)),
    ):
        got, exp = fn(ids, table), ref(ids, table)
        if not torch.equal(got.view(dt), exp.view(dt)):
            raise AssertionError(f"{name} is not bit-exact")
        out[name] = dict(
            max_abs_err=float((got.float() - exp.float()).abs().max()),
            ms=timed(lambda: fn(ids, table), device, reps),
            plain_ms=timed(lambda: ref(ids, table), device, reps),
            library_ms=library and timed(library, device, reps),
            **bound(nbytes(ids, got) + rows_read),
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

    fast_out, err_fast = k1(mix_c, t_bf16, True)
    exact_out, err_exact_c = k1(mix_c, t_f32, False)
    h_fast, h_exact_c = fast_out[0], exact_out[0]
    pos = h_exact_c > 0
    rel = ((h_fast - h_exact_c).abs()[pos] / h_exact_c[pos]).max()
    say(f"fast H vs exact H (compact, 1M shapes): max rel err {float(rel):.6g} "
        f"(guard eps {ti.config.device.fast_heavy_eps})")
    b_fast = heavy_bound(mix_c, t_bf16, True, fast_out)
    b_exact_c = heavy_bound(mix_c, t_f32, False, exact_out)
    del fast_out, exact_out, h_fast, h_exact_c, pos
    full_out, err_exact = k1(mix_f, table, False)
    b_full = heavy_bound(mix_f, table, False, full_out)
    del full_out
    half = max(2, reps // 2)

    def k1_times(mix, tab, fast, n):
        return dict(
            ms=timed(lambda: hk.heavy_fused3(mix, tab, fast=fast), device, n),
            plain_ms=timed(lambda: hk.heavy_fused3_ref(mix, tab, fast=fast),
                           device, n),
            library_ms=heavy_library_ms(mix, tab, fast, device, n))

    out["heavy_fused3"] = dict(
        max_abs_err=err_fast, **k1_times(mix_c, t_bf16, True, reps), **b_fast,
        exact_compact_max_abs_err=err_exact_c,
        **prefixed("exact_compact_", k1_times(mix_c, t_f32, False, reps)),
        **prefixed("exact_compact_", b_exact_c),
        exact_full_max_abs_err=err_exact,
        **prefixed("exact_full_", k1_times(mix_f, table, False, half)),
        **prefixed("exact_full_", b_full),
        fast_vs_exact_h_max_rel_err=float(rel),
    )
    out["mix_lists"] = check_mix_lists(
        {"fast compact": (mix_c, True), "exact full table": (mix_f, False),
         "exact compact": (mix_c, False)}, device, reps)
    del t_f32
    out["unified_fused"] = check_unified(ti, plan, mix_c, ids, device, reps)
    out["per_query_topk"] = check_select(ti, plan, mix_c, t_bf16, device, reps)
    for name, v in out.items():
        say(f"kernel {name}: " + fmt(v))
    return out


def fmt(v: dict) -> str:
    return " ".join(f"{k}={x:.6g}" if isinstance(x, float) else f"{k}={x}"
                    for k, x in v.items())


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
    rtol = tc_rtol(uc)
    say(f"probe shapes: Q={q} uc={uc} n_slots={dense.shape[1]} bf16 table, "
        f"rtol {rtol:.3g}")
    out = {}
    f32 = hk.heavy_fused(mix, dense, fast=True)
    ref = hk.heavy_fused_ref(mix, dense, fast=True)
    err = _heavy_check("K6 fast", f32, ref, rtol)
    rel = compare(f32, ref, rtol)
    del ref
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
    b_up = heavy_bound(mix, dense, True, up)
    b_exact = heavy_bound(mix, dense, False, exact)
    del up, exact
    out["heavy_fused"] = dict(
        max_abs_err=err,
        ms=timed(lambda: hk.heavy_fused(mix, dense, fast=True), device, reps),
        plain_ms=timed(lambda: hk.heavy_fused_ref(mix, dense, fast=True),
                       device, reps),
        library_ms=heavy_library_ms(mix, dense, True, device, reps),
        **heavy_bound(mix, dense, True, f32),
        **prefixed("bf16_up_", b_up), **prefixed("exact_", b_exact),
        bf16_up_ms=timed(lambda: hk.heavy_fused(mix, dense, fast=True,
                                                h_dtype=bf16), device, reps),
        bf16_up_plain_ms=timed(lambda: hk.heavy_fused_ref(
            mix, dense, fast=True, h_dtype=bf16), device, reps),
        exact_ms=timed(lambda: hk.heavy_fused(mix, dense, fast=False),
                       device, reps),
        exact_plain_ms=timed(lambda: hk.heavy_fused_ref(mix, dense, fast=False),
                             device, reps),
        h_max_rel_err=rel,
    )
    out["heavy_fused3_dense"] = k1_dense(mix, dense, f32, device, reps, rtol)
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
        key = "_".join(f"{k}_{v}" for k, v in kw.items()).replace(
            "torch.bfloat16", "bf16") or "full"
        p6.update(prefixed(f"{key}_", heavy_bound(mix, dense, True, got)))
        del got
        p6[f"{key}_ms"] = timed(lambda kw=kw: hk.heavy_fused_variant(
            mix, dense, **kw), device, reps)
        p6[f"{key}_plain_ms"] = timed(lambda kw=kw: hk.heavy_fused_variant_ref(
            mix, dense, **kw), device, reps)
    del f32
    out["heavy_fused_variant"] = dict(
        max_abs_err=err, ms=p6["full_ms"], plain_ms=p6["full_plain_ms"],
        library_ms=None, bound_ms=p6["full_bound_ms"],
        bound_by=p6["full_bound_by"], **p6)
    args = kernel_probe.inputs(device)
    library = probe_library(args)
    raws = kernel_probe.raw_calls(args) if device.type == "cuda" else {}
    for name, (label, kern, plain, tol) in kernel_probe.calls(args).items():
        got = kern()
        lib = library[name]
        if lib[1] <= nbytes(got):
            raise AssertionError(f"{name}: bound omits the inputs or output")
        err = kernel_probe.check(got, plain(), tol)
        raw = None
        if name in raws:
            raw, raw_out = raws[name]
            raw()
            if not torch.equal(raw_out, got):
                raise AssertionError(f"{name}: raw launch differs from wrapper")
        out[name] = dict(max_abs_err=err, **bound(lib[1], lib[2]),
                         **timed_small(device, reps, kern, plain, lib[0], raw))
    wide = out.pop("transpose_wide")
    out["transpose"].update(prefixed("wide_", wide))
    for name, v in out.items():
        say(f"kernel {name}: " + fmt(v))
    return out


def tc_rtol(nd: int) -> float:
    """Tolerance of the tensor-core dense kernel's H and smax against the
    plain version and the gather. All multiply the same bf16 values
    (exact products) and add nd non-negative terms in f32; the tensor cores
    round (toward zero) once per 16-term mma step, not once per term, so
    their sum is within nd / 16 steps of 2^-23 of the true one. Doubled for
    the other side's own rounding, plus 8 steps for short contractions;
    the worst case of any order would be nd * 2^-23."""
    return (nd / 8 + 8) * 2.0 ** -23


def compare(new, old, rtol: float) -> float:
    """Max relative difference of H; raises unless cnt and H > 0 are equal
    and H is within rtol (0: bit for bit; a bf16 H within one bf16 step)."""
    import torch

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


def k1_dense(mix, dense, k6, device, reps: int, rtol: float) -> dict:
    """K1 on a dense mix at K6's shapes: bf16 operands (fast; the
    tensor-core kernel, bit-equal to K6's launch k6) and f32 exact over
    the same table widened to f32 (the FFMA kernel; bound by operations),
    each against its plain version, with bound, plain and library time."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    out = {}
    wide = dense.float()
    # the FFMA loop against cuBLAS: two orders of a uc-term positive sum
    ffma_rtol = 2 * mix.shape[1] * 2.0 ** -24
    for key, tab, fast in (("fast_", dense, True), ("exact_f32_", wide, False)):
        got = hk.heavy_fused3(mix, tab, fast=fast)
        err = _heavy_check(f"K1 dense {key}", got,
                           hk.heavy_fused3_ref(mix, tab, fast=fast),
                           rtol if fast else ffma_rtol)
        if fast and not all(torch.equal(a, b) for a, b in zip(got, k6)):
            raise AssertionError("K1 dense fast differs from K6 fast")
        out.update(prefixed(key, dict(
            max_abs_err=err, **heavy_bound(mix, tab, fast, got))))
        del got
        out.update(prefixed(key, dict(
            ms=timed(lambda: hk.heavy_fused3(mix, tab, fast=fast), device, reps),
            plain_ms=timed(lambda: hk.heavy_fused3_ref(mix, tab, fast=fast),
                           device, reps),
            library_ms=heavy_library_ms(mix, tab, fast, device, reps))))
    return out


def probe_library(args: dict) -> dict:
    """P1-P5: name -> (the one PyTorch call that computes the probe's
    function, or None; the bytes it must move, each input read once and
    each f32 output written once; fp32 operations). P4's input is already
    contiguous, where .contiguous() returns it without work, so its
    yardstick is the copy clone() makes."""
    from nextsearch_tpu_torch.benchmarks.kernel_probe import Q, ROWS, TILE

    a, b = args["nt_dot"]
    e, off = args["row_copy"]
    wq, wv, wd = args["window_op"]
    (r,) = args["reshape_copy"]
    (t,) = args["transpose"]
    (tw,) = args["transpose_wide"]
    q, w = a.shape
    row = e.shape[1] * e.element_size()
    return {
        "nt_dot": (lambda: a @ b.T, nbytes(a, b) + 4 * q * b.shape[0],
                   2.0 * q * b.shape[0] * w),
        # one row of e is read, and the index; ROWS copies are written
        "row_copy": (None, row + nbytes(off) + ROWS * row, 0.0),
        "window_op": (None, nbytes(wq, wv, wd) + 4 * Q * TILE, 0.0),
        "reshape_copy": (lambda: r.reshape(512, r.shape[-1]).clone(),
                         2 * nbytes(r), 0.0),
        "transpose": (lambda: t.t().contiguous(), 2 * nbytes(t), 0.0),
        "transpose_wide": (lambda: tw.t().contiguous(), 2 * nbytes(tw), 0.0),
    }


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
    err, times = 0.0, {}
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
        # the kernel reads int32 doc/q streams, the values and one offset
        # per sub-block
        entries = 12 * sd.numel() + 4 * (n // 128 + 1)
        timing = dict(
            ms=timed(lambda: hk.unified_fused(mix_c, table, sd, sq, sv,
                                              fast=fast), device, reps),
            plain_ms=timed(lambda: hk.unified_fused_ref(
                mix_c, table, sd, sq, sv, fast=fast), device, reps),
            **heavy_bound(mix_c, table, fast, (tot, smax, cnt), entries))
        times.update(timing if fast else prefixed("exact_", timing))
        del tot, smax, cnt, again, exp, table
    return dict(max_abs_err=err, library_ms=None, **times)


def check_select(ti, plan, mix_c, t_bf16, device, reps):
    """K4 against its plain version on the plan's light selection scores
    (light totals + fast H at each (q, doc)): the threshold select,
    bit-exact through the wrapper and the raw entry, timed beside the flat
    selection sort that the K4 path replaces (per_query_topk_flat over
    the same stream, exact and quantized) as a yardstick, not a library
    call."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import select_kernels as sk
    from nextsearch_tpu_torch.ops.bm25_sparse import (
        light_totals,
        per_query_topk_flat,
    )

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
    raw = None
    if device.type == "cuda":
        b64 = bounds.to(torch.int64).contiguous()
        # the kernel writes every slot; outs stays alive while raw is timed
        outs = [torch.full_like(t, 7) for t in got]
        raw = raw_entry("ns_per_query_topk", device, sel.data_ptr(),
                        b64.data_ptr(), sel.numel(), q, k2,
                        *(t.data_ptr() for t in outs))
        raw()
        if not all(torch.equal(a, b) for a, b in zip(outs, exp)):
            raise AssertionError("K4 raw differs from plain")
    flat = {f"replaced_{name}_ms": (lambda quant=quant: per_query_topk_flat(
        sq, sel, sd, q, k2, quantized=quant)) for name, quant in
        (("exact", False), ("quantized", True))}
    return dict(
        max_abs_err=float((got[0] - exp[0]).abs().max()),
        **bound(nbytes(sel, bounds, *got)),
        **timed_small(device, reps, lambda: sk.per_query_topk(sel, bounds, k2),
                      lambda: sk.per_query_topk_ref(sel, bounds, k2), raw=raw),
        **{k: timed(fn, device, reps, inner_for(fn, device))
           for k, fn in flat.items()},
    )


def spot_check(ti, oracle_segs, queries, results, memo):
    """Results equal the oracle: f32 scores, (segment, doc), found.
    oracle_search_vec is oracle_search vectorized, with the same bits."""
    import numpy as np

    from nextsearch_tpu_torch.index.oracle import oracle_search_vec

    for terms, res in zip(queries, results):
        key = tuple(terms)
        if key not in memo:
            memo[key] = oracle_search_vec(oracle_segs, terms, k=K)
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
    # the pre-pass of K1/K5/K6/P6's port, launched by their wrappers; no TPU
    # kernel of its own, so it names K1's
    "mix_lists": "nextsearch_tpu/ops/heavy_pallas.py:706",
    # the fused mode's passes after the dot (add, found, tile max), which
    # XLA fuses in the reference (no Pallas kernel): it names the add
    "score_epilogue": "nextsearch_tpu/ops/bm25.py:358",
}
# the products whose wrappers launch mix_lists once each
PRODUCTS = ("heavy_fused3", "unified_fused", "heavy_fused",
            "heavy_fused_variant")
PROBES = ("nt_dot", "row_copy", "window_op", "reshape_copy", "transpose")


def _wrappers():
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import probe_kernels as pk
    from nextsearch_tpu_torch.ops import score_kernels as se
    from nextsearch_tpu_torch.ops import select_kernels as sk

    module = {"per_query_topk": sk, "score_epilogue": se,
              **dict.fromkeys(PROBES, pk)}
    return {name: getattr(module.get(name, hk), name) for name in KERNELS}


def with_lists(counts: dict) -> dict:
    """Expected launch counts of a path: its product launches plus the
    mix_lists pre-pass that each of them makes."""
    n = sum(counts.get(k, 0) for k in PRODUCTS)
    return {**counts, "mix_lists": n} if n else dict(counts)


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, by name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def launched(counts: dict) -> dict:
    """The nonzero entries of a launch count: what a path ran."""
    return {k: v for k, v in counts.items() if v}


def captures(index) -> int:
    """The index's launch-graph captures so far, over its devices."""
    return sum(c.captures for c in index.launch_caches.values())


def warm(index, queries, k=K):
    """Capture the launch graphs of the batch's envelope (warm_batch: the
    launch and, under the fast guard, its exact relaunch) before a counted
    launch or a loop, so that what is counted is a replay, as serving after
    Engine.warmup; returns the capture count."""
    index.warm_batch(queries, k=k)
    return captures(index)


def no_capture(index, before, label):
    """Fail when a launch at pinned shapes captured a graph (the recompile
    flapping that pin_shapes rules out)."""
    if captures(index) != before:
        raise AssertionError(f"{label}: captured {captures(index) - before} "
                             "launch graph(s) at pinned shapes")


def serving_loop(ti, batches, device, secs: float, label: str, card: str,
                 batch: int = BATCH):
    """Depth-2 pipelined loop over the stream's batches (batch 0 is the
    spot-check batch), bench.py's own loop; returns the launch counts it
    made and its QPS, p50 milliseconds, stream span per batch (the event
    span bench.py documents: the host's dispatch time where the loop is
    host-bound) and peak allocated bytes."""
    import torch

    from nextsearch_tpu_torch.benchmarks.bench import Pipeline

    trips0, rel0 = ti.rescue_trips, ti.relaunches
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    caps = warm(ti, batches[1])
    reset_counts()
    loop = Pipeline(ti, batches[1:], batch, 2)
    r = loop.run(secs, start=0)
    counts = launch_counts()
    no_capture(ti, caps, f"serving loop {label}")
    # reserved: a graph pool's blocks are not "allocated" between replays
    peak = (torch.cuda.max_memory_reserved(device) if device.type == "cuda"
            else 0)
    span_ms = r["stream_span_ms_per_batch"]
    say(f"[{card}] serving loop {label}: batch {batch} depth 2 k {K}: "
        f"qps={r['qps']:.1f} p50_ms={r['p50_req_ms']:.2f} "
        "stream_span_ms_per_batch="
        + ("not measured" if span_ms is None else f"{span_ms:.3f}")
        + f" batches={len(loop.lat)} "
        f"host_rescued_queries={ti.rescue_trips - trips0} "
        f"relaunched_batches={ti.relaunches - rel0} peak_reserved={peak} "
        f"graphs={captures(ti)} launches {launched(counts)}")
    return counts, dict(qps=r["qps"], p50_ms=r["p50_req_ms"],
                        stream_span_ms_per_batch=span_ms, peak_reserved=peak)


def _config(ti, cfg, **device_fields):
    ti.config = replace(cfg, device=replace(cfg.device, **device_fields))


def main_path(ti, oracle_segs, batches, device, loop_secs: float, card: str):
    """Launches (a)-(h), then the pipelined loops; returns each kernel's
    launch count summed over all of them, and each loop's numbers."""
    memo: dict = {}
    loops: dict = {}
    spot = batches[0]
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, c in counts.items():
            total[name] += c

    def run(label, *expect, relaunch=False):
        caps = warm(ti, spot)
        r0 = ti.relaunches
        reset_counts()
        t = time.perf_counter()
        res = ti.search_batch(spot, k=K)
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        no_capture(ti, caps, label)
        spot_check(ti, oracle_segs, spot[:SPOT], res[:SPOT], memo)
        expect = [with_lists(e) for e in expect]
        if counts not in expect:
            raise AssertionError(f"{label}: launches {counts} not in {expect}")
        if relaunch and ti.relaunches != r0 + 1:
            raise AssertionError(f"{label}: did not relaunch")
        add(counts)
        say(f"launch {label}: {dt * 1e3:.1f} ms (graph replays), {SPOT} "
            f"queries oracle-exact, launches {counts}")

    cfg = ti.config
    config = lambda **kw: _config(ti, cfg, **kw)  # noqa: E731

    def tripped(label, *expect):
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="0"):
            run(label, *expect, relaunch=True)

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
        counts, loops["default"] = serving_loop(ti, batches, device, loop_secs,
                                                "default", card)
        add(counts)
        config(unified=True)
        add(serving_loop(ti, batches, device, loop_secs, "unified", card)[0])
        config()
        with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1"):
            add(serving_loop(ti, batches, device, loop_secs, "K4", card)[0])
    finally:
        ti.config = cfg
    hbm = ti.hbm_bytes()
    say(f"[{card}] index bytes: " + " ".join(f"{k}={v}" for k, v in hbm.items()))
    for name in (k1, k2, k3, k4, k5, "mix_lists"):
        if total[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    return total, loops


# ---------------------------------------------------------------- graphs:
# the serving launches as CUDA graphs (ops/graphs.py) against the same
# launches run eagerly

# each path's kernels, which its graph replays must advance
PATH_KERNELS = {"default": ("heavy_fused3", "gather_rows_bf16"),
                "unified": ("unified_fused", "gather_rows_bf16"),
                "K4": ("heavy_fused3", "gather_rows_bf16", "per_query_topk"),
                "fused": ("gather_rows", "score_epilogue")}
GRAPH_CHECK_BATCHES = 8  # batches run both ways and held bit for bit


def graphs_path(ti, oracle_segs, batches, device, card, name: str,
                n_serial: int = 10, n_loop: int = 100):
    """One of profile_paths.py's paths on `ti` (its config and environment
    already set): a fresh graphed launch cache and an eager one on the same
    index; GRAPH_CHECK_BATCHES batches through both, bit-equal, the first
    two oracle-exact, each graphed batch advancing the path's counters and
    none capturing after the warm batch; then profile_paths.profile_path
    eager, then graphed (loop period, QPS, p50, host async and gather ms,
    device ms and kernels a batch, traced idle share, the captures, their
    seconds and none after the warm-up), and the graphed serial batches'
    kernels held name for name against the eager ones'. (What the graphs
    hold on the card needs a fresh process per setting: profile_paths.py
    --memory.) Returns the launch counts of the checked graphed batches
    and the numbers."""
    import profile_paths

    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.ops.graphs import LaunchCache

    kept = ti.launch_cache
    graphed, eager = LaunchCache(ti.device), eager_cache(ti.device)
    total = dict.fromkeys(KERNELS, 0)
    memo: dict = {}
    try:
        ti.launch_cache = graphed
        caps = warm(ti, batches[1])
        warm_s = graphed.capture_s
        for i, b in enumerate(batches[1:1 + GRAPH_CHECK_BATCHES]):
            ti.launch_cache = eager
            want = ti.search_batch(b, k=K)
            ti.launch_cache = graphed
            reset_counts()
            got = ti.search_batch(b, k=K)
            counts = launched(launch_counts())
            missing = [k for k in PATH_KERNELS[name] if not counts.get(k)]
            if missing:
                raise AssertionError(f"graphs {name}: replay launched "
                                     f"{counts}, not {missing}")
            for k, c in counts.items():
                total[k] += c
            _same_results(got, want, f"graphs {name} batch {i}",
                          "the eager launch")
            if i < 2:
                spot_check(ti, oracle_segs, b[:SPOT], got[:SPOT], memo)
        no_capture(ti, caps, f"graphs {name} checked batches")
        out = dict(captures=caps, capture_s=warm_s, checked=GRAPH_CHECK_BATCHES)
        # device numbers come from the card only
        turns = (("eager", eager), ("graphed", graphed))
        for turn, cache in turns if device.type == "cuda" else ():
            ti.launch_cache = cache
            r = profile_paths.profile_path(ti, batches, K, n_serial, n_loop)
            out[turn] = r
            if turn == "graphed" and (r["graphs"]["captures"]
                                      or r["graphs"]["captures_after_warm"]):
                raise AssertionError(f"graphs {name}: the timed runs "
                                     f"captured {r['graphs']}")
            ser, loop, tl = r["serial"], r["loop"], r["traced_loop"]
            say(f"[{card}] graphs {name} {turn}: period_ms="
                f"{loop['period_ms']:.3f} qps={loop['qps']:.1f} p50_ms="
                f"{loop['p50_ms']:.2f} host_async_ms={loop['host_async_ms']:.3f}"
                f" host_gather_ms={loop['host_gather_ms']:.3f} device_ms="
                f"{ser['device_ms_per_batch']:.3f} kernels_per_batch="
                f"{ser['kernels_per_batch']} traced_idle_share="
                f"{tl['idle_share']:.4f} copies_per_batch="
                f"{ser['copies_per_batch']} memsets_per_batch="
                f"{ser['memsets_per_batch']}")
        if device.type == "cuda":
            # the graphs replay the eager launch's kernels, name for name
            e, g = out["eager"]["serial"], out["graphed"]["serial"]
            added = out["graphed"]["graphs"]["copies_serial"] / n_serial
            bad = profile_paths.kernel_mix_mismatch(e, g, added)
            diff = {n[:120]: d for n, d in
                    profile_paths.kernel_mix_diff(e, g).items()}
            if bad:
                raise AssertionError(f"graphs {name}: the graphed batches' "
                                     f"kernels differ from eager's: {bad}; "
                                     f"all differences {diff}")
            mem = [profile_paths.split_node_kernels(x)[1] for x in (e, g)]
            say(f"[{card}] graphs {name}: the graphed batches launch the "
                f"eager batches' kernels, name for name "
                f"({len(e['kernels_by_name'])} names), and the memory "
                f"operations a batch grow by the replays' {added} copies "
                f"({mem[0]} -> {mem[1]}); all differences, CUDA's memset/"
                f"memcpy node kernels included: {diff}")
    finally:
        ti.launch_cache = kept
    if graphed.captures > 2:
        raise AssertionError(f"graphs {name}: {graphed.captures} graphs for "
                             "one pinned envelope (at most the launch and "
                             "its exact relaunch)")
    say(f"[{card}] graphs {name}: {GRAPH_CHECK_BATCHES} batches bit-equal to "
        f"the eager launch, 2 oracle-exact; {graphed.captures} graph(s) "
        f"captured in {warm_s:.3f} s, {graphed.replays} replays, none "
        f"captured after the warm batch; launches {launched(total)}")
    return total, out


def graphs_phase(ti, oracle_segs, batches, device, card):
    """The three sparse paths of profile_paths.py through graphs_path on the
    main index."""
    import profile_paths

    cfg = ti.config
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    try:
        for name, mode, fields, env in profile_paths.PATHS:
            if mode != "sparse":
                continue
            _config(ti, cfg, **fields)
            with mock.patch.dict(os.environ, env):
                counts, out[name] = graphs_path(ti, oracle_segs, batches,
                                                device, card, name)
            for k, c in counts.items():
                total[k] += c
    finally:
        ti.config = cfg
    return total, out


def reload_memory(ti, batches, device, card, n: int = 3) -> dict:
    """n reloads of `ti`'s index (a new TorchIndex over its segments and
    config, pinned and its graphs captured, then dropped): the bytes the
    card holds after each drop, once the allocator's free blocks are
    returned, must not grow, so a dropped index's graph pool goes with it
    (a live pool's blocks stay reserved, though not allocated between
    replays)."""
    import gc

    import torch

    from nextsearch_tpu_torch.index.segment import TorchIndex

    def settle():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            return torch.cuda.memory_reserved(device)
        return 0

    base = settle()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    after, graphs = [], []
    for _ in range(n):
        new = TorchIndex(ti.segments, config=ti.config, device=device)
        new.pin_shapes(batches, scope_q=True)
        new.warm_batch(batches[1], k=K)
        graphs.append(new.launch_cache.captures)
        del new
        after.append(settle())
    peak = (torch.cuda.max_memory_reserved(device) if device.type == "cuda"
            else 0)
    if after[-1] > after[0]:
        raise AssertionError(f"reloads: reserved bytes after each drop "
                             f"{after} grow")
    say(f"[{card}] {n} reloads: graphs captured {graphs}; reserved before "
        f"{base}, after each drop {after}; peak_reserved {peak}")
    return dict(reserved_before=base, reserved_after=after,
                peak_reserved=peak, graphs=graphs)


def exact_window_keys(ti, batches, q: int = 64, block: int = 2048) -> dict:
    """Exact mode's graph key would hold max_df, each term slot's window
    count at `block`: the distinct counts over the stream's batches of q
    (host planning only). Exact mode runs eagerly because they differ."""
    keys = set()
    for b in batches[1:]:
        dfs = ti.plan_full(b[:q])[1]
        keys.add(tuple((dfs.max(axis=0) + block - 1) // block))
    say(f"exact mode: {len(keys)} distinct max_df window keys over "
        f"{len(batches) - 1} batches of {q}")
    return dict(batches=len(batches) - 1, distinct_keys=len(keys))


def oracle_table(oseg, terms):
    """One query's oracle: its top K2 + 1 hits and found count
    (oracle_search_vec), and every doc's f32 score, accumulated as the
    oracle accumulates (term order, multiply then add)."""
    import numpy as np

    from nextsearch_tpu_torch.index.oracle import oracle_posting_scores, oracle_search_vec

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
    from nextsearch_tpu_torch.index.planner import QueryResult

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
    rows = ti.dense_rows
    kern = {"gather_bf16_rows": dict(
        max_abs_err=0.0,
        ms=timed(lambda: hk.gather_bf16_rows(ids, rows), device, reps),
        plain_ms=timed(lambda: hk.gather_rows_ref(ids, rows), device, reps),
        library_ms=timed(lambda: torch.index_select(rows, 0, ids), device, reps),
        **bound(nbytes(ids, got)
                + int(torch.unique(ids).numel()) * ti.n_slots * 2))}
    k1 = hk.heavy_fused3(mix_c, got, fast=False)
    err = _heavy_check("K1 exact over bf16 rows", k1,
                       hk.heavy_fused3_ref(mix_c, got, fast=False), 1e-6)
    kern["heavy_fused3_bf16_rows"] = dict(
        max_abs_err=err,
        ms=timed(lambda: hk.heavy_fused3(mix_c, got, fast=False), device, reps),
        plain_ms=timed(lambda: hk.heavy_fused3_ref(mix_c, got, fast=False),
                       device, reps),
        library_ms=heavy_library_ms(mix_c, got, False, device, reps),
        **heavy_bound(mix_c, got, False, k1))
    say(f"K3/K1 over bf16 rows: uc={ids.numel()} " + " ".join(
        f"{n}.{k}={x:.6g}" if isinstance(x, float) else f"{n}.{k}={x}"
        for n, v in kern.items() for k, x in v.items()))
    del got, k1, mix_c, ids

    memo: dict = {}
    total = dict.fromkeys(KERNELS, 0)
    info = dict(n_dense=ti.n_dense, hbm_bytes=hbm["total"], peak_allocated=peak)

    def run(label, expect, launch, graphed=True):
        if graphed:
            warm(ti, spot)
        reset_counts()
        t = time.perf_counter()
        res = launch()
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        near, exempt = bf16_gate(ti, oseg, spot[:SPOT], res[:SPOT], memo)
        expect = with_lists(expect)
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
        lambda: unpack(ps.launch(ti, raw, C), len(spot)), graphed=False)
    counts, perf = serving_loop(ti, batches, device, loop_secs, "bf16 rows",
                                card)
    for name, c in counts.items():
        total[name] += c
    info.update(perf)
    del ti
    return total, kern, info


def fast_mode_check(ti, oracle_segs, queries, results):
    """Fast mode against the oracle's top K + 1: `found` equal; scores
    within rtol 1e-5 rank by rank (one scatter whose atomic adds land in
    any order; the tolerance of the JAX package's own fast-mode test); the
    doc equal at every rank whose oracle score stands more than 2 * rtol
    apart from both its neighbours' (closer ones may swap ranks). Returns
    (ranks checked, ranks exempted from the doc comparison as near-ties)."""
    import numpy as np

    from nextsearch_tpu_torch.index.oracle import oracle_search_vec

    rtol = 1e-5
    ranks = exempt = 0
    for terms, res in zip(queries, results):
        hits, found = oracle_search_vec(oracle_segs, terms, k=K + 1)
        n = len(res.scores)
        if res.found != found or n != min(len(hits), K):
            raise AssertionError(f"fast mode: found/hits differ for {terms}")
        want = np.array([h[0] for h in hits], np.float32)
        if not np.allclose(res.scores, want[:n], rtol=rtol, atol=0):
            raise AssertionError(f"fast mode: scores differ for {terms}")
        for i in range(n):
            near = any(0 <= j < len(want)
                       and abs(want[j] - want[i]) <= 2 * rtol * want[i]
                       for j in (i - 1, i + 1))
            ranks += 1
            exempt += near
            if not near and ti.locate(int(res.doc_slots[i]))[1] != hits[i][2]:
                raise AssertionError(f"fast mode: doc differs for {terms}")
    return ranks, exempt


def check_epilogue(ti, queries, device, reps: int) -> dict:
    """score_epilogue on the fused launch's own operands for `queries`: the
    light terms' scatter into f32 and into bf16 scores, and the heavy rows'
    f32 product, at the index's n_slots. Each form bit-equal to the plain
    version (the scores' bits, found, tile_max); its median ms beside the
    plain version's (the eager passes it replaced: the cast, the add, the
    count and the tile max) and the bound of its bytes (S read, H read, S
    written, found and tile_max written); then the found-only form of
    exact and fast mode on the f32 scores (S read, found written)."""
    import torch

    from nextsearch_tpu_torch.ops import bm25
    from nextsearch_tpu_torch.ops import score_kernels as se

    starts, _dfs, weights, light_dfs, uh, mix = ti.plan_full(queries)
    block = ti.config.device.posting_block
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    chunks = bm25.expand_chunks(up(starts), up(light_dfs), up(weights),
                                C=ti._chunk_budget(light_dfs, block),
                                block=block)
    h = bm25.heavy_scores(ti.dense_rows, up(uh), up(mix))
    out = dict(max_abs_err=0.0, library_ms=None, q=len(queries),
               n_slots=ti.n_slots)
    for label, dtype in (("", torch.float32), ("bf16_", torch.bfloat16)):
        sc = bm25.scatter_scores(ti.post_doc, ti.post_score, *chunks,
                                 Q=len(queries), n_slots=ti.n_slots,
                                 block=block, dtype=dtype)
        ib = torch.int16 if dtype == torch.bfloat16 else torch.int32
        got = sc.clone()
        found, tmax = se.score_epilogue(got, h)
        rfound, rmax = se.score_epilogue_ref(sc, h)
        if not (torch.equal(got.view(ib), sc.view(ib))
                and torch.equal(found, rfound)
                and torch.equal(tmax.view(ib), rmax.view(ib))):
            raise AssertionError(f"score_epilogue {dtype} is not bit-exact "
                                 "on the fused batch")
        del got, rfound, rmax
        # each timed call adds H again: the values grow, the work does not
        out.update(prefixed(label, dict(
            ms=timed(lambda: se.score_epilogue(sc, h), device, reps),
            plain_ms=timed(lambda: se.score_epilogue_ref(sc, h), device, reps),
            **bound(2 * nbytes(sc) + nbytes(h, found, tmax)))))
        if not label:
            f_only, _ = se.score_epilogue(sc, tiles=False)
            if not torch.equal(f_only, se.score_epilogue_ref(sc, tiles=False)[0]):
                raise AssertionError("score_epilogue's found-only form is "
                                     "not exact on the fused batch")
            out.update(prefixed("found_only_", dict(
                ms=timed(lambda: se.score_epilogue(sc, tiles=False), device,
                         reps),
                plain_ms=timed(lambda: se.score_epilogue_ref(sc, tiles=False),
                               device, reps),
                **bound(nbytes(sc, f_only)))))
        del sc
    say("score_epilogue on the fused batch (f32 and bf16 scores, the "
        "found-only form), bit-exact: " + fmt(out))
    return out


def fused_phase(oracle_segs, device, n_docs, vocab, n_batches, loop_secs, card,
                reps, sem):
    """The library default on the card: a fused-mode TorchIndex over the
    bench corpus at bench.py's fused configuration. K3 at this path's
    shapes against its plain version and index_select, and score_epilogue
    on the spot batch's operands (check_epilogue); one batch-512 launch
    spot-checked bit-exact with K3 and score_epilogue launched once each;
    the pipelined loop; one batch of 64 in exact mode (bit-exact, run twice
    for the same bits) and in fast mode (fast_mode_check), both at the
    library's posting block of 2048, each launching score_epilogue once;
    then one hybrid batch of 128 over this index (the fused handle) under
    hybrid_gate. Returns (launch totals, K3's numbers here,
    score_epilogue's, loop numbers)."""
    import numpy as np
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _seg, ti, batches = build_index(device, n_docs, vocab, BATCH, n_batches,
                                    mode="fused")
    hbm = ti.hbm_bytes()
    say(f"[{card}] fused index: n_dense={ti.n_dense} bytes: "
        + " ".join(f"{k}={v}" for k, v in hbm.items()))
    spot = batches[0]
    total = dict.fromkeys(KERNELS, 0)
    memo: dict = {}

    # K3 on this path's operands: the batch's unique rows, padded with the
    # zero row up to the pinned U
    ids = torch.as_tensor(ti.plan_full(spot)[4], device=device)
    rows = ti.dense_rows
    got = hk.gather_rows(ids, rows)
    if not torch.equal(got, hk.gather_rows_ref(ids, rows)):
        raise AssertionError("K3 on the fused path is not bit-exact")
    k3 = dict(
        ids=ids.numel(),
        ms=timed(lambda: hk.gather_rows(ids, rows), device, reps),
        plain_ms=timed(lambda: hk.gather_rows_ref(ids, rows), device, reps),
        library_ms=timed(lambda: torch.index_select(rows, 0, ids), device, reps),
        **bound(nbytes(ids, got)
                + int(torch.unique(ids).numel()) * ti.n_slots * 4))
    del got
    say("K3 on the fused path: " + fmt(k3))
    ep = check_epilogue(ti, spot, device, reps)

    def run(label, queries, expect, check):
        warm(ti, queries)
        reset_counts()
        t = time.perf_counter()
        res = ti.search_batch(queries, k=K)
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        check(queries[:SPOT], res[:SPOT])
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts} != {expect}")
        for name, c in counts.items():
            total[name] += c
        say(f"launch {label}: {dt * 1e3:.1f} ms, {min(SPOT, len(queries))} "
            f"queries pass, launches {counts}")
        return res

    exact_check = lambda q, r: spot_check(ti, oracle_segs, q, r, memo)  # noqa: E731
    cfg = ti.config
    fused_kernels = {"gather_rows": 1, "score_epilogue": 1}
    try:
        run("(m) fused, batch 512", spot, fused_kernels, exact_check)
        counts, perf = serving_loop(ti, batches, device, loop_secs, "fused",
                                    card)
        n_batches_run = counts["gather_rows"]
        if n_batches_run <= 0 or launched(counts) != dict.fromkeys(
                fused_kernels, n_batches_run):
            raise AssertionError(f"fused loop launches: {launched(counts)}")
        for name, c in counts.items():
            total[name] += c
        counts, graphs = graphs_path(ti, oracle_segs, batches, device, card,
                                     "fused")
        for name, c in counts.items():
            total[name] += c
        perf["graphs"] = graphs
        perf["reloads"] = reload_memory(ti, batches, device, card)
        perf["exact_keys"] = exact_window_keys(ti, batches)
        small = spot[:64]
        _config(ti, cfg, mode="exact", posting_block=2048)
        first = run("(n) exact, batch 64", small, {"score_epilogue": 1},
                    exact_check)
        again = ti.search_batch(small, k=K)
        if not all(a.found == b.found
                   and np.array_equal(a.scores.view(np.uint32),
                                      b.scores.view(np.uint32))
                   and np.array_equal(a.doc_slots, b.doc_slots)
                   for a, b in zip(first, again)):
            raise AssertionError("exact mode: two runs differ")
        _config(ti, cfg, mode="fast", posting_block=2048)
        run("(o) fast, batch 64", small, {"score_epilogue": 1}, lambda q, r: say(
            "fast mode: %d ranks, %d near-ties exempt from the doc comparison"
            % fast_mode_check(ti, oracle_segs, q, r)))
    finally:
        ti.config = cfg
    from nextsearch_tpu_torch.models.hybrid import HybridIndex

    hy = HybridIndex(ti, sem, beta=0.5)
    queries = spot[:HYBRID_BATCH]
    hy.search_batch(queries, k=K, candidates=CANDIDATES)  # its graph
    reset_counts()
    res = hy.search_batch(queries, k=K, candidates=CANDIDATES)
    counts = launched(launch_counts())
    if counts != fused_kernels:
        raise AssertionError(f"(t) hybrid over the fused index: launches {counts}")
    for name, c in counts.items():
        total[name] += c
    hybrid_gate(hy, queries[:16], res[:16])
    say(f"(t) hybrid over the fused index: a batch of {HYBRID_BATCH}, 16 pass "
        f"the gate; launches {counts}")
    del hy
    perf.update(n_dense=ti.n_dense, hbm_bytes=hbm["total"])
    del ti
    return total, k3, ep, perf


# ---------------------------------------------------------------- models:
# autocomplete, semantic expansion and the hybrid rerank on the bench index

EMB_DIM = 128  # the reference's hybrid evaluation (benchmarks/eval_configs.py)
EMB_SIGMA = 0.65  # in-cluster cosine about 1 / (1 + sigma^2) = 0.70
NEAR = 2e-6  # similarity gaps where two summation orders may disagree
HYBRID_BATCH = 128  # the reference's hybrid serving batch (eval_configs.py)
MODEL_LOOP_SECS = 3.0  # the expanded and hybrid loops
CANDIDATES = 100  # config.HybridConfig.candidates


def df_ranked_terms(seg):
    """The segment's terms by df, highest first (ties by term index)."""
    import numpy as np

    return [seg.terms[i] for i in np.argsort(-seg.term_df, kind="stable")]


def clustered_vectors(n: int, dim: int = EMB_DIM, seed: int = 7):
    """n vectors, 8 to a cluster in order (vector i in cluster i // 8):
    centre + EMB_SIGMA * noise, so in-cluster cosines are about 0.7 and
    cross-cluster ones 0 +- 0.09, far below the expansion floor 0.55."""
    import numpy as np

    r = np.random.default_rng(seed)
    centres = r.standard_normal((n // 8 + 1, dim), dtype=np.float32)
    noise = r.standard_normal((n, dim), dtype=np.float32)
    return centres[np.arange(n) // 8] + np.float32(EMB_SIGMA) * noise


def suggest_reference(ac, inputs, limit):
    """Each input's suggestions from the host range top-k (score desc, term
    asc) over its whole prefix range."""
    from nextsearch_tpu_torch.models.autocomplete import split_last_token
    from nextsearch_tpu_torch.utils.textutil import normalize_token

    out = []
    for s in inputs:
        base, last = split_last_token(s)
        prefix = normalize_token(last)
        lo, hi = ac.prefix_range(prefix) if prefix else (0, 0)
        out.append([base + ac.terms[c] for c in ac._host_range_topk(lo, hi, limit)]
                    if lo < hi else [])
    return out


def autocomplete_phase(seg, device, card, reps):
    """(p) AutocompleteIndex over the bench lexicon (df summed, as reload
    builds it): 512 prefixes of lengths 1-7 through the per-prefix cache
    and host ranges; then, on an instance with PRECOMP_LEN = NARROW_RANGE =
    0, those whose range fits the widest window through the window top-k
    on the card and the wider ones through the full-table top-k. Every
    answer entry for entry against the host range top-k; ms per batch of
    each path (host clock, results on the host)."""
    import numpy as np

    from nextsearch_tpu_torch.models import autocomplete as am
    from nextsearch_tpu_torch.ops import prefix as pops

    scores: dict = {}
    for t, df in zip(seg.terms, seg.term_df):
        scores[t] = scores.get(t, 0) + int(df)
    r = np.random.default_rng(13)
    ranked = df_ranked_terms(seg)
    picks = r.integers(0, min(len(ranked), 50_000), 512)
    lens = r.integers(1, 8, 512)
    inputs = [("what is " if i % 5 == 0 else "") + ranked[p][:n]
              for i, (p, n) in enumerate(zip(picks, lens))]
    t = time.perf_counter()
    ac = am.AutocompleteIndex(device=device)
    ac.build(scores, 10)
    build_s = time.perf_counter() - t
    bare = am.AutocompleteIndex(device=device)
    bare.PRECOMP_LEN = bare.NARROW_RANGE = 0
    bare.build(scores, 10)
    top = am.AutocompleteIndex.WINDOW_BUCKETS[-1]
    width = {}
    for s in inputs:
        lo, hi = ac.prefix_range(s.split()[-1])
        width[s] = hi - lo
    narrow = [s for s in inputs if width[s] <= top]
    wide = [s for s in inputs if width[s] > top]
    out = dict(terms=len(ac.terms), build_s=build_s)
    with mock.patch.object(am, "prefix_window_topk",
                           wraps=pops.prefix_window_topk) as win, \
            mock.patch.object(am, "prefix_range_topk",
                              wraps=pops.prefix_range_topk) as full:
        for key, label, index, batch, want in (
                ("cached", "per-prefix cache and host ranges", ac, inputs,
                 (0, 0)),
                ("window", "window top-k on the card", bare, narrow, (1, 0)),
                ("full_table", "full-table top-k on the card", bare, wide,
                 (0, 1))):
            win.reset_mock()
            full.reset_mock()
            got = index.suggest_batch(batch, 10)
            if (win.call_count, full.call_count) != want:
                raise AssertionError(f"(p) {label}: launches "
                                     f"{win.call_count, full.call_count}")
            if got != suggest_reference(index, batch, 10) or not all(got):
                raise AssertionError(f"(p) {label}: differs from the host "
                                     "range top-k")
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                index.suggest_batch(batch, 10)
                times.append((time.perf_counter() - t) * 1e3)
            out[f"{key}_ms"] = statistics.median(times)
            out[f"{key}_prefixes"] = len(batch)
            say(f"[{card}] (p) autocomplete, {label}: {len(batch)} prefixes "
                f"equal the host range top-k; {out[key + '_ms']:.3f} ms per "
                "batch")
    say(f"(p) autocomplete index: {len(ac.terms)} terms, built in "
        f"{build_s:.2f} s; prefix ranges {min(width.values())}-"
        f"{max(width.values())} wide")
    return out


def semantic_index(seg, device):
    """(q) SemanticIndex over clustered vectors: the term of df rank r in
    cluster r // 8, so a head term's neighbours are head terms."""
    from nextsearch_tpu_torch.models.semantic import SemanticIndex

    ranked = df_ranked_terms(seg)
    t = time.perf_counter()
    sem = SemanticIndex(device=device)
    if not sem.load_from_arrays(ranked, clustered_vectors(len(ranked))):
        raise AssertionError("(q) load_from_arrays refused the vectors")
    sem.emb  # placed on the card
    say(f"(q) embeddings: {len(sem.terms)} terms x {sem.dim} (clusters of 8 "
        f"by df rank), loaded in {time.perf_counter() - t:.2f} s")
    return sem


def expander(ti, sem, device, tmp):
    """Engine._weighted_terms over the index's configuration and sem, as a
    function of one bench query (its terms with weight 1.0). The Engine
    loads no index; tmp is its (unused) index and cache directory."""
    from nextsearch_tpu_torch.engine import Engine

    eng = Engine(tmp, config=ti.config, cache_dir=tmp, device=device)
    eng.sem = sem
    return lambda q: eng._weighted_terms([t for t, _w in q])


def expansion_check(sem, expand, params, queries):
    """The card's expansions of `queries` against SemanticIndex.expand over
    float64 similarities on the host. A query is exempt (and counted) where
    the two may rank differently: a similarity among its top k + 1 within
    NEAR of the floor or of the next one, or two final weights within NEAR.
    Returns (queries compared, exempt, terms added)."""
    import numpy as np
    import torch

    from nextsearch_tpu_torch.models import semantic as sm

    emb64 = sem._emb_host.astype(np.float64)
    near = []

    def topk_f64(_emb, qvecs, banned, min_sim, *, k):
        sims = qvecs.cpu().numpy().astype(np.float64) @ emb64.T
        sims[:, banned.cpu().numpy()] = -np.inf
        kk = min(k + 1, sims.shape[1])
        vals = np.empty((sims.shape[0], k))
        rows = np.empty((sims.shape[0], k), np.int32)
        for i, row in enumerate(sims):
            part = np.argpartition(-row, kk - 1)[:kk]
            order = part[np.lexsort((part, -row[part]))]
            top = row[order]
            fin = top[np.isfinite(top)]
            if (np.abs(fin - min_sim) < NEAR).any() or (
                    np.abs(np.diff(fin)) < NEAR).any():
                near.append(i)
            vals[i] = np.where(top[:k] < min_sim, -np.inf, top[:k])
            rows[i] = order[:k]
        return torch.from_numpy(vals), torch.from_numpy(rows)

    compared = exempt = added = 0
    cap = params.pop("max_total_terms")
    for q in queries:
        base = [t for t, _w in q]
        near.clear()
        with mock.patch.object(sm, "similarity_topk", topk_f64):
            ref = sem.expand(base, max_total_terms=1 << 30, **params)
        ws = np.array([w for _t, w in ref if w < 1.0])
        if near or (np.abs(np.diff(ws)) < NEAR).any():
            exempt += 1
            continue
        got = expand(q)
        if [t for t, _w in got] != [t for t, _w in ref[:cap]] or not np.allclose(
                [w for _t, w in got], [w for _t, w in ref[:cap]], rtol=0,
                atol=NEAR):
            raise AssertionError(f"(r) expansion of {base} differs from float64")
        compared += 1
        added += len(got) - len(base)
    params["max_total_terms"] = cap
    return compared, exempt, added


def expanded_phase(ti, oracle_segs, batches, sem, device, loop_secs, card,
                   tmp):
    """(r) bench batches expanded through Engine._weighted_terms: one batch
    oracle-exact over its expanded weighted terms, the card's expansions of
    that batch against float64, and a depth-2 loop that expands each batch
    in its requests' time. Returns (launch counts, numbers)."""
    import dataclasses

    import numpy as np
    import torch

    from nextsearch_tpu_torch.benchmarks.bench import Pipeline

    expand = expander(ti, sem, device, tmp)
    spot = batches[0]
    t = time.perf_counter()
    expanded = [expand(q) for q in spot]
    expand_ms = (time.perf_counter() - t) * 1e3
    lens = np.array([len(q) for q in expanded])
    reset_counts()
    res = ti.search_batch(expanded, k=K)
    counts = launch_counts()
    spot_check(ti, oracle_segs, expanded[:SPOT], res[:SPOT], {})
    if not counts["heavy_fused3"]:
        raise AssertionError(f"(r) launches {launched(counts)}")
    params = dataclasses.asdict(ti.config.expansion)
    compared, exempt, added = expansion_check(sem, expand, params, spot)
    if compared < len(spot) // 2 or added == 0:
        raise AssertionError(f"(r) expansion check: {compared} compared, "
                             f"{exempt} exempt, {added} terms added")
    say(f"(r) expanded batch: {len(spot)} queries, {lens.min()}-{lens.max()} "
        f"terms (mean {lens.mean():.2f}), expansion {expand_ms:.1f} ms; "
        f"{SPOT} oracle-exact; expansions equal float64's for {compared} "
        f"queries, {exempt} exempt as near-ties; launches {launched(counts)}")
    trips0, rel0 = ti.rescue_trips, ti.relaunches
    ti.search_batch([expand(q) for q in batches[1]], k=K)  # warm
    reset_counts()
    loop = Pipeline(ti, batches[1:], BATCH, 2,
                    prepare=lambda b: [expand(q) for q in b])
    r = loop.run(min(loop_secs, MODEL_LOOP_SECS), start=0)
    loop_counts = launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    exp_ms = statistics.median(loop.prepare_s) * 1e3
    say(f"[{card}] (r) expanded serving loop: batch {BATCH} depth 2 k {K}: "
        f"qps={r['qps']:.1f} p50_ms={r['p50_req_ms']:.2f} "
        f"expansion_ms_per_batch={exp_ms:.2f} batches={len(loop.lat)} "
        f"host_rescued_queries={ti.rescue_trips - trips0} "
        f"relaunched_batches={ti.relaunches - rel0} "
        f"launches {launched(loop_counts)}")
    for name, c in loop_counts.items():
        counts[name] += c
    return counts, dict(expand_ms_first_batch=expand_ms, mean_terms=float(lens.mean()),
                        compared=compared, exempt=exempt, qps=r["qps"],
                        p50_ms=r["p50_req_ms"], expansion_ms_per_batch=exp_ms)


def dense_blocks(ti, queries, device):
    """How many 64-query blocks of the launch's heavy product hold a query
    with more nonzero heavy entries than the gather takes (GATHER_CUT):
    the blocks K1 runs through its dense kernel, reckoned on the host from
    the launch's own plan; with the compact operands (mix, ids) of the fast
    launch."""
    import torch

    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops.bm25_sparse import heavy_operands

    plan, U = ti.plan_sparse(ti._shortcut_single_heavy(queries, K)[0])
    plan = torch.as_tensor(plan, device=device)
    mix, ids = heavy_operands(plan, ti.dense_rows.shape[0], nd=ti.n_dense, U=U,
                              use_compact=True)
    count = (mix.to(torch.bfloat16) != 0).sum(dim=1).cpu()
    cut = min(mix.shape[1], hk.GATHER_CUT)
    blocks = [int(count[b:b + 64].max()) > cut for b in range(0, len(count), 64)]
    return sum(blocks), len(blocks), int(count.max()), mix, ids


def long_questions_phase(ti, oracle_segs, sem, device, card, reps, tmp):
    """(s) 512 questions of 10 distinct df-head terms (df rank < n_dense),
    expanded to the 40-term cap: the blocks that take K1's dense kernel,
    reckoned from the launch's plan, must be > 0, and the launch must run
    K1; every result oracle-exact under the fast guard. Then K1 alone on
    these operands against its plain version (the dense kernels' tolerance)
    with its time and bound."""
    import numpy as np

    from nextsearch_tpu_torch.ops import heavy_kernels as hk

    expand = expander(ti, sem, device, tmp)
    r = np.random.default_rng(17)
    ranked = df_ranked_terms(ti.segments[0])
    raw = [[(ranked[i], 1.0) for i in r.choice(ti.n_dense, 10, replace=False)]
           for _ in range(BATCH)]
    questions = [expand(q) for q in raw]
    lens = np.array([len(q) for q in questions])
    n_dense_blocks, n_blocks, longest, mix, ids = dense_blocks(
        ti, questions, device)
    trips0, rel0 = ti.rescue_trips, ti.relaunches
    reset_counts()
    t = time.perf_counter()
    res = ti.search_batch(questions, k=K)
    dt = (time.perf_counter() - t) * 1e3
    counts = launch_counts()
    if n_dense_blocks == 0 or not counts["heavy_fused3"]:
        raise AssertionError(f"(s) {n_dense_blocks} dense blocks, launches "
                             f"{launched(counts)}")
    spot_check(ti, oracle_segs, questions, res, {})
    say(f"[{card}] (s) long questions: {BATCH} of 10 head terms expanded to "
        f"{lens.min()}-{lens.max()} terms; heavy entries per query up to "
        f"{longest} (gather cut {hk.GATHER_CUT}), U={mix.shape[1]}; "
        f"{n_dense_blocks} of {n_blocks} 64-query blocks take K1's dense "
        f"kernel; all {BATCH} oracle-exact; search_batch {dt:.1f} ms; "
        f"host_rescued_queries={ti.rescue_trips - trips0} "
        f"relaunched_batches={ti.relaunches - rel0}; launches {launched(counts)}")
    table = hk.gather_rows_bf16(ids, ti.dense_rows)
    got = hk.heavy_fused3(mix, table, fast=True)
    rtol = tc_rtol(mix.shape[1])
    err = _heavy_check("(s) K1 fast, long questions", got,
                       hk.heavy_fused3_ref(mix, table, fast=True), rtol)
    b = heavy_bound(mix, table, True, got)
    del got
    ms = timed(lambda: hk.heavy_fused3(mix, table, fast=True), device, reps)
    plain = timed(lambda: hk.heavy_fused3_ref(mix, table, fast=True), device,
                  max(2, reps // 2))
    library = heavy_library_ms(mix, table, True, device, reps)
    say(f"[{card}] (s) K1 fast on the long questions' operands: {ms:.3f} ms "
        f"({ms / n_blocks:.4f} ms a 64-query block, {n_dense_blocks} of "
        f"{n_blocks} dense), plain {plain:.3f} ms, torch.matmul {library:.3f} "
        f"ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}); max abs err "
        f"{err:.3g} within rtol {rtol:.3g}")
    del table, mix, ids
    return counts, dict(dense_blocks=n_dense_blocks, blocks=n_blocks,
                        max_heavy_entries=longest, k1_ms=ms, k1_plain_ms=plain,
                        k1_library_ms=library, k1_bound_ms=b["bound_ms"],
                        k1_bound_by=b["bound_by"], k1_max_abs_err=err,
                        mean_terms=float(lens.mean()))


def hybrid_gate(hy, queries, results, k=K):
    """Hybrid results against _host_hybrid_row (the exact host BM25 top C
    and the rerank formula over the same doc embeddings): found and doc
    order equal, scores within rtol 2e-5 (cos summed in another order)."""
    import numpy as np

    for q, got in zip(queries, results):
        exp = hy._host_hybrid_row(q, k, CANDIDATES)
        if got.found != exp.found or got.doc_slots.tolist() != exp.doc_slots.tolist():
            raise AssertionError(f"hybrid gate: docs differ for {q}")
        if not np.allclose(got.scores, exp.scores, rtol=2e-5, atol=0):
            raise AssertionError(f"hybrid gate: scores differ for {q}")


def hybrid_phase(ti, batches, sem, device, loop_secs, card):
    """(t) HybridIndex(beta 0.5) over the index: the doc-embedding build,
    the gate on 16 queries, a depth-4 loop of batches of 128 at k 10 and
    100 candidates, and one batch with every heavy row's guard tripped
    (fast_heavy_eps 1e9), which the gather fixes up on the host. Returns
    (launch counts, numbers)."""
    import torch

    from nextsearch_tpu_torch.models.hybrid import HybridIndex

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    hy = HybridIndex(ti, sem, beta=0.5)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t
    hb = [b[i:i + HYBRID_BATCH] for b in batches[1:5]
          for i in range(0, len(b), HYBRID_BATCH)]
    hy.search_batch(hb[0], k=K, candidates=CANDIDATES)  # warm
    gate_q = hb[1][:16]
    hybrid_gate(hy, gate_q, hy.search_batch(gate_q, k=K, candidates=CANDIDATES))
    reset_counts()
    window, n, li = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min(loop_secs, MODEL_LOOP_SECS) or not n:
        window.append(hy.search_batch_async(hb[li % len(hb)], K, CANDIDATES))
        li += 1
        if len(window) > 4:
            hy.search_batch_gather(window.pop(0))
            n += HYBRID_BATCH
    while window:
        hy.search_batch_gather(window.pop(0))
        n += HYBRID_BATCH
    qps = n / (time.perf_counter() - t0)
    counts = launch_counts()
    say(f"[{card}] (t) hybrid over the sparse index: doc embeddings "
        f"{tuple(hy.doc_emb.shape)} built in {build_s:.2f} s; 16 queries "
        f"pass the gate; loop batch {HYBRID_BATCH} depth 4 k {K} candidates "
        f"{CANDIDATES}: qps={qps:.1f} batches={li}; launches {launched(counts)}")
    cfg = ti.config
    rel0, trips0 = ti.relaunches, ti.rescue_trips
    try:
        _config(ti, cfg, fast_heavy_eps=1e9)
        h = hy.search_batch_async(hb[2], K, CANDIDATES)
        tripped = int((h[3].device_outs[4][:HYBRID_BATCH] < 0.5).sum())
        res = hy.search_batch_gather(h)
    finally:
        ti.config = cfg
    hybrid_gate(hy, hb[2][:16], res[:16])
    if tripped == 0 or ti.relaunches != rel0 or ti.rescue_trips != trips0:
        raise AssertionError(f"(t) forced trip: {tripped} rows tripped")
    say(f"(t) forced guard trip: {tripped} of {HYBRID_BATCH} rows fixed up on "
        "the host, no relaunch; 16 pass the gate")
    del hy
    return counts, dict(doc_emb_build_s=build_s, qps=qps, tripped_rows=tripped)


def models_phase(ti, seg, oracle_segs, batches, device, loop_secs, card, reps):
    """Phases (p)-(t) on the sparse bench index. Returns (launch totals,
    numbers, the SemanticIndex)."""
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, c in counts.items():
            total[name] += c

    out = dict(autocomplete=autocomplete_phase(seg, device, card, reps))
    sem = semantic_index(seg, device)
    with tempfile.TemporaryDirectory() as tmp:
        counts, out["expanded"] = expanded_phase(
            ti, oracle_segs, batches, sem, device, loop_secs, card, tmp)
        add(counts)
        counts, out["long_questions"] = long_questions_phase(
            ti, oracle_segs, sem, device, card, reps, tmp)
        add(counts)
    counts, out["hybrid"] = hybrid_phase(ti, batches, sem, device, loop_secs,
                                         card)
    add(counts)
    for name in ("heavy_fused3", "gather_rows_bf16", "mix_lists"):
        if total[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in (r)-(t)")
    return total, out, sem


# ---------------------------------------------------------------- sharded:
# the (dp, seg) mesh backend (nextsearch_tpu_torch/parallel/) on the bench
# corpus

U2_SHARDS = 4
PAIR_SECS = 2.0  # each loop of (u1)'s TorchIndex/sharded pairs


def doc_range_segments(seg, n: int):
    """The segment cut into n segments of consecutive doc ranges (docs
    [i N / n, (i + 1) N / n), renumbered from 0), each with its own N,
    avgdl and eager scores, as an index of n segments holds them."""
    import numpy as np

    from nextsearch_tpu_torch.index.builder import SegmentArrays, eager_scores

    vocab = len(seg.terms)
    term_of = np.repeat(np.arange(vocab, dtype=np.int32),
                        seg.term_df.astype(np.int64))
    cuts = [seg.N * i // n for i in range(n + 1)]
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        keep = (seg.post_doc >= lo) & (seg.post_doc < hi)
        df = np.bincount(term_of[keep], minlength=vocab).astype(np.int32)
        offs = np.zeros(vocab + 1, np.int64)
        np.cumsum(df, out=offs[1:])
        doc_len = seg.doc_len[lo:hi].copy()
        part = SegmentArrays(
            terms=seg.terms, term_df=df, term_offsets=offs,
            post_doc=(seg.post_doc[keep] - lo).astype(np.int32),
            post_tf=seg.post_tf[keep], doc_len=doc_len, N=hi - lo,
            avgdl=float(np.float32(doc_len.sum()) / np.float32(hi - lo)),
            cord_uids=seg.cord_uids[lo:hi])
        part.post_score = eager_scores(part)
        out.append(part)
    return out


def same_as_single(si, ti, got, want, label):
    """Sharded results equal TorchIndex's for the same batch: scores bit
    for bit, (segment, doc) by locate, found."""
    import numpy as np

    for qi, (a, b) in enumerate(zip(got, want)):
        if (a.found != b.found
                or not np.array_equal(a.scores.view(np.uint32),
                                      b.scores.view(np.uint32))
                or [si.locate(int(x)) for x in a.doc_slots]
                != [ti.locate(int(x)) for x in b.doc_slots]):
            raise AssertionError(f"{label}: query {qi} differs from TorchIndex")


def traced_ms(index, batches, device, n: int = 10):
    """Device ms per batch of n serial batches (the union of the trace's
    kernel, memcpy and memset intervals: profile_paths.py's reading), or
    None off the card."""
    if device.type != "cuda":
        return None
    import profile_paths

    def serial():
        for b in batches[1:1 + n]:
            index.search_batch(b, k=K)

    return profile_paths.traced(serial, n)["device_ms_per_batch"]


def merge_ms(si, queries, device, reps):
    """Device ms of one batch's merge: merge_shards timed on the parts that
    a real launch of `queries` handed it (the shards' candidates on the
    merge device: a cat, the canonical sort, the found sum and guard min)."""
    from nextsearch_tpu_torch.parallel import sharded as sh

    seen = []
    real = sh.merge_shards

    def capture(parts, **kw):
        seen.append((parts, kw))
        return real(parts, **kw)

    with mock.patch.object(sh, "merge_shards", capture):
        si.search_batch(queries, k=K)
    parts, kw = seen[0]
    return timed(lambda: real(parts, **kw), device, reps), parts[0][0].shape


def sharded_launches(si, oracle_segs, spot, total, memo, want=None, ti=None):
    """A launch runner for phase (u): one batch through search_batch, the
    launch counts reset before and read after, SPOT queries spot-checked
    against the oracle, all of them against TorchIndex's `want` if given."""
    def run(label, *expect, queries=None, relaunch=False):
        queries = spot if queries is None else queries
        caps = warm(si, queries)
        r0, trips0 = si.relaunches, si.rescue_trips
        reset_counts()
        t = time.perf_counter()
        res = si.search_batch(queries, k=K)
        dt = time.perf_counter() - t
        counts = launched(launch_counts())
        no_capture(si, caps, label)
        run.rescued = si.rescue_trips - trips0
        if relaunch and si.relaunches != r0 + 1:
            raise AssertionError(f"{label}: did not relaunch")
        spot_check(si, oracle_segs, queries[:SPOT], res[:SPOT], memo)
        if want is not None:
            same_as_single(si, ti, res, want, label)
        expect = [with_lists(e) for e in expect]
        if counts not in expect:
            raise AssertionError(f"{label}: launches {counts} not in {expect}")
        for name, c in counts.items():
            total[name] += c
        say(f"launch {label}: {dt * 1e3:.1f} ms, {min(SPOT, len(queries))} "
            f"queries oracle-exact"
            + (f", all {len(queries)} equal to TorchIndex's" if want else "")
            + f", launches {counts}")
        return res
    return run


def sharded_1x1(ti, seg, oseg, batches, device, loop_secs, card, main_qps,
                reps):
    """(u1) a (1,1) mesh on the card at the bench sparse configuration,
    pinned from the same batches: launches (a) guarded fast, (b) fast off,
    (c) a forced trip of more than 8 queries that relaunches K1 over the
    full table, each oracle-exact and equal to TorchIndex's results; the
    device ms per batch; depth-2 loops beside the main path's, and paired
    with TorchIndex's in turns (TorchIndex, sharded, sharded, TorchIndex)
    so that both meet the same host."""
    import torch

    from nextsearch_tpu_torch.parallel import ShardedIndex, make_mesh

    t = time.perf_counter()
    si = ShardedIndex([seg], make_mesh(1, 1, devices=[device]), config=ti.config)
    build_s = time.perf_counter() - t
    pins = si.pin_shapes(batches, scope_q=True)
    say(f"(u1) sharded (1,1): capacity {si.shard_capacity} n_dense "
        f"{si.per_shard_rows} n_light {si.n_light} built in {build_s:.1f} s; "
        f"pins {pins}")
    spot = batches[0]
    want = ti.search_batch(spot, k=K)
    total = dict.fromkeys(KERNELS, 0)
    run = sharded_launches(si, [oseg], spot, total, {}, want, ti)
    k1, k2, k3 = "heavy_fused3", "gather_rows_bf16", "gather_rows"
    cfg = si.config
    try:
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            run("(u1a) (1,1) guarded fast", {k1: 1, k2: 1}, {k1: 2, k2: 1})
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(u1b) (1,1) compact exact", {k1: 1, k3: 1})
            _config(si, cfg, fast_heavy_eps=1e9)
            run("(u1c) (1,1) tripped -> full-table exact relaunch",
                {k1: 2, k2: 1}, relaunch=True)
    finally:
        si.config = cfg
    dev_ms = traced_ms(si, batches, device)
    counts, loop = serving_loop(si, batches, device, loop_secs,
                                "sharded (1,1)", card)
    for name, c in counts.items():
        total[name] += c
    overhead = (main_qps - loop["qps"]) / main_qps * 100.0
    say(f"[{card}] (u1) sharded (1,1) loop qps={loop['qps']:.1f} beside the "
        f"main path's default loop qps={main_qps:.1f}: overhead "
        f"{overhead:.2f}%; device ms per batch "
        + ("not measured" if dev_ms is None else f"{dev_ms:.3f}"))
    paired = {"TorchIndex": [], "sharded": []}
    for label, index in (("TorchIndex", ti), ("sharded", si), ("sharded", si),
                         ("TorchIndex", ti)):
        counts, r = serving_loop(index, batches, device, PAIR_SECS,
                                 f"paired {label}", card)
        if index is si:
            for name, c in counts.items():
                total[name] += c
        paired[label].append(r["qps"])
    q_ti, q_si = (statistics.mean(paired[k]) for k in ("TorchIndex", "sharded"))
    paired_overhead = (q_ti - q_si) / q_ti * 100.0
    say(f"[{card}] (u1) paired loops (TorchIndex, sharded, sharded, "
        f"TorchIndex): TorchIndex {paired['TorchIndex']} sharded "
        f"{paired['sharded']} QPS: overhead {paired_overhead:.2f}%")
    del si
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return total, dict(build_s=build_s, qps=loop["qps"], main_qps=main_qps,
                       overhead_pct=overhead, p50_ms=loop["p50_ms"],
                       stream_span_ms_per_batch=loop["stream_span_ms_per_batch"],
                       device_ms_per_batch=dev_ms,
                       peak_reserved=loop["peak_reserved"],
                       paired_qps=paired, paired_overhead_pct=paired_overhead)


def sharded_1x4(seg, batches, device, card, reps):
    """(u2) a (1,4) mesh with all four shards on the one card, over the
    bench corpus cut by doc range into four 250k-doc segments, at the bench
    sparse configuration (each shard's dense rows built on the card):
    the guarded fast launch and a forced trip of at most 8 queries (host
    rescue), oracle-exact across the merge, the device ms per batch and the
    merge's; then a fused-mode index at bench.py's fused configuration and
    one batch oracle-exact with K3 launched once per shard."""
    import torch

    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.parallel import ShardedIndex, make_mesh

    t = time.perf_counter()
    segs = doc_range_segments(seg, U2_SHARDS)
    osegs = [s.to_oracle_segment() for s in segs]
    cut_s = time.perf_counter() - t
    mesh = make_mesh(1, U2_SHARDS, devices=[device] * U2_SHARDS)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if cuda else 0
    common = dict(posting_block=64, heavy_buckets=(512,), rescore_margin=32)
    t = time.perf_counter()
    si = ShardedIndex(segs, mesh, config=EngineConfig(device=DeviceConfig(
        mode="sparse", dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30,
        **common)))
    build_s = time.perf_counter() - t
    pins = si.pin_shapes(batches, scope_q=True)
    hbm = si.hbm_bytes()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    say(f"[{card}] (u2) sharded (1,4) on one card: {U2_SHARDS} segments of "
        f"{[s.N for s in segs]} docs (cut in {cut_s:.1f} s); capacity "
        f"{si.shard_capacity} n_dense per shard {si.per_shard_rows} n_light "
        f"{si.n_light}; built in {build_s:.1f} s; index bytes "
        + " ".join(f"{k}={v}" for k, v in hbm.items())
        + f"; allocated before {base}, peak {peak}; pins {pins}")
    spot = batches[0]
    total = dict.fromkeys(KERNELS, 0)
    memo: dict = {}
    run = sharded_launches(si, osegs, spot, total, memo)
    k1, k2, k3 = "heavy_fused3", "gather_rows_bf16", "gather_rows"
    S = U2_SHARDS
    cfg = si.config
    try:
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            run("(u2a) (1,4) guarded fast", {k1: S, k2: S}, {k1: 2 * S, k2: S})
            _config(si, cfg, fast_heavy_eps=1e9)
            r0 = si.relaunches
            run("(u2b) (1,4) forced trip, host rescue", {k1: S, k2: S},
                queries=[q for q in spot if len(q) > 1][:8])
            if run.rescued == 0 or si.relaunches != r0:
                raise AssertionError("(u2b) no host rescue")
            say(f"(u2b) {run.rescued} of 8 queries tripped and were rescued "
                f"on the host ({si.rescue_ms:.1f} ms in all)")
    finally:
        si.config = cfg
    dev_ms = traced_ms(si, batches, device)
    m_ms, m_shape = merge_ms(si, spot, device, reps)
    say(f"[{card}] (u2) device ms per batch "
        + ("not measured" if dev_ms is None else f"{dev_ms:.3f}")
        + f"; merge of {S} x {tuple(m_shape)} candidates {m_ms:.4f} ms a batch")
    out = dict(segments=[s.N for s in segs], n_dense=si.per_shard_rows,
               n_light=si.n_light, build_s=build_s, hbm_bytes=hbm["total"],
               allocated_before=base, peak_allocated=peak,
               device_ms_per_batch=dev_ms, merge_ms=m_ms)
    del si
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    sf = ShardedIndex(segs, mesh, config=EngineConfig(device=DeviceConfig(
        mode="fused", dense_df_ratio=1 / 256, dense_max_bytes=2 << 30,
        **common)))
    sf.pin_shapes(batches, scope_q=True)
    say(f"(u2) fused sharded (1,4): n_dense per shard {sf.per_shard_rows}, "
        f"built in {time.perf_counter() - t:.1f} s")
    run = sharded_launches(sf, osegs, spot, total, memo)
    run("(u2c) (1,4) fused", {k3: S, "score_epilogue": S})
    out["fused_device_ms_per_batch"] = traced_ms(sf, batches, device, n=4)
    del sf
    if cuda:
        torch.cuda.empty_cache()
    return total, out


def sharded_phase(ti, seg, oseg, batches, device, loop_secs, card, main_qps,
                  reps):
    """Phase (u): (u1) the (1,1) mesh beside TorchIndex, (u2) the (1,4) mesh
    on one card, (u3) dryrun_multichip(4) over the cards. Returns (launch
    totals, numbers)."""
    from nextsearch_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    total, u1 = sharded_1x1(ti, seg, oseg, batches, device, loop_secs, card,
                            main_qps, reps)
    counts, u2 = sharded_1x4(seg, batches, device, card, reps)
    for name, c in counts.items():
        total[name] += c
    reset_counts()
    t = time.perf_counter()
    u3 = dryrun_multichip(4, device=device.type)
    counts = launched(launch_counts())
    u3["seconds"] = time.perf_counter() - t
    say(f"(u3) dryrun_multichip(4): toy and production passes oracle-exact "
        f"on {u3['meshes']} over {u3['devices']}; launches {counts}")
    for name, c in counts.items():
        total[name] += c
    for name in ("heavy_fused3", "gather_rows_bf16", "gather_rows", "mix_lists",
                 "score_epilogue"):
        if total[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in (u)")
    say(f"[{card}] phase (u) sharded: {time.perf_counter() - t0:.1f}s")
    return total, dict(u1=u1, u2=u2, u3=u3)


def _host_mem() -> dict:
    """The process's resident host memory (/proc/self/status VmRSS, where
    there is one) and its peak since the process started (getrusage), GiB."""
    import resource

    out = {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                out["rss"] = int(line.split()[1]) / (1 << 20)
    except OSError:
        pass
    return out


def _same_results(got, want, label, against="the main index"):
    import numpy as np

    for qi, (a, b) in enumerate(zip(got, want)):
        if a.found != b.found or not np.array_equal(
                np.asarray(a.scores, np.float32).view(np.uint32),
                np.asarray(b.scores, np.float32).view(np.uint32)) or \
                not np.array_equal(a.doc_slots, b.doc_slots):
            raise AssertionError(f"{label}: query {qi} differs from {against}")


def _guarded_launch(index, ti, oracle_segs, batch, memo, label):
    """One guarded fast launch (K2 + K1) of `batch` on `index`: oracle-exact
    on SPOT queries and bit-equal to the main index `ti`'s results."""
    warm(index, batch)
    reset_counts()
    res = index.search_batch(batch, k=K)
    counts = launched(launch_counts())
    expect = [with_lists({"heavy_fused3": 1, "gather_rows_bf16": 1}),
              with_lists({"heavy_fused3": 2, "gather_rows_bf16": 1})]
    if counts not in expect:
        raise AssertionError(f"{label}: launches {counts} not in {expect}")
    spot_check(index, oracle_segs, batch[:SPOT], res[:SPOT], memo)
    _same_results(res, ti.search_batch(batch, k=K), label)
    say(f"{label}: guarded fast launch oracle-exact ({SPOT} queries) and "
        f"bit-equal to the main index ({len(batch)} queries); launches {counts}")
    return counts


def build_paths_phase(ti, seg, oracle_segs, batches, device, card):
    """(v1) a TorchIndex whose light table and row top-k are built on the
    card (NEXTSEARCH_LIGHT_BUILD=device, NEXTSEARCH_ROW_TOPK_BUILD=device)
    and (v2) one whose dense rows are built on the host and uploaded once
    (NEXTSEARCH_DEVICE_BUILD=0), each held to the main index `ti` (host
    light table and row top-k, device dense rows). Returns the launch
    counts and the build seconds of each path."""
    import numpy as np
    import torch

    from nextsearch_tpu_torch.index.segment import TorchIndex

    total = dict.fromkeys(KERNELS, 0)
    memo: dict = {}
    out: dict = {}
    base = ti.build_phases
    with mock.patch.dict(os.environ, NEXTSEARCH_LIGHT_BUILD="device",
                         NEXTSEARCH_ROW_TOPK_BUILD="device"):
        t0 = time.perf_counter()
        t1 = TorchIndex([seg], config=ti.config, device=device)
        build_s = time.perf_counter() - t0
    if not torch.equal(t1.light_bucket_pos, ti.light_bucket_pos):
        raise AssertionError("(v1) device light table != host light table")
    if t1._bs_depth != ti._bs_depth:
        raise AssertionError(f"(v1) bs_depth {t1._bs_depth} != {ti._bs_depth}")
    (v, s), (hv, hs) = t1._row_topk, ti._row_topk
    full = (hs < 2**30).all(axis=1)  # rows whose df >= k
    if not np.array_equal(v[full].view(np.uint32), hv[full].view(np.uint32)):
        raise AssertionError("(v1) device row top-k values != host values")
    # slots: equal above each row's last value; a tie run that crosses lane
    # k is cut by the host path's argpartition at any of its members
    above = hv[full] > hv[full][:, -1:]
    if not np.array_equal(s[full][above], hs[full][above]):
        raise AssertionError("(v1) device row top-k slots != host slots")
    differ = (s[full] != hs[full])
    same_rows = int((~differ).all(axis=1).sum())
    first_lane = int(differ.argmax(axis=1)[differ.any(axis=1)].min(initial=v.shape[1]))
    say(f"(v1) light table bit-equal ({tuple(t1.light_bucket_pos.shape)}, "
        f"bs_depth {t1._bs_depth}); row top-k {v.shape}: {int(full.sum())} of "
        f"{v.shape[0]} rows have df >= k, values bit-equal, slots equal above "
        f"each row's last value, {same_rows} rows slot-equal throughout; "
        f"the first differing lane of any row is {first_lane}")
    for name, c in _guarded_launch(t1, ti, oracle_segs, batches[0], memo,
                                   "(v1)").items():
        total[name] += c
    row_term = {r: t for t, (_s, _d, r) in ti.lex[0].items() if 0 <= r < 64}
    head = [[(row_term[r], 1.0)] for r in sorted(row_term)]
    reset_counts()
    res = t1.search_batch(head, k=K)
    if launched(launch_counts()):
        raise AssertionError(f"(v1) head queries launched {launch_counts()}")
    spot_check(t1, oracle_segs, head, res, memo)
    out["v1"] = dict(
        light_device_s=t1.build_phases.get("light_device_build"),
        light_host_s=base.get("light_rows"),
        row_topk_device_s=t1.build_phases.get("row_topk"),
        row_topk_host_s=base.get("row_topk"), index_s=build_s)
    say(f"(v1) {len(head)} one-term head queries answered by the row top-k "
        f"shortcut, no launch, oracle-exact; [{card}] build seconds: light "
        f"table device {out['v1']['light_device_s']:.2f} (light rows "
        f"{t1.build_phases.get('light_rows', 0):.2f}) vs host "
        f"{out['v1']['light_host_s']:.2f}, row top-k device "
        f"{out['v1']['row_topk_device_s']:.2f} vs host "
        f"{out['v1']['row_topk_host_s']:.2f}, whole index {build_s:.1f}")
    del t1
    torch.cuda.empty_cache() if device.type == "cuda" else None

    mem0 = _host_mem()
    with mock.patch.dict(os.environ, NEXTSEARCH_DEVICE_BUILD="0"):
        t0 = time.perf_counter()
        t2 = TorchIndex([seg], config=ti.config, device=device)
        build_s = time.perf_counter() - t0
    mem1 = _host_mem()
    if t2._device_build or not torch.equal(t2.dense_rows.view(torch.int32),
                                           ti.dense_rows.view(torch.int32)):
        raise AssertionError("(v2) host-built dense rows != device-built rows")
    if t2._bs_depth != ti._bs_depth:
        raise AssertionError(f"(v2) bs_depth {t2._bs_depth} != {ti._bs_depth}")
    for name, c in _guarded_launch(t2, ti, oracle_segs, batches[0], memo,
                                   "(v2)").items():
        total[name] += c
    table_gib = t2.dense_rows.numel() * t2.dense_rows.element_size() / (1 << 30)
    out["v2"] = dict(
        host_build_upload_s=t2.build_phases.get("host_tables_upload"),
        device_build_s=base.get("heavy_device_build"), index_s=build_s,
        table_gib=table_gib, rss_before_gib=mem0.get("rss"),
        rss_after_gib=mem1.get("rss"), peak_before_gib=mem0["peak"],
        peak_after_gib=mem1["peak"])
    say(f"(v2) dense rows {tuple(t2.dense_rows.shape)} ({table_gib:.2f} GiB) "
        f"bit-equal to the device build; [{card}] host build + upload "
        f"{out['v2']['host_build_upload_s']:.2f} s vs device build "
        f"{out['v2']['device_build_s']:.2f} s (whole index {build_s:.1f} s); "
        f"host memory: resident {mem0.get('rss', 0):.2f} GiB before, "
        f"{mem1.get('rss', 0):.2f} after; the process's peak "
        f"{mem0['peak']:.2f} GiB before, {mem1['peak']:.2f} after")
    del t2
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return total, out


def sort2_phase(ti, oracle_segs, batches, device, card):
    """(w) the 2-level selection sort (NEXTSEARCH_SORT2_2LEVEL=1) on the main
    index: the guarded fast launch takes the 2-level branch (its counter),
    its packed output equals the one-level launch's bit for bit and is
    oracle-exact; device ms per batch (profile_paths.py's trace) both ways,
    and loops of PAIR_SECS in turns (one-level, 2-level, 2-level,
    one-level)."""
    import numpy as np

    from nextsearch_tpu_torch.ops import bm25_sparse as bs

    memo: dict = {}
    total = dict.fromkeys(KERNELS, 0)
    packed = {}
    out = {}
    # the light stream's lanes: the batch envelope's pinned chunk budget C
    # times the posting block (the 2-level guard wants >= 32768, % 128)
    n_flat = (ti._pin("C", BATCH) or 0) * ti.config.device.posting_block
    for level in ("1", "2"):
        with mock.patch.dict(os.environ, NEXTSEARCH_SORT2_2LEVEL=
                             "1" if level == "2" else "0",
                             NEXTSEARCH_TRIP_RESCUE="8"):
            warm(ti, batches[0])
            c0 = bs.topk_quantized_reduce.calls
            reset_counts()
            h = ti.search_batch_async(batches[0], k=K)
            packed[level] = h[4].wait()[0].copy()  # before any host rescue
            res = ti.search_batch_gather(h)
            for name, c in launch_counts().items():
                total[name] += c
            took = bs.topk_quantized_reduce.calls - c0
            if took != (1 if level == "2" else 0):
                raise AssertionError(
                    f"(w) {level}-level: 2-level branch taken {took} times "
                    f"(flat stream {n_flat} lanes)")
            spot_check(ti, oracle_segs, batches[0][:SPOT], res[:SPOT], memo)
            out[f"level{level}"] = dict(
                device_ms_per_batch=traced_ms(ti, batches, device), qps=[])
    # loops in turns (one-level, 2-level, 2-level, one-level)
    for level in ("1", "2", "2", "1"):
        with mock.patch.dict(os.environ, NEXTSEARCH_SORT2_2LEVEL=
                             "1" if level == "2" else "0"):
            counts, loop = serving_loop(ti, batches, device, PAIR_SECS,
                                        f"(w) sort2 {level}-level", card)
        for name, c in counts.items():
            total[name] += c
        out[f"level{level}"]["qps"].append(loop["qps"])
    if not np.array_equal(packed["1"].view(np.uint32), packed["2"].view(np.uint32)):
        raise AssertionError("(w) 2-level packed output != one-level output")
    out["flat_lanes"] = n_flat
    say(f"(w) 2-level sort2 taken on a flat stream of {n_flat} lanes; packed "
        f"output {packed['2'].shape} bit-equal to the one-level launch, "
        f"oracle-exact; [{card}] device ms per batch one-level "
        f"{out['level1']['device_ms_per_batch']} vs 2-level "
        f"{out['level2']['device_ms_per_batch']}; loop qps in turns "
        f"one-level {out['level1']['qps']} vs 2-level {out['level2']['qps']}")
    return total, out


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
    if counts != with_lists({"heavy_fused": 3,
                             "heavy_fused_variant": 3 * n_var}):
        raise AssertionError(f"probe_fusedmm: launches {counts}")
    for name, c in counts.items():
        total[name] += c
    say(f"probe paths: kernel_probe all PASS, probe_fusedmm ran; launches "
        f"{launched(total)}")
    return total


def server_phase(device):
    """The port's Engine and HTTP front over a small on-disk index, in
    sparse mode, in the server's default mode and (u4) in sparse mode over
    --mesh 1,1 (a ShardedIndex)."""
    import numpy as np

    from nextsearch_tpu_torch.api.server import serving_config, serving_mesh
    from nextsearch_tpu_torch.parallel.mesh import make_mesh
    from nextsearch_tpu_torch.config import DeviceConfig, EngineConfig
    from nextsearch_tpu_torch.index.builder import build_segment_arrays
    from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import score_kernels as se

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
        oseg = [seg.to_oracle_segment()]
        # sparse mode, then the mode the server's main starts in when
        # neither NEXTSEARCH_MODE nor --mode is given: the library default
        with mock.patch.dict(os.environ):
            os.environ.pop("NEXTSEARCH_MODE", None)
            default = serving_config(os.environ.get("NEXTSEARCH_MODE"))
        if default.device.mode != "fused":
            raise AssertionError(f"server default mode {default.device.mode}")
        sparse = EngineConfig(device=DeviceConfig(mode="sparse",
                                                  dense_df_ratio=1 / 64))
        # --mesh 1,1: the server's own mesh of the first CUDA device
        mesh = (serving_mesh(1, 1) if device.type == "cuda"
                else make_mesh(1, 1, devices=[device]))
        modes = (
            ("sparse", sparse, (hk.heavy_fused3, hk.gather_rows_bf16), None),
            ("default (fused)", replace(default, device=replace(
                default.device, dense_df_ratio=1 / 64)),
             (hk.gather_rows, se.score_epilogue), None),
            ("(u4) sparse --mesh 1,1", sparse,
             (hk.heavy_fused3, hk.gather_rows_bf16), mesh),
        )
        for label, cfg, kernels, m in modes:
            # (x) and (y) ride on the first sparse serve
            _serve_and_check(Path(tmp), d, cfg, device, oseg, label, kernels, m,
                             trace_and_load=label == "sparse")
        # an embeddings file in the index directory: expansion, ?hybrid=1
        ranked = df_ranked_terms(seg)
        vecs = clustered_vectors(len(ranked))
        (d / "embeddings.vec").write_text("".join(
            f"{t} " + " ".join(f"{x:.6f}" for x in v) + "\n"
            for t, v in zip(ranked, vecs)), encoding="utf-8")
        for label, cfg, kernels, m in modes:
            _serve_and_check(Path(tmp), d, cfg, device, oseg,
                             f"{label} with embeddings", kernels, m)


# K1's and K2's CUDA kernels, by the names a trace gives them
TRACE_KERNELS = {"heavy_fused3": ("heavy_gather_kernel", "heavy_dense_tc_kernel",
                                  "heavy_dense_exact_kernel"),
                 "gather_rows_bf16": ("gather_rows_kernel",)}


def trace_check(prof: Path, card: str, cuda: bool = True) -> dict:
    """(x): the traces NEXTSEARCH_PROFILE_DIR left under search/, read with
    profile_paths.py's reader: their kernel events must name K1's and K2's
    kernels (on a card; a CPU rehearsal's traces have no kernel events)."""
    import profile_paths

    files = sorted((prof / "search").glob("*.json"))
    if not files:
        raise AssertionError(f"(x) no trace under {prof / 'search'}")
    names = set()
    for f in files:
        names.update(e[2] for e in profile_paths.device_events(
            json.loads(f.read_text())) if e[3] == "kernel")
    found = {k: {p: sum(p in n for n in names) for p in pats
                 if any(p in n for n in names)}
             for k, pats in TRACE_KERNELS.items()}
    if cuda and not all(found.values()):
        raise AssertionError(f"(x) traces name no kernel of "
                             f"{[k for k, v in found.items() if not v]}; "
                             f"kernels seen: {sorted(names)[:20]}")
    say(f"(x) [{card}] {len(files)} traces under search/, {len(names)} "
        f"distinct kernels; K1's kernels (pattern: distinct names) "
        f"{found['heavy_fused3']}, K2's {found['gather_rows_bf16']}")
    return dict(traces=len(files), kernels=len(names))


def load_http_check(port: int, index_dir: Path, card: str) -> dict:
    """(y): benchmarks/load_http.py --mode batch for a few seconds against
    the running server: its spot-check (oracle-exact answers) passes and it
    prints its JSON line."""
    cmd = [sys.executable, "-m", "nextsearch_tpu_torch.benchmarks.load_http",
           "--reuse-server", "--port", str(port), "--index-dir",
           str(index_dir), "--mode", "batch", "--secs", "3", "--batch", "64",
           "--clients", "2", "--startup-timeout", "60"]
    r = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                       timeout=600)
    lines = [x for x in r.stdout.splitlines() if x.startswith("{")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"(y) load_http.py rc {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    out = json.loads(lines[-1])
    want = {"metric", "value", "unit", "p50_req_ms", "clients", "batch",
            "errors", "vs_baseline"}
    if set(out) != want or out["metric"] != "served_qps_http_batch" or \
            out["errors"] or "oracle-exact" not in r.stderr:
        raise AssertionError(f"(y) load_http.py line {out}: {r.stderr[-500:]}")
    say(f"(y) [{card}] load_http.py --mode batch (3 s, 2 clients, batch 64) "
        f"over the server index, spot-check oracle-exact: {lines[-1]}")
    return out


def _serve_and_check(tmp, index_dir, cfg, device, oseg, label, kernels,
                     mesh=None, trace_and_load=False):
    """One Engine (over `mesh` if given) and HTTP server over the index:
    /api/search answers equal the oracle's over the query's terms as the
    engine weights them (its own expansion when an embeddings file was
    loaded); ?hybrid=1 answers the plain search without embeddings, and
    with them the reference's hybrid body with the docs and scores of
    HybridIndex.search_batch (over a mesh in sparse mode through its
    "hybrid_host" path); /api/suggest?q=w00 answers
    AutocompleteIndex.suggest_query's list; the requests launched every
    kernel of `kernels`. trace_and_load: the requests run with
    NEXTSEARCH_PROFILE_DIR set (x), then load_http.py loads the server (y)."""
    import http.client

    import numpy as np

    from nextsearch_tpu_torch.api.ai import AzureOpenAIConfig
    from nextsearch_tpu_torch.api.feedback import FeedbackManager
    from nextsearch_tpu_torch.api.server import ServerContext, make_server
    from nextsearch_tpu_torch.api.stats import StatsTracker
    from nextsearch_tpu_torch.engine import Engine
    from nextsearch_tpu_torch.index.oracle import oracle_search_vec

    tmp = tmp / label.replace(" ", "_")  # its own search cache
    tmp.mkdir()
    eng = Engine(index_dir, config=cfg, cache_dir=tmp, device=device, mesh=mesh)
    if not eng.reload() or eng.index.n_dense == 0:
        raise AssertionError("server index: reload failed or no dense rows")
    if (mesh is not None) != hasattr(eng.index, "mesh"):
        raise AssertionError(f"server ({label}): index {type(eng.index)}")
    embeddings = (index_dir / "embeddings.vec").exists()
    if eng.sem.enabled != embeddings:
        raise AssertionError(f"server ({label}): semantic index "
                             f"{eng.sem.enabled}, embeddings file {embeddings}")
    ctx = ServerContext(eng, StatsTracker(tmp / "stats.json"),
                        FeedbackManager(tmp / "feedback.json"),
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
        prof = tmp / "prof"
        queries = [["w0001", "w0150"], ["w0000", "w0003", "w0400"],
                   ["w0002", "w0250"], ["w0010", "w0020", "w0030"],
                   ["w0005", "w0599"]]
        if trace_and_load:
            # the traced requests replay graphs: Engine.warmup captures the
            # 1-query envelope, then each request's own launch is captured
            eng.warmup(k_values=(K,), sizes=[1])
            for terms in queries:
                warm(eng.index, [eng._weighted_terms(terms)])
            caps = captures(eng.index)
            os.environ["NEXTSEARCH_PROFILE_DIR"] = str(prof)
        c0 = [fn.launches for fn in kernels]
        expanded = 0
        for terms in queries:
            body = get(f"/api/search?q={'+'.join(terms)}&k={K}")
            weighted = eng._weighted_terms(terms)
            expanded += len(weighted) > len(terms)
            hits, found = oracle_search_vec(oseg, weighted, k=K)
            got = [(np.float32(x["score"]), x["docId"]) for x in body["results"]]
            exp = [(np.float32(s), doc) for s, _sg, doc in hits]
            if body["found"] != found or got != exp:
                raise AssertionError(f"/api/search {terms} != oracle ({label})")
            hyb = get(f"/api/search?q={'+'.join(terms)}&k={K}&hybrid=1")
            if not embeddings:
                if hyb["results"] != body["results"] or "hybrid" in hyb:
                    raise AssertionError(f"?hybrid=1 {terms} != plain search")
                continue
            hy = eng._hybrid_index()
            h = hy.search_batch_async([weighted], K, cfg.hybrid.candidates)
            if mesh is not None and h[0] != "hybrid_host":
                raise AssertionError(f"?hybrid=1 over a mesh: handle {h[0]}")
            want = hy.search_batch_gather(h)[0]
            if hyb.get("hybrid") is not True or [x["docId"] for x in hyb["results"]] != [
                    eng.index.doc_info(int(s))[2] for s in want.doc_slots] or not np.allclose(
                    [x["hybrid_score"] for x in hyb["results"]], want.scores,
                    rtol=2e-5, atol=0):
                raise AssertionError(f"?hybrid=1 {terms} != HybridIndex ({label})")
            if eng.cache.get(f"{' '.join(terms)}|{K}|hybrid") is None:
                raise AssertionError("?hybrid=1 not cached under q|K|hybrid")
        if embeddings and expanded == 0:
            raise AssertionError(f"server ({label}): no query was expanded")
        sugg = get("/api/suggest?q=w00&k=5")["suggestions"]
        if not sugg or sugg != eng.ac.suggest_query("w00", 5):
            raise AssertionError(f"/api/suggest ({label}): {sugg}")
        c1 = [fn.launches for fn in kernels]
        if trace_and_load:
            os.environ.pop("NEXTSEARCH_PROFILE_DIR")
            no_capture(eng.index, caps, f"server ({label}) traced requests")
            card = card_line() if device.type == "cuda" else "cpu"
            trace_check(prof, card, device.type == "cuda")
            load_http_check(srv.server_address[1], index_dir, card)
        if not all(b > a for a, b in zip(c0, c1)):
            raise AssertionError(
                f"server ({label}) requests did not launch "
                f"{[fn.__name__ for fn in kernels]}: {c0}->{c1}")
        say(f"server {label}: {len(queries)} /api/search answers "
            f"oracle-exact ({expanded} expanded), ?hybrid=1 "
            + ("equal to HybridIndex" if embeddings else "equal")
            + f", /api/suggest?q=w00 {sugg}; launches "
            + ", ".join(f"{fn.__name__} +{b - a}"
                        for fn, a, b in zip(kernels, c0, c1)))
    finally:
        os.environ.pop("NEXTSEARCH_PROFILE_DIR", None)
        srv.shutdown()
        srv.server_close()
        ctx.batcher.shutdown()
        ctx.suggest_batcher.shutdown()
        th.join(timeout=30)


def run(device_name="cuda", n_docs=N_DOCS, vocab=VOCAB, n_batches=64,
        loop_secs=3.0, reps=10, probe_shape=None):
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
    launches, loops = main_path(ti, [oseg], batches, device, loop_secs, card)
    ph.done("main path")
    counts, graphs = graphs_phase(ti, [oseg], batches, device, card)
    for name, c in counts.items():
        launches[name] += c
    ph.done("graphs (z)")
    counts, models, sem = models_phase(ti, seg, [oseg], batches, device,
                                       loop_secs, card, reps)
    for name, c in counts.items():
        launches[name] += c
    ph.done("models (p)-(t)")
    counts, sharded = sharded_phase(ti, seg, oseg, batches, device, loop_secs,
                                    card, loops["default"]["qps"], reps)
    for name, c in counts.items():
        launches[name] += c
    ph.done("sharded (u)")
    counts, builds = build_paths_phase(ti, seg, [oseg], batches, device, card)
    for name, c in counts.items():
        launches[name] += c
    ph.done("build paths (v)")
    counts, sort2 = sort2_phase(ti, [oseg], batches, device, card)
    for name, c in counts.items():
        launches[name] += c
    ph.done("2-level sort2 (w)")
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
    counts, k3_fused, kern["score_epilogue"], fused = fused_phase(
        [oseg], device, n_docs, vocab, n_batches, loop_secs, card, reps, sem)
    kern["gather_rows"].update(prefixed("fused_", k3_fused))
    for name, c in counts.items():
        launches[name] += c
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ph.done("fused, exact, fast")
    for name, c in probe_paths(device, shape).items():
        launches[name] += c
    ph.done("probe paths")
    server_phase(device)
    ph.done("server")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on its path")
    say(f"bf16 rows: {json.dumps(bf16)}")
    say(f"fused: {json.dumps(fused)}")
    say(f"models: {json.dumps(models)}")
    say(f"sharded: {json.dumps(sharded)}")
    say(f"build paths: {json.dumps(builds)}")
    say(f"sort2: {json.dumps(sort2)}")
    graphs["fused"] = fused.pop("graphs")
    say(f"graphs: {json.dumps(graphs)}")
    say(f"total {time.perf_counter() - ph.t0:.1f}s on {card}")
    kern["heavy_fused3"].update(prefixed(
        "bf16_rows_exact_", kern.pop("heavy_fused3_bf16_rows")))
    kern["heavy_fused3"].update(prefixed(
        "dense_", kern.pop("heavy_fused3_dense")))
    lq = models["long_questions"]
    kern["heavy_fused3"].update(
        dense_long_ms=lq["k1_ms"], dense_long_plain_ms=lq["k1_plain_ms"],
        dense_long_library_ms=lq["k1_library_ms"],
        dense_long_bound_ms=lq["k1_bound_ms"],
        dense_long_max_abs_err=lq["k1_max_abs_err"])
    line = [dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
                 launches=launches[name], **kern[name]) for name in KERNELS]
    for entry in line:
        missing = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(entry)
        if missing:
            raise AssertionError(f"kernel {entry['name']} lacks {missing}")
    # the card's launch floor: P5's bare launch at [1, 128], one 16 x 16
    # block moving 512 bytes
    print(json.dumps({"kernels": line,
                      "launch_floor_ms": kern["transpose"]["raw_ms"]}),
          flush=True)
    return device


def main() -> int:
    if not (REPO / "nextsearch_tpu_torch").is_dir():
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
