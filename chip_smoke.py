#!/usr/bin/env python3
"""Smoke run of the torch port's sparse BM25 search path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each timed; any failure exits
non-zero before the last line:

1. device: require CUDA, print the card's name and power limit, build the
   CUDA kernels from nextsearch_tpu_torch/csrc.
2. index: the bench corpus (1M docs, 200k-term Zipf vocabulary) and a
   TorchIndex at the bench configuration (posting_block 64, dense ratio
   1/1024, 7 GiB dense rows, heavy bucket 512, K2 margin 32), pinned on the
   batch-512 envelope.
3. kernels: each kernel against its plain PyTorch version on operands of a
   real batch-512 plan (K2/K3/K4 bit-exact; K1 cnt bit-exact, H and
   smax within rtol 1e-6 because the fp32 sums run in another order than
   cuBLAS's; K5 cnt bit-exact, totals and smax within rtol 2e-6), with
   median times beside the plain versions' and the measured relative error
   of fast (one-pass bf16) H against exact H.
4. main path: batch 512 / k 10 through search_batch_async /
   search_batch_gather, the launch counters reset before each launch and
   read after it, each launch spot-checked bit-exact against the oracle:
   (a) the guarded fast launch, (b) fast_heavy off (compact exact), (c) a
   forced guard trip that relaunches the full-table exact kernel, (d) the
   unified launch (unified=True, K5) guarded fast, (e) unified exact, (f)
   unified with a forced trip (relaunching the packed full-table kernel),
   (g) the windowed selection kernel (NEXTSEARCH_SELECT_PALLAS=1, K4)
   guarded fast, (h) K4 compact exact. Then a 10 s pipelined loop at depth
   2 on the default path and 5 s ones under unified and under K4. Every
   kernel must have launched.
5. server: a small on-disk index served over HTTP by the port's Engine;
   /api/search answers must match the oracle and run K1 and K2.

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
    """Median milliseconds of fn() over reps runs (CUDA events on a card)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def build_index(device, n_docs: int, vocab: int, batch: int, n_batches: int):
    """Bench corpus (artifact-cached under the temp dir), TorchIndex at the
    bench configuration, and batch-envelope pins from the query stream."""
    from nextsearch_tpu.config import DeviceConfig, EngineConfig
    from nextsearch_tpu.index.artifacts import load_artifact, save_artifact
    from nextsearch_tpu_torch.index.segment import TorchIndex
    from nextsearch_tpu_torch.tools.synthetic import (
        build_corpus, sample_queries, zipf_probs,
    )

    cache = Path(os.environ.get(
        "NEXTSEARCH_BENCH_CACHE",
        Path(tempfile.gettempdir()) / "nextsearch_bench_cache",
    )) / f"{n_docs}_{vocab}_0"
    seg = load_artifact(cache)
    probs = zipf_probs(vocab)
    if seg is None:
        seg, probs = build_corpus(n_docs, vocab)
        try:
            save_artifact(seg, cache)
        except OSError as e:
            say(f"corpus cache not written ({e})")
    say(f"corpus: {n_docs} docs, {vocab} terms, {seg.num_postings} postings")
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=64, heavy_buckets=(512,),
        dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30, rescore_margin=32,
    ))
    batches = sample_queries(probs, n_queries=n_batches * batch, batch=batch)
    ti = TorchIndex([seg], config=cfg, device=device)
    pins = ti.pin_shapes(batches, scope_q=True)
    say(f"index: n_slots={ti.n_slots} n_dense={ti.n_dense} "
        f"n_light={ti.n_light} bs_depth={ti._bs_depth} pins={pins}")
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


def _rel_check(label, pairs, rtol):
    """Max abs error over (got, expected) pairs; raises past rtol."""
    err = 0.0
    for a, b in pairs:
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


KERNELS = ("heavy_fused3", "gather_rows_bf16", "gather_rows",
           "per_query_topk", "unified_fused")


def launch_counts():
    """Launches of (K1, K2, K3, K4, K5) since the last reset."""
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import select_kernels as sk

    return (hk.heavy_fused3.launches, hk.gather_rows_bf16.launches,
            hk.gather_rows.launches, sk.per_query_topk.launches,
            hk.unified_fused.launches)


def reset_counts():
    from nextsearch_tpu_torch.ops import heavy_kernels as hk
    from nextsearch_tpu_torch.ops import select_kernels as sk

    hk.reset_launch_counts()
    sk.reset_launch_counts()


def serving_loop(ti, batches, device, secs: float, label: str, card: str):
    """Depth-2 pipelined loop over the stream's batches (batch 0 is the
    spot-check batch); returns the launch counts it made."""
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
    say(f"[{card}] serving loop {label}: batch {BATCH} depth 2 k {K}: "
        f"qps={done / el:.1f} p50_ms={float(np.median(lat)) * 1e3:.2f} "
        f"batches={len(lat)} host_rescued_queries={ti.rescue_trips - trips0} "
        f"relaunched_batches={ti.relaunches - rel0} peak_allocated={peak} "
        f"launches (K1..K5) {counts}")
    return counts


def main_path(ti, seg, batches, device, loop_secs: float, card: str):
    """Launches (a)-(h), then the pipelined loops; returns each kernel's
    launch count summed over all of them."""
    oracle_segs = [seg.to_oracle_segment()]
    memo: dict = {}
    spot = batches[0]
    total = [0] * len(KERNELS)

    def add(counts):
        for j, c in enumerate(counts):
            total[j] += c

    def run(label, *expect):
        reset_counts()
        t = time.perf_counter()
        res = ti.search_batch(spot, k=K)
        dt = time.perf_counter() - t
        counts = launch_counts()
        spot_check(ti, oracle_segs, spot[:SPOT], res[:SPOT], memo)
        if counts not in expect:
            raise AssertionError(f"{label}: launches (K1..K5) {counts} "
                                 f"not in {expect}")
        add(counts)
        say(f"launch {label}: {dt * 1e3:.1f} ms, {SPOT} queries oracle-exact, "
            f"launches (K1..K5) {counts}")

    cfg = ti.config

    def config(**device_fields):
        ti.config = replace(cfg, device=replace(cfg.device, **device_fields))

    def tripped(label, *expect):
        r0 = ti.relaunches
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="0"):
            run(label, *expect)
        if ti.relaunches != r0 + 1:
            raise AssertionError(f"{label}: did not relaunch")

    try:
        # more than 8 tripped queries relaunch the batch exactly (K1 again)
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            trips0 = ti.rescue_trips
            run("(a) guarded fast", (1, 1, 0, 0, 0), (2, 1, 0, 0, 0))
            if ti.rescue_trips != trips0:
                say(f"(a) host-rescued {ti.rescue_trips - trips0} queries")
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(b) compact exact", (1, 0, 1, 0, 0))
        config(fast_heavy_eps=1e9)
        tripped("(c) tripped -> full-table exact relaunch", (2, 1, 0, 0, 0))
        config(unified=True)
        with mock.patch.dict(os.environ, NEXTSEARCH_TRIP_RESCUE="8"):
            run("(d) unified guarded fast", (0, 1, 0, 0, 1), (1, 1, 0, 0, 1))
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(e) unified exact", (0, 0, 1, 0, 1))
        config(unified=True, fast_heavy_eps=1e9)
        tripped("(f) unified tripped -> packed full-table exact relaunch",
                (1, 1, 0, 0, 1))
        config()
        with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1",
                             NEXTSEARCH_TRIP_RESCUE="8"):
            run("(g) K4 guarded fast", (1, 1, 0, 1, 0), (2, 1, 0, 2, 0))
            with mock.patch.dict(os.environ, NEXTSEARCH_FAST_HEAVY="0"):
                run("(h) K4 compact exact", (1, 0, 1, 1, 0))
        add(serving_loop(ti, batches, device, loop_secs, "default", card))
        config(unified=True)
        add(serving_loop(ti, batches, device, loop_secs / 2, "unified", card))
        config()
        with mock.patch.dict(os.environ, NEXTSEARCH_SELECT_PALLAS="1"):
            add(serving_loop(ti, batches, device, loop_secs / 2, "K4", card))
    finally:
        ti.config = cfg
    hbm = ti.hbm_bytes()
    say(f"[{card}] index bytes: " + " ".join(f"{k}={v}" for k, v in hbm.items()))
    return dict(zip(KERNELS, total))


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
        loop_secs=10.0, reps=10):
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
    kern = check_kernels(ti, batches[0], device, reps)
    ph.done("kernels")
    launches = main_path(ti, seg, batches, device, loop_secs, card)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    ph.done("main path")
    del ti
    if device.type == "cuda":
        torch.cuda.empty_cache()
    server_phase(device)
    ph.done("server")
    csrc = "nextsearch_tpu_torch/csrc/"
    where = {
        "heavy_fused3": ("heavy.cu", "nextsearch_tpu/ops/heavy_pallas.py:706"),
        "gather_rows_bf16": ("heavy.cu", "nextsearch_tpu/ops/heavy_pallas.py:611"),
        "gather_rows": ("heavy.cu", "nextsearch_tpu/ops/heavy_pallas.py:537"),
        "per_query_topk": ("heavy.cu", "nextsearch_tpu/ops/select_pallas.py:218"),
        "unified_fused": ("heavy.cu", "nextsearch_tpu/ops/heavy_pallas.py:389"),
    }
    say(f"total {time.perf_counter() - ph.t0:.1f}s on {card}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=csrc + where[name][0],
             replaces=where[name][1], launches=launches[name], **kern[name])
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
