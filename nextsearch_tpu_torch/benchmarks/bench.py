"""Benchmark: batched BM25 top-10 queries per second on one CUDA card.

Port of nextsearch_tpu's root bench.py. Builds the synthetic bench corpus
(1M docs, 200k-term Zipf vocabulary, ~47M postings; tools/synthetic.py,
seeds 0 and 1), a TorchIndex in the chosen mode, and runs the end-to-end
batched query path (host planning, device launch, result extraction) in a
pipeline of `depth` launches in flight.

    python3 -m nextsearch_tpu_torch.benchmarks.bench [--device cpu]

A CUDA card is required unless --device cpu is given (the CPU tests run it
at a small size; a CPU run measures no device).

The parity gate comes first: 8 queries of the first batch are held bit for
bit (score, doc, found) against index/oracle.py. When it fails the script
prints the mismatch to stderr, prints no speed, and exits 1.

Standard output: a line with the card's name and power limit, a line of
per-batch numbers (p50 request latency, stream span per batch, peak device
memory), and as the last line one JSON object:

    {"metric": "bm25_top10_qps_1M", "value": N, "unit": "queries/sec", ...}

`stream_span_ms_per_batch` is the median, over the loop's batches, of the
time between two CUDA events on the stream: one recorded before the batch's
first kernel is queued, one after its result copy. It holds the card's work
for the batch and every gap in which the card waited for the host to queue
the next kernel, so in a host-bound loop it reads the host's dispatch time,
not the card's: it is no device time, only an upper bound on one
(profile_paths.py reads the busy time, its device_ms_per_batch, from a
trace).

Env knobs (the reference's): NEXTSEARCH_BENCH_DOCS (1000000), _VOCAB
(200000), _BATCH (512), _SECS (10), _MODE (exact|fast|fused|sparse, default
sparse), _BLOCK (64), _DENSE (dense df ratio: 1/1024 sparse, 1/256
otherwise), _DENSE_BYTES (7 GiB sparse, 2 GiB otherwise), _HEAVYB (512),
_BF16 (scores_bf16, 0), _K2 (rescore margin, 32), _UNIFIED (0), _CHUNKS
(pin C), _PIPELINE (depth, 2), _LAT_BATCH (64; 0 skips the latency point),
_LAT_DEPTH (2), _LAT_SECS (8), and NEXTSEARCH_BENCH_CACHE (corpus cache
directory; "0" disables).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import sys
import time

import numpy as np
import torch

from ..index.oracle import oracle_search

K = 10
GATE_QUERIES = 8


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def metric_name(n_docs: int) -> str:
    return (f"bm25_top10_qps_{n_docs // 1000}k" if n_docs < 1_000_000
            else "bm25_top10_qps_1M")


def bench_config(mode: str):
    """The bench's EngineConfig for `mode`, from the NEXTSEARCH_BENCH_*
    variables with the reference's per-mode defaults."""
    from ..config import DeviceConfig, EngineConfig

    env = os.environ.get
    sparse = mode == "sparse"
    return EngineConfig(device=DeviceConfig(
        mode=mode,
        posting_block=int(env("NEXTSEARCH_BENCH_BLOCK", 64)),
        heavy_buckets=(int(env("NEXTSEARCH_BENCH_HEAVYB", 512)),),
        dense_df_ratio=float(
            env("NEXTSEARCH_BENCH_DENSE", 1 / 1024 if sparse else 1 / 256)),
        dense_max_bytes=int(
            env("NEXTSEARCH_BENCH_DENSE_BYTES", 7 << 30 if sparse else 2 << 30)),
        scores_bf16=env("NEXTSEARCH_BENCH_BF16", "0") == "1",
        rescore_margin=int(env("NEXTSEARCH_BENCH_K2", 32)),
        unified=env("NEXTSEARCH_BENCH_UNIFIED", "0") == "1",
    ))


def load_corpus(n_docs: int, vocab: int):
    """(segment, term probabilities): the bench corpus, through the artifact
    cache unless NEXTSEARCH_BENCH_CACHE is "0"."""
    from ..tools.synthetic import build_corpus
    from .common import bench_corpus

    if os.environ.get("NEXTSEARCH_BENCH_CACHE") == "0":
        return build_corpus(n_docs, vocab)
    return bench_corpus(n_docs, vocab)


def parity_gate(ti, oracle_segs, queries) -> None:
    """Hold the index's answers to `queries` bit for bit against the
    oracle's; raises AssertionError naming the first mismatch."""
    for terms, res in zip(queries, ti.search_batch(queries, k=K)):
        hits, found = oracle_search(oracle_segs, terms, k=K)
        assert res.found == found, (terms, "found", res.found, found)
        assert len(res.scores) == len(hits), (terms, "hits", len(res.scores),
                                              len(hits))
        for (o_s, _sg, o_d), d_s, d_slot in zip(hits, res.scores,
                                                res.doc_slots):
            assert ti.locate(int(d_slot))[1] == o_d, (terms, "doc", d_slot, o_d)
            assert np.float32(d_s) == np.float32(o_s), (terms, "score", d_s, o_s)


class Pipeline:
    """The serving loop: `depth` batched launches in flight, so the host's
    planning and the card's work overlap. Collects request latencies and,
    on a card, the event span of each batch. `prepare`, if given, maps each
    batch of queries to the batch that is launched (semantic expansion), in
    the request's time; its seconds per batch go to prepare_s."""

    def __init__(self, ti, batches, batch: int, depth: int, prepare=None):
        self.ti, self.batches, self.batch, self.depth = ti, batches, batch, depth
        self.prepare = prepare
        self.cuda = ti.device.type == "cuda"
        self.n_done = 0
        self.lat: list = []
        self.span_ms: list = []
        self.prepare_s: list = []
        self.t0 = time.time()
        self._window: list = []

    def _launch(self, i: int) -> None:
        ev0 = ev1 = None
        t = time.time()
        queries = self.batches[i % len(self.batches)]
        if self.prepare is not None:
            queries = self.prepare(queries)
            self.prepare_s.append(time.time() - t)
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        h = self.ti.search_batch_async(queries, k=K)
        if self.cuda:
            ev1.record()
        self._window.append((t, h, ev0, ev1))

    def _gather(self) -> None:
        t, h, ev0, ev1 = self._window.pop(0)
        self.ti.search_batch_gather(h)
        self.lat.append(time.time() - t)
        self.n_done += self.batch
        if self.cuda:
            ev1.synchronize()
            self.span_ms.append(ev0.elapsed_time(ev1))

    def run(self, secs: float, start: int = 1) -> dict:
        i = start
        self.t0 = time.time()
        while True:
            self._launch(i)
            if len(self._window) > self.depth:
                self._gather()
            i += 1
            if time.time() - self.t0 >= secs and self.n_done > 0:
                break
        while self._window:
            self._gather()
        elapsed = time.time() - self.t0
        return dict(
            qps=self.n_done / elapsed, iters=i - start,
            p50_req_ms=float(np.median(self.lat)) * 1000,
            stream_span_ms_per_batch=(statistics.median(self.span_ms)
                                      if self.span_ms else None),
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, required for a measurement) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: the bench measures the card "
              "(--device cpu runs it without one)", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    env = os.environ.get
    n_docs = int(env("NEXTSEARCH_BENCH_DOCS", 1_000_000))
    vocab = int(env("NEXTSEARCH_BENCH_VOCAB", 200_000))
    batch = int(env("NEXTSEARCH_BENCH_BATCH", 512))
    secs = float(env("NEXTSEARCH_BENCH_SECS", 10))
    mode = env("NEXTSEARCH_BENCH_MODE", "sparse")
    depth = int(env("NEXTSEARCH_BENCH_PIPELINE", 2))

    from ..index.segment import TorchIndex
    from ..tools.synthetic import sample_queries
    from .common import card_line

    card = card_line() if device.type == "cuda" else "cpu (no device measured)"
    print(card, flush=True)

    t0 = time.time()
    seg, probs = load_corpus(n_docs, vocab)
    note(f"corpus: {n_docs} docs, {vocab} terms, {seg.num_postings} postings "
         f"({time.time() - t0:.1f}s)")
    batches = sample_queries(probs, n_queries=200 * batch, batch=batch)

    t0 = time.time()
    ti = TorchIndex([seg], config=bench_config(mode), device=device)
    hbm = ti.hbm_bytes()
    note(f"index build+upload: {time.time() - t0:.1f}s")
    note("index device memory: " + " ".join(
        f"{k}={v / (1 << 30):.2f}GiB" for k, v in hbm.items()))
    # Freeze every batch-varying shape (T/Q/C/U/W/L) on this batch size's
    # Q envelope, from the workload itself, as serving does.
    chunks_env = env("NEXTSEARCH_BENCH_CHUNKS")
    t0 = time.time()
    pins = ti.pin_shapes(batches, scope_q=True,
                         C=int(chunks_env) if chunks_env else None)
    note(f"pins: {pins} ({time.time() - t0:.1f}s probe)")

    t0 = time.time()
    ti.search_batch(batches[0], k=K)
    note(f"warmup (kernel build included): {time.time() - t0:.1f}s")

    # Parity gate: no speed is reported for results that differ from the
    # oracle's in any bit.
    try:
        parity_gate(ti, [seg.to_oracle_segment()], batches[0][:GATE_QUERIES])
    except AssertionError as e:
        note(f"parity spot-check FAILED, no speed reported: {e}")
        return 1
    note(f"parity spot-check: OK ({GATE_QUERIES} queries, exact)")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop = Pipeline(ti, batches, batch, depth)

    def report_partial(_sig, _frm):
        # cut by a time limit mid-measurement: report what there is
        if loop.n_done:
            qps_part = loop.n_done / max(time.time() - loop.t0, 1e-9)
            print(json.dumps({"metric": metric_name(n_docs),
                              "value": round(qps_part, 1),
                              "unit": "queries/sec", "partial": True}),
                  flush=True)
        sys.exit(0)

    signal.signal(signal.SIGTERM, report_partial)
    main_point = loop.run(secs)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    # reserved, not allocated: a graph pool's blocks are not "allocated"
    # between replays, though the card holds them
    peak_gb = (torch.cuda.max_memory_reserved(device) / (1 << 30)
               if device.type == "cuda" else None)
    note(f"mode={mode} batch={batch} depth={depth} iters={main_point['iters']} "
         f"qps={main_point['qps']:.0f}")
    span_ms = main_point["stream_span_ms_per_batch"]
    print(f"p50_req_ms={main_point['p50_req_ms']:.2f} stream_span_ms_per_batch="
          + ("not measured" if span_ms is None else f"{span_ms:.3f}")
          + " peak_device_mem_gib="
          + ("not measured" if peak_gb is None else f"{peak_gb:.2f}"),
          flush=True)

    # Latency operating point: a smaller batch at shallow depth, on its own
    # pinned Q envelope.
    lat_point = None
    lat_batch = int(env("NEXTSEARCH_BENCH_LAT_BATCH", 64))
    if lat_batch > 0:
        lat_depth = int(env("NEXTSEARCH_BENCH_LAT_DEPTH", 2))
        lbatches = [b[:lat_batch] for b in batches[:64]]
        note(f"latency-point pins: {ti.pin_shapes(lbatches, scope_q=True)}")
        ti.search_batch(lbatches[0], k=K)
        lp = Pipeline(ti, lbatches, lat_batch, lat_depth).run(
            float(env("NEXTSEARCH_BENCH_LAT_SECS", 8)), start=0)
        lat_point = {"batch": lat_batch, "depth": lat_depth,
                     "qps": round(lp["qps"], 1),
                     "p50_req_ms": round(lp["p50_req_ms"], 2)}
        note(f"latency point: batch={lat_batch} depth={lat_depth} "
             f"qps={lp['qps']:.0f} p50_req_ms={lp['p50_req_ms']:.2f}")

    out = {
        "metric": metric_name(n_docs),
        "value": round(main_point["qps"], 1),
        "unit": "queries/sec",
        "mode": mode,
        "device": card,
        "p50_req_ms": round(main_point["p50_req_ms"], 2),
        "stream_span_ms_per_batch": (None if span_ms is None
                                     else round(span_ms, 3)),
        "peak_device_mem_gib": None if peak_gb is None else round(peak_gb, 2),
        "index_hbm_gb": round(hbm["total"] / (1 << 30), 2),
        "postings_gb": round(
            (hbm.get("post_doc", 0) + hbm.get("post_score", 0)) / (1 << 30), 2),
    }
    if lat_point:
        out["latency_point"] = lat_point
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
