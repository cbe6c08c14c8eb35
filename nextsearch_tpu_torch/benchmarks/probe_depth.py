"""Probe: (QPS, p50) against pipeline depth at the throughput operating
point (port of nextsearch_tpu's benchmarks/probe_depth.py).

A request sits behind `depth` launches in flight, so p50 grows with depth
times the per-batch time; if the loop is bound by one side (host or card),
a shallower window keeps QPS and cuts p50. The probe builds the bench
index once (sparse, batch 512, k 10, the bench's configuration) and sweeps
the depth, so bench.py's default depth can be chosen from measured pairs.

    python -m nextsearch_tpu_torch.benchmarks.probe_depth [--device cpu]

Env: NEXTSEARCH_PROBE_DEPTHS (comma list, default "2,3,4,6,8"),
NEXTSEARCH_PROBE_SECS (8), NEXTSEARCH_PROBE_DOCS (1000000),
NEXTSEARCH_PROBE_VOCAB (200000), NEXTSEARCH_PROBE_BATCH (512).

Prints the card line first, one "[probe] depth d: ..." line per depth on
stderr, and last one JSON line with every point.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

K = 10


def run_point(index, batches, *, depth: int, secs: float, k: int = K):
    """(QPS, p50 ms, batches) of the pipelined loop at `depth` launches in
    flight over `batches` (cycled) for `secs`, at least one batch; index is
    anything with search_batch_async(queries, k=) and search_batch_gather."""
    batch = len(batches[0])
    lat = []
    window = []
    n_done = 0
    i = 0
    t0 = time.time()
    while time.time() - t0 < secs or not n_done:
        b0 = time.time()
        window.append((b0, index.search_batch_async(batches[i % len(batches)],
                                                    k=k)))
        if len(window) > depth:
            s0, h = window.pop(0)
            index.search_batch_gather(h)
            lat.append(time.time() - s0)
            n_done += batch
        i += 1
    while window:
        s0, h = window.pop(0)
        index.search_batch_gather(h)
        lat.append(time.time() - s0)
        n_done += batch
    qps = n_done / (time.time() - t0)
    return qps, float(np.median(lat)) * 1000, len(lat)


def sparse_bench_index(seg, device, **device_fields):
    """TorchIndex at the bench's sparse configuration (device_fields on
    top)."""
    from ..config import DeviceConfig, EngineConfig
    from ..index.segment import TorchIndex

    fields = dict(mode="sparse", posting_block=64, heavy_buckets=(512,),
                  dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30)
    fields.update(device_fields)
    cfg = EngineConfig(device=DeviceConfig(**fields))
    return TorchIndex([seg], config=cfg, device=device)


def setup(device, env_prefix: str = "NEXTSEARCH_PROBE"):
    """(card line, bench corpus, its query probabilities) for a probe."""
    from .common import bench_corpus, card_line

    card = card_line() if device.type == "cuda" else "cpu (no device measured)"
    print(card, flush=True)
    env = os.environ.get
    seg, probs = bench_corpus(int(env(f"{env_prefix}_DOCS", 1_000_000)),
                              int(env(f"{env_prefix}_VOCAB", 200_000)))
    return card, seg, probs


def device_arg(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, required for a measurement) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe measures the card "
                         "(--device cpu runs it without one)")
    return torch.device(args.device)


def main(argv=None) -> int:
    from ..tools.synthetic import sample_queries

    device = device_arg(argv)
    card, seg, probs = setup(device)
    env = os.environ.get
    secs = float(env("NEXTSEARCH_PROBE_SECS", 8))
    batch = int(env("NEXTSEARCH_PROBE_BATCH", 512))
    depths = [int(d) for d in env("NEXTSEARCH_PROBE_DEPTHS", "2,3,4,6,8").split(",")]
    t0 = time.time()
    ti = sparse_bench_index(seg, device)
    print(f"[probe] index build+upload: {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)
    batches = sample_queries(probs, n_queries=200 * batch, batch=batch)
    pins = ti.pin_shapes(batches, scope_q=True)
    print(f"[probe] pins: {pins}", file=sys.stderr, flush=True)
    ti.search_batch(batches[0], k=K)  # warm
    points = []
    for d in depths:
        qps, p50, _n = run_point(ti, batches, depth=d, secs=secs)
        print(f"[probe] depth {d}: {qps:.0f} qps, p50 {p50:.1f} ms",
              file=sys.stderr, flush=True)
        points.append({"depth": d, "qps": round(qps, 1), "p50_ms": round(p50, 2)})
    print(json.dumps({"probe": "depth", "device": card, "batch": batch,
                      "secs": secs, "points": points}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
