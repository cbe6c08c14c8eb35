"""The sharded launch path's cost over the single-device one at parity
shapes: TorchIndex against a ShardedIndex on a (1,1) mesh of the same
device, both pinned from the same batches (port of the repository root's
benchmarks/sharded_overhead.py). On one shard the merge is skipped, so what
is measured is the sharded plumbing: the per-shard plan layout, the local
step's call and the packed result.

    python -m nextsearch_tpu_torch.benchmarks.sharded_overhead [--device cpu]

Env: NEXTSEARCH_SHOV_DOCS (default 100_000), NEXTSEARCH_SHOV_VOCAB
(200_000), NEXTSEARCH_SHOV_BATCH (256), NEXTSEARCH_SHOV_SECS (6),
NEXTSEARCH_SHOV_MODE (fused|sparse, default fused), NEXTSEARCH_SHOV_DEPTH
(pipeline depth, 4).

MODE=sparse is the bench's serving configuration (posting_block 64, dense
ratio 1/1024 up to 7 GiB, heavy bucket 512, K2 32). The first index is
freed before the second is built: at 1M docs two dense tables may not fit.
On a card it prints the card's name and power limit first; the last line
is the JSON of the reference script.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch


def _measure(index, batches, batch, secs, depth=4):
    """Queries per second of a depth-`depth` pipelined loop at k 10."""
    index.search_batch(batches[0], k=10)  # warm
    n_done = 0
    i = 1
    window = []
    t0 = time.time()
    while True:
        window.append(index.search_batch_async(batches[i % len(batches)], k=10))
        if len(window) > depth:
            index.search_batch_gather(window.pop(0))
            n_done += batch
        i += 1
        if time.time() - t0 >= secs and n_done > 0:
            break
    while window:
        index.search_batch_gather(window.pop(0))
        n_done += batch
    return n_done / (time.time() - t0)


def config(mode: str):
    from ..config import DeviceConfig, EngineConfig

    if mode == "sparse":
        return EngineConfig(device=DeviceConfig(
            mode="sparse", posting_block=64, heavy_buckets=(512,),
            dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30,
            rescore_margin=32))
    return EngineConfig(device=DeviceConfig(
        mode="fused", posting_block=512, chunk_buckets=(512, 1024, 4096),
        heavy_buckets=(512,)))


def run(device: torch.device) -> dict:
    from ..index.segment import TorchIndex
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedIndex
    from ..tools.synthetic import sample_queries
    from .common import bench_corpus

    env = os.environ.get
    n_docs = int(env("NEXTSEARCH_SHOV_DOCS", 100_000))
    vocab = int(env("NEXTSEARCH_SHOV_VOCAB", 200_000))
    batch = int(env("NEXTSEARCH_SHOV_BATCH", 256))
    secs = float(env("NEXTSEARCH_SHOV_SECS", 6))
    mode = env("NEXTSEARCH_SHOV_MODE", "fused")
    depth = int(env("NEXTSEARCH_SHOV_DEPTH", 4))

    seg, probs = bench_corpus(n_docs, vocab)
    cfg = config(mode)
    batches = sample_queries(probs, n_queries=40 * batch, batch=batch)

    ti = TorchIndex([seg], config=cfg, device=device)
    print(f"[shov] pins: {ti.pin_shapes(batches)}", file=sys.stderr)
    qps_single = _measure(ti, batches, batch, secs, depth=depth)
    print(f"[shov] TorchIndex:         {qps_single:8.0f} qps", file=sys.stderr)
    del ti
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    si = ShardedIndex([seg], make_mesh(dp=1, seg=1, devices=[device]), config=cfg)
    print(f"[shov] sharded pins: {si.pin_shapes(batches)}", file=sys.stderr)
    qps_sharded = _measure(si, batches, batch, secs, depth=depth)
    print(f"[shov] ShardedIndex (1,1): {qps_sharded:8.0f} qps", file=sys.stderr)
    overhead = (qps_single - qps_sharded) / qps_single * 100
    print(f"[shov] sharded overhead at parity shapes: {overhead:.1f}%",
          file=sys.stderr)
    return {
        "mode": mode,
        "docs": n_docs,
        "batch": batch,
        "qps_single": round(qps_single, 1),
        "qps_sharded_1x1": round(qps_sharded, 1),
        "overhead_pct": round(overhead, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, required for a measurement) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: the script measures the card "
              "(--device cpu runs it without one)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda":
        from .common import card_line

        print(card_line(), flush=True)
    print(json.dumps(run(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
