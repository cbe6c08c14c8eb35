"""QPS at parity on the tools-built index (port of nextsearch_tpu's
benchmarks/bench_tools.py).

The index at NEXTSEARCH_TOOLS_ROOT (default <temp dir>/nextsearch_tools_1m)
is built end to end by the product's CLI pipeline
(nextsearch_tpu_torch/benchmarks/build_tools_index.sh: make_synthetic ->
forwardindex -> lexicon), whose tokenized-text df profile is the corpus
closest to ~1M CORD-19 docs. This measures its reload, pins, the oracle
gate (8 queries, exact), the guard-trip rate and the pipelined QPS at
depth 2, at the reference's operating point (8 GiB of dense rows, a 1 GiB
light table, NEXTSEARCH_TRIP_RESCUE 64).

    bash nextsearch_tpu_torch/benchmarks/build_tools_index.sh
    python -m nextsearch_tpu_torch.benchmarks.bench_tools [--device cpu]

Env: NEXTSEARCH_TOOLS_ROOT, NEXTSEARCH_TOOLS_SECS (12),
NEXTSEARCH_POSTING_BLOCK (64), NEXTSEARCH_DENSE_RATIO (1/1024),
NEXTSEARCH_DENSE_BYTES (8 GiB), NEXTSEARCH_TOOLS_BATCH (512). Prints the
card line first, the reference's lines, and last one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    from ..config import DeviceConfig, EngineConfig
    from ..index.artifacts import load_segment_cached
    from ..index.oracle import oracle_search
    from ..index.segment import TorchIndex
    from .probe_depth import device_arg, run_point

    device = device_arg(argv)
    if device.type == "cuda":
        from .common import card_line

        card = card_line()
    else:
        card = "cpu (no device measured)"
    print(card, flush=True)
    env = os.environ.get
    root = env("NEXTSEARCH_TOOLS_ROOT",
               os.path.join(tempfile.gettempdir(), "nextsearch_tools_1m"))
    batch = int(env("NEXTSEARCH_TOOLS_BATCH", 512))
    t0 = time.time()
    seg = load_segment_cached(os.path.join(root, "index", "segments",
                                           "seg_000001"))
    load_s = time.time() - t0
    print(f"segment load (binary->artifact) {load_s:.1f}s: {seg.N} docs, "
          f"{len(seg.terms)} terms, {seg.num_postings} postings", flush=True)
    # the reference's frontier for tokenized-text df profiles: 8 GiB dense
    # rows, a 2^10-granularity light table (1 GiB), a high rescue cap
    os.environ.setdefault("NEXTSEARCH_TRIP_RESCUE", "64")
    os.environ.setdefault("NEXTSEARCH_LIGHT_TABLE_BYTES", str(1 << 30))
    cfg = EngineConfig(device=DeviceConfig(
        mode="sparse", posting_block=int(env("NEXTSEARCH_POSTING_BLOCK", 64)),
        heavy_buckets=(512,),
        dense_df_ratio=float(env("NEXTSEARCH_DENSE_RATIO", 1 / 1024)),
        dense_max_bytes=int(env("NEXTSEARCH_DENSE_BYTES", 8 << 30))))
    t0 = time.time()
    ti = TorchIndex([seg], config=cfg, device=device)
    build_s = time.time() - t0
    print(f"index build {build_s:.1f}s", flush=True)

    # df-weighted query stream over the real lexicon
    dfs = seg.term_df.astype(np.float64)
    cum = np.cumsum(dfs / dfs.sum())
    cum[-1] = 1.0
    rng = np.random.default_rng(7)

    def mk_batch(n):
        out = []
        for _ in range(n):
            w = int(rng.integers(1, 5))
            picks = np.searchsorted(cum, rng.random(w), "right")
            while len(set(picks.tolist())) != w:
                picks = np.searchsorted(cum, rng.random(w), "right")
            out.append([(seg.terms[int(t)], 1.0) for t in picks])
        return out

    batches = [mk_batch(batch) for _ in range(40)]
    t0 = time.time()
    pins = ti.pin_shapes(batches[:16], scope_q=True)
    print(f"pins {pins} ({time.time() - t0:.1f}s)", flush=True)
    t0 = time.time()
    ti.search_batch(batches[0], k=10)
    print(f"warm {time.time() - t0:.1f}s", flush=True)

    osegs = [seg.to_oracle_segment()]
    for terms, res in zip(batches[1][:8], ti.search_batch(batches[1][:8], k=10)):
        hits, found = oracle_search(osegs, terms, k=10)
        assert res.found == found, (terms, res.found, found)
        for (o_s, _sg, o_d), d_s, d_slot in zip(hits, res.scores, res.doc_slots):
            assert ti.locate(int(d_slot))[1] == o_d, terms
            assert np.float32(d_s) == np.float32(o_s), terms
    print("parity: OK (8 queries exact)", flush=True)

    secs = float(env("NEXTSEARCH_TOOLS_SECS", 12))
    qps, _p50, n_b = run_point(ti, batches, depth=2, secs=secs)
    print(f"TOOLS-BUILT: qps={qps:.0f}  batches={n_b} "
          f"trips={ti.rescue_trips} rescue_ms_total={ti.rescue_ms:.0f} "
          f"({ti.rescue_ms / n_b:.1f} ms/batch of {batch / qps * 1000:.1f})",
          flush=True)
    print(json.dumps({
        "metric": "tools_built_qps", "value": round(qps, 1),
        "unit": "queries/sec", "device": card, "docs": seg.N,
        "postings": int(seg.num_postings), "load_s": round(load_s, 2),
        "build_s": round(build_s, 2), "pins": pins, "parity": True,
        "batches": n_b, "trips": ti.rescue_trips,
        "relaunches": ti.relaunches,
        "rescue_ms_per_batch": round(ti.rescue_ms / n_b, 3),
    }, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
