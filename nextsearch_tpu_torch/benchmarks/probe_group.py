"""Probe: the multi-launch group path against single launches at the
serving point (port of nextsearch_tpu's benchmarks/probe_group.py).

A batch above DeviceConfig.launch_group (512) runs as G block-diagonal
sub-batches (``packed_multi``: one launch per group here, one XLA program
in the reference). The probe pins the batch-512 scope and times, through
the pipelined loop:

    single   batch-512 launches at depth 8 (the reference's headline path)
    groupG   batch 512*G through the same loop (G groups per batch, depth
             max(2, 8 // G))

    python -m nextsearch_tpu_torch.benchmarks.probe_group [--device cpu]

Env: NEXTSEARCH_PROBE_GROUPS (comma list, default "2,4"),
NEXTSEARCH_PROBE_SECS (8), NEXTSEARCH_PROBE_DOCS (1000000),
NEXTSEARCH_PROBE_VOCAB (200000). Prints the card line first, the
reference's lines on stderr, and last one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .probe_depth import K, run_point


def throughput(index, batches, *, depth=8, secs=8.0):
    index.search_batch(batches[0], k=K)  # warm
    return run_point(index, batches, depth=depth, secs=secs)[0]


def main(argv=None) -> int:
    from ..tools.synthetic import sample_queries
    from .probe_depth import device_arg, setup, sparse_bench_index

    device = device_arg(argv)
    card, seg, probs = setup(device)
    env = os.environ.get
    secs = float(env("NEXTSEARCH_PROBE_SECS", 8))
    groups = [int(g) for g in env("NEXTSEARCH_PROBE_GROUPS", "2,4").split(",")]
    t0 = time.time()
    ti = sparse_bench_index(seg, device)
    print(f"[probe] index build+upload: {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)
    base = 512
    batches512 = sample_queries(probs, n_queries=40 * base, batch=base)
    pins = ti.pin_shapes(batches512, scope_q=True)
    print(f"[probe] 512-scope pins: {pins}", file=sys.stderr, flush=True)
    qps1 = throughput(ti, batches512, depth=8, secs=secs)
    print(f"[probe] single 512: {qps1:.0f} qps "
          f"({base / qps1 * 1000:.1f} ms/batch)", file=sys.stderr, flush=True)
    points = [{"path": "single", "batch": base, "depth": 8,
               "qps": round(qps1, 1)}]
    for g in groups:
        big = [sum((batches512[(i * g + j) % len(batches512)]
                    for j in range(g)), [])
               for i in range(len(batches512) // g)]
        depth = max(2, 8 // g)
        qps = throughput(ti, big, depth=depth, secs=secs)
        print(f"[probe] group x{g} (batch {base * g}): {qps:.0f} qps "
              f"({base * g / qps * 1000:.1f} ms/launch)",
              file=sys.stderr, flush=True)
        points.append({"path": f"group{g}", "batch": base * g, "depth": depth,
                       "qps": round(qps, 1)})
    print(json.dumps({"probe": "group", "device": card, "points": points}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
