#!/usr/bin/env python3
"""Where the time goes on the port's three sparse paths and on its fused
mode (the library default), on one CUDA card.

    python3 profile_paths.py [--serial 10] [--loop 100] [--out FILE]

Run from the root of a checkout. Builds chip_smoke.py's bench index (1M
docs, 200k-term Zipf vocabulary, batch 512, k 10) in sparse mode and, for
each of its paths (default packed launch, ``unified=True``,
``NEXTSEARCH_SELECT_PALLAS=1``), then in fused mode for the one fused path:

1. serial: ``--serial`` batches through ``search_batch`` (each waits for
   its results) under ``torch.profiler``. ``device_ms_per_batch`` is the
   union of the trace's kernel, memcpy and memset intervals; an aten op's
   own device time is not added to its kernels'. ``kernels_per_batch``
   counts kernel events; ``top_kernels`` are the largest by summed time.
2. loop: ``--loop`` batches of the depth-2 pipelined loop that chip_smoke.py
   times, without the profiler: ``period_ms`` (wall ms per batch),
   ``qps``, and the median host ms of ``search_batch_async`` and of
   ``search_batch_gather`` (the gather includes waiting for the device).
   ``idle_share_est`` = 1 - serial device ms / period.
3. traced loop: the same loop under the profiler. ``idle_share`` = 1 -
   busy / span over the span from the device's first to its last event.
   The profiler slows the host, so this share bounds the untraced loop's
   from above.

Prints one JSON line per path and writes the list to ``--out``
(default ``chiprun_out/profile_paths.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# the trace reader lives with the benchmark scripts, which use it too
from nextsearch_tpu_torch.benchmarks.common import (  # noqa: E402,F401
    DEVICE_CATS, busy_us, device_events, summarize, traced,
)
# name, index mode, DeviceConfig fields, environment
PATHS = (
    ("default", "sparse", {}, {}),
    ("unified", "sparse", {"unified": True}, {}),
    ("K4", "sparse", {}, {"NEXTSEARCH_SELECT_PALLAS": "1"}),
    ("fused", "fused", {}, {}),
)


def pipelined(ti, batches, n: int, k: int) -> dict:
    """n batches at depth 2: wall period, QPS and host times."""
    import torch

    window, lat, t_async, t_gather = [], [], [], []

    def gather_one():
        s0, h = window.pop(0)
        g0 = time.perf_counter()
        ti.search_batch_gather(h)
        now = time.perf_counter()
        t_gather.append(now - g0)
        lat.append(now - s0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        b0 = time.perf_counter()
        h = ti.search_batch_async(batches[1 + i % (len(batches) - 1)], k=k)
        t_async.append(time.perf_counter() - b0)
        window.append((b0, h))
        if len(window) > 2:
            gather_one()
    while window:
        gather_one()
    el = time.perf_counter() - t0
    q = len(batches[0])
    return dict(
        period_ms=el * 1e3 / n, qps=n * q / el,
        p50_ms=statistics.median(lat) * 1e3,
        host_async_ms=statistics.median(t_async) * 1e3,
        host_gather_ms=statistics.median(t_gather) * 1e3,
    )


def profile_path(ti, batches, k: int, n_serial: int, n_loop: int) -> dict:
    def serial():
        for b in batches[1:1 + n_serial]:
            ti.search_batch(b, k=k)

    for b in batches[1:4]:  # warm
        ti.search_batch(b, k=k)
    out = dict(serial=traced(serial, n_serial))
    loop = pipelined(ti, batches, n_loop, k)
    loop["idle_share_est"] = 1.0 - out["serial"]["device_ms_per_batch"] / loop["period_ms"]
    out["loop"] = loop
    out["traced_loop"] = traced(lambda: pipelined(ti, batches, n_loop, k), n_loop)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serial", type=int, default=10)
    ap.add_argument("--loop", type=int, default=100)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile_paths.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device: profile_paths.py runs on a card only", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    results = []
    ti = built = None
    for name, mode, fields, env in PATHS:
        if mode != built:
            del ti
            torch.cuda.empty_cache()
            _seg, ti, batches = cs.build_index(device, cs.N_DOCS, cs.VOCAB,
                                               cs.BATCH, 64, mode=mode)
            cfg, built = ti.config, mode
        ti.config = replace(cfg, device=replace(cfg.device, **fields))
        with mock.patch.dict(os.environ, env):
            r = dict(path=name, card=card,
                     **profile_path(ti, batches, cs.K, args.serial, args.loop))
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
