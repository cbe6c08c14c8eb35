#!/usr/bin/env python3
"""Where the time goes on the port's three sparse paths and on its fused
mode (the library default), and on request its exact and fast modes, on
one CUDA card, with the launches run eagerly and as CUDA graphs.

    python3 profile_paths.py [--serial 10] [--loop 100] [--paths P,...]
                             [--turns eager,graphed,graphed,eager] [--out FILE]
    python3 profile_paths.py --memory [--loop 100] [--paths P,...] [--out FILE]

Run from the root of a checkout. Builds chip_smoke.py's bench index (1M
docs, 200k-term Zipf vocabulary, batch 512, k 10) in sparse mode and, for
each of its paths (default packed launch, ``unified=True``,
``NEXTSEARCH_SELECT_PALLAS=1``), then in fused mode for the one fused path,
measures each of ``--turns`` in order. ``--paths`` names the paths (default
the four above); ``exact`` and ``fast`` run the fused index in exact and
fast mode at the library's posting block of 2048 on the first 64 queries
of each batch, as chip_smoke.py's (n) and (o) (exact mode stays eager, so
its two turns differ only in noise). Each path and turn: ``eager`` swaps in a launch cache
built under NEXTSEARCH_CUDA_GRAPHS=0, ``graphed`` the path's own launch
cache (ops/graphs.py), whose first turn captures the path's graphs and
whose later turns replay them. Each turn first warms on three batches
(``warm_batch``: the launch and its exact relaunch), then:

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

``graphs`` gives the turn's captures in its warm-up (``captures``) and
after it (``captures_after_warm``: 0 at pinned shapes), the seconds they
took, the graphs held and the tensors the serial batches' replays copied
in and out (``copies_serial``). ``kernels_by_name`` in ``serial`` counts
each kernel's launches over the serial batches; ``kernel_mix_mismatch``
holds a graphed turn's against an eager one's.

Prints one JSON line per path and turn and writes the list to ``--out``
(default ``chiprun_out/profile_paths.json``).

``--memory`` measures what the launches hold on the card, each path eager
(NEXTSEARCH_CUDA_GRAPHS=0) and graphed, each in a fresh process: the bytes
the card holds once the allocator's free blocks are returned
(``memory_reserved`` after ``empty_cache``) with the index alone, and again
after the turn's warm-up and ``--loop`` pipelined batches, and the peak
reserved and allocated bytes over the turn. A graph pool's blocks stay
reserved while its graphs live, though they are not "allocated" between
replays, so only the reserved bytes show it. Writes the list to ``--out``
(default ``chiprun_out/profile_paths_memory.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
    ("exact", "fused", {"mode": "exact", "posting_block": 2048}, {}),
    ("fast", "fused", {"mode": "fast", "posting_block": 2048}, {}),
)
DEFAULT_PATHS = "default,unified,K4,fused"
# queries a batch where a path takes fewer than the index's batch
PATH_BATCH = {"exact": 64, "fast": 64}


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
    import torch

    def serial():
        for b in batches[1:1 + n_serial]:
            ti.search_batch(b, k=k)

    cache = ti.launch_cache
    c0, s0 = cache.captures, cache.capture_s
    for b in batches[1:4]:  # warm, capturing the path's graphs
        ti.warm_batch(b, k=k)
    c1 = cache.captures
    r0 = cache.copies
    out = dict(serial=traced(serial, n_serial))
    copies_serial = cache.copies - r0
    loop = pipelined(ti, batches, n_loop, k)
    loop["idle_share_est"] = 1.0 - out["serial"]["device_ms_per_batch"] / loop["period_ms"]
    out["loop"] = loop
    out["traced_loop"] = traced(lambda: pipelined(ti, batches, n_loop, k), n_loop)
    out["graphs"] = dict(captures=c1 - c0, capture_s=cache.capture_s - s0,
                         captures_after_warm=cache.captures - c1,
                         held=len(cache.keys()), copies_serial=copies_serial)
    return out


def kernel_mix_diff(eager: dict, graphed: dict) -> dict:
    """{kernel name: graphed launches - eager launches} over two traced
    runs of the same batches (summarize's kernels_by_name), where they
    differ: empty when the graphs replay the eager launch's kernels."""
    e, g = eager["kernels_by_name"], graphed["kernels_by_name"]
    return {n: g.get(n, 0) - e.get(n, 0) for n in {**e, **g}
            if g.get(n, 0) != e.get(n, 0)}


# Two traces of the same eager batches differ by up to a few kernel events
# (CUPTI's records; 359.8 against 359.6 a batch over 10 batches of the
# fused path on an H100): a name's count may move by
# MIX_SLACK events or 1% of it, the total by 1%, the memory operations by
# MEM_SLACK a batch.
MIX_SLACK = 2
MEM_SLACK = 0.5
# CUDA may run a graph's memset and memcpy nodes as kernels of its
# own (memset32, memcpy128, memcpy32_post seen on the H100), where the
# eager launch's cudaMemsetAsync and cudaMemcpyAsync are memset and copy
# events: they count as memory operations, not kernels.
_NODE_KERNEL = re.compile(r"^mem(set|cpy)\d+(_\w+)?$")


def split_node_kernels(s: dict) -> tuple:
    """summarize()'s kernels_by_name without CUDA's memset and memcpy
    node kernels, and the memory operations a batch (copies,
    memsets and those kernels)."""
    kern, nodes = {}, 0
    for n, c in s["kernels_by_name"].items():
        if _NODE_KERNEL.match(n):
            nodes += c
        else:
            kern[n] = c
    mem = s["copies_per_batch"] + s["memsets_per_batch"] + nodes / s["batches"]
    return kern, mem


def kernel_mix_mismatch(eager: dict, graphed: dict,
                        added_copies: float = 0.0) -> dict:
    """What a graphed trace of the same batches launches beyond an eager
    trace's, past the traces' own noise: kernels by name (and "total" when
    all of them moved more than 1%), and "memory operations a batch" when
    those did not grow by the replays' own copies, added_copies a batch
    (each replay copies its plan tensors in and its results out). Empty
    when the graphs replay the eager launch."""
    ke, me = split_node_kernels(eager)
    kg, mg = split_node_kernels(graphed)
    diff = kernel_mix_diff({"kernels_by_name": ke}, {"kernels_by_name": kg})
    bad = {n: d for n, d in diff.items()
           if abs(d) > max(MIX_SLACK, 0.01 * max(ke.get(n, 0), kg.get(n, 0)))}
    total = sum(diff.values())
    if abs(total) > 0.01 * sum(ke.values()):
        bad["total"] = total
    if abs(mg - me - added_copies) > MEM_SLACK:
        bad["memory operations a batch"] = round(mg - me, 3)
    return bad


def _held(device) -> int:
    """The bytes the card holds once the allocator's free blocks are
    returned."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def memory_turn(name: str, n_loop: int) -> dict:
    """--memory's measurement of one path in this process, graphed or
    eager as NEXTSEARCH_CUDA_GRAPHS says."""
    import torch

    import chip_smoke as cs

    _n, mode, fields, env = next(p for p in PATHS if p[0] == name)
    device = torch.device("cuda")
    _seg, ti, batches = cs.build_index(device, cs.N_DOCS, cs.VOCAB, cs.BATCH,
                                       64, mode=mode)
    ti.config = replace(ti.config, device=replace(ti.config.device, **fields))
    batches = [b[:PATH_BATCH.get(name, cs.BATCH)] for b in batches]
    index = _held(device)
    torch.cuda.reset_peak_memory_stats(device)
    with mock.patch.dict(os.environ, env):
        for b in batches[1:4]:
            ti.warm_batch(b, k=cs.K)
        loop = pipelined(ti, batches, n_loop, cs.K)
    peak = torch.cuda.max_memory_reserved(device)
    peak_alloc = torch.cuda.max_memory_allocated(device)
    held = _held(device)
    return dict(path=name, graphed=ti.launch_cache.enabled,
                captures=ti.launch_cache.captures, index_reserved=index,
                held_after=held, launch_held=held - index,
                peak_reserved=peak, peak_allocated=peak_alloc,
                period_ms=loop["period_ms"])


def memory(args, card: str) -> list:
    """memory_turn for every path, eager then graphed, each in a fresh
    process."""
    import subprocess

    results = []
    for name in args.paths.split(","):
        for graphs in ("0", "1"):
            run = subprocess.run(
                [sys.executable, __file__, "--memory-of", name,
                 "--loop", str(args.loop)],
                env={**os.environ, "NEXTSEARCH_CUDA_GRAPHS": graphs},
                capture_output=True, text=True, check=True)
            r = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                     card=card)
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serial", type=int, default=10)
    ap.add_argument("--loop", type=int, default=100)
    ap.add_argument("--turns", default="eager,graphed,graphed,eager")
    ap.add_argument("--paths", default=DEFAULT_PATHS)
    ap.add_argument("--memory", action="store_true")
    ap.add_argument("--memory-of", help=argparse.SUPPRESS)  # one path
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from nextsearch_tpu_torch.benchmarks.common import eager_cache
    from nextsearch_tpu_torch.ops.graphs import LaunchCache

    if not torch.cuda.is_available():
        print("no CUDA device: profile_paths.py runs on a card only", file=sys.stderr)
        return 2
    if args.memory_of:
        print(json.dumps(memory_turn(args.memory_of, args.loop)), flush=True)
        return 0
    device = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    out = Path(args.out or REPO / "chiprun_out" / (
        "profile_paths_memory.json" if args.memory else "profile_paths.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.memory:
        out.write_text(json.dumps(memory(args, card), indent=1))
        return 0
    results = []
    ti = built = caches = None
    for name, mode, fields, env in PATHS:
        if name not in args.paths.split(","):
            continue
        if mode != built:
            caches = None  # the old index's graphs hold its tables
            del ti
            torch.cuda.empty_cache()
            _seg, ti, batches = cs.build_index(device, cs.N_DOCS, cs.VOCAB,
                                               cs.BATCH, 64, mode=mode)
            cfg, built = ti.config, mode
        ti.config = replace(cfg, device=replace(cfg.device, **fields))
        caches = dict(eager=eager_cache(device), graphed=LaunchCache(device))
        nq = PATH_BATCH.get(name, cs.BATCH)
        path_batches = [b[:nq] for b in batches]
        with mock.patch.dict(os.environ, env):
            for turn in args.turns.split(","):
                ti.launch_cache = caches[turn]
                r = dict(path=name, launch=turn, card=card, batch=nq,
                         **profile_path(ti, path_batches, cs.K, args.serial,
                                        args.loop))
                print(json.dumps(r), flush=True)
                results.append(r)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
