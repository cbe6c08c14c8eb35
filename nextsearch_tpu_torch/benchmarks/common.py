"""Shared pieces of the probe scripts: the card requirement, kernel timing
with CUDA events, and the bench corpus.

Every time here is a device time between two CUDA events on the card; a
script that finds no card exits with an error instead of timing the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch


def require_cuda(name: str = "cuda") -> torch.device:
    """The CUDA device to measure on; raises when there is none."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe scripts time the card only")
    return torch.device(name)


def eager_cache(device):
    """A launch cache that runs every launch eagerly, for the eager side of
    a graphed/eager A/B on one index: swap it in as the index's
    launch_cache."""
    from ..ops.graphs import LaunchCache

    return LaunchCache(device, enabled=False)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10, *, warm: int = 1, inner: int = 1) -> float:
    """Median milliseconds of one fn() over reps timings, each a pair of CUDA
    events on the current stream around `inner` back-to-back calls, divided
    by inner. With inner = 1 a call shorter than the host takes to issue it
    reads as the host's time; with enough calls between the events the
    device queue stays full and the reading is the device's time per call
    (or the host's per call, where the host is the slower of the two)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# trace event categories that are device time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace: dict) -> list:
    """(start_us, end_us, name, cat) of the trace's device events."""
    return [
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""),
         e["cat"])
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    ]


def busy_us(events) -> float:
    """Length of the union of the events' [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, *_ in sorted(events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(trace: dict, n_batches: int, top: int = 10) -> dict:
    """Per-batch device time and kernel count, the span's idle share, the
    largest kernels of one trace, each kernel's launches by full name
    (kernels_by_name) and the copies and memsets a batch."""
    ev = device_events(trace)
    kern = [e for e in ev if e[3] == "kernel"]
    busy = busy_us(ev)
    span = (max(e[1] for e in ev) - min(e[0] for e in ev)) if ev else 0.0
    by_name: dict = {}
    count: dict = {}
    for s, e, name, _ in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        count[name] = count.get(name, 0) + 1
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        device_ms_per_batch=busy / 1e3 / n_batches,
        kernel_sum_ms_per_batch=sum(e - s for s, e, *_ in kern) / 1e3 / n_batches,
        kernels_per_batch=len(kern) / n_batches,
        copies_per_batch=sum(e[3] == "gpu_memcpy" for e in ev) / n_batches,
        memsets_per_batch=sum(e[3] == "gpu_memset" for e in ev) / n_batches,
        span_ms=span / 1e3,
        idle_share=(1.0 - busy / span) if span else None,
        top_kernels=[(name[:80], t / 1e3 / n_batches) for name, t in largest],
        kernels_by_name=count,
        batches=n_batches,
    )


def traced(fn, n_batches: int) -> dict:
    """summarize() of a torch.profiler trace (CPU and CUDA activities) of
    fn(), which runs n_batches batches; the card is synchronized before
    and after."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return summarize(trace, n_batches)


# An event pair should span about this much device work.
SPAN_MS = 2.0
INNER_MAX = 500


def pick_inner(once_ms: float) -> int:
    """How many calls an event pair should span, from one call's time: 1
    for a call of SPAN_MS or more, else enough to fill SPAN_MS, at most
    INNER_MAX."""
    if once_ms >= SPAN_MS:
        return 1
    return max(1, min(INNER_MAX, int(-(-SPAN_MS // max(once_ms, 1e-6)))))


def row(name: str, ms: float) -> str:
    line = f"{name:40s} {ms:10.4f} ms"
    print(line, flush=True)
    return line


def bench_corpus(n_docs: int, vocab: int, seed: int = 0):
    """(segment, term probabilities) of tools/synthetic.build_corpus, cached
    as an artifact under the temp dir (NEXTSEARCH_BENCH_CACHE overrides)."""
    from ..index.artifacts import load_artifact, save_artifact

    from ..tools.synthetic import build_corpus, zipf_probs

    cache = Path(os.environ.get(
        "NEXTSEARCH_BENCH_CACHE",
        Path(tempfile.gettempdir()) / "nextsearch_bench_cache",
    )) / f"{n_docs}_{vocab}_{seed}"
    seg = load_artifact(cache)
    if seg is not None:
        return seg, zipf_probs(vocab)
    seg, probs = build_corpus(n_docs, vocab, seed=seed)
    try:
        save_artifact(seg, cache)
    except OSError as e:
        print(f"corpus cache not written ({e})", flush=True)
    return seg, probs
