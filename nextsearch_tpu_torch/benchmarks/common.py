"""Shared pieces of the probe scripts: the card requirement, kernel timing
with CUDA events, and the bench corpus.

Every time here is a device time between two CUDA events on the card; a
script that finds no card exits with an error instead of timing the CPU.
"""

from __future__ import annotations

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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10, *, warm: int = 1) -> float:
    """Median milliseconds of fn() over reps runs, each timed by a pair of
    CUDA events on the current stream (host launch gaps included)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def row(name: str, ms: float) -> str:
    line = f"{name:40s} {ms:10.4f} ms"
    print(line, flush=True)
    return line


def bench_corpus(n_docs: int, vocab: int, seed: int = 0):
    """(segment, term probabilities) of tools/synthetic.build_corpus, cached
    as an artifact under the temp dir (NEXTSEARCH_BENCH_CACHE overrides)."""
    from nextsearch_tpu.index.artifacts import load_artifact, save_artifact

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
