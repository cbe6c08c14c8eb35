"""Tracing and profiling utilities.

The reference's tracing is steady_clock spans around search surfaced as
response timing fields (src/api_server.cpp:120-175) — those fields are kept
by api/server.py. This module adds the framework-level layer promised in
SURVEY.md §5: aggregated span timings (per-phase p50/total) and optional
torch.profiler trace capture.

Env: NEXTSEARCH_PROFILE_DIR=<dir> enables torch.profiler traces around
device calls, written as Chrome traces (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

from .logging import log


class Tracer:
    """Thread-safe named-span aggregator ([tag] -> count/total/p50)."""

    def __init__(self, keep: int = 512):
        self._lock = threading.Lock()
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)
        self._totals: Dict[str, float] = defaultdict(float)
        self._keep = keep

    @contextmanager
    def span(self, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._counts[tag] += 1
                self._totals[tag] += dt
                s = self._samples[tag]
                s.append(dt)
                if len(s) > self._keep:
                    del s[: len(s) - self._keep]

    def record(self, tag: str, seconds: float) -> None:
        with self._lock:
            self._counts[tag] += 1
            self._totals[tag] += seconds
            s = self._samples[tag]
            s.append(seconds)
            if len(s) > self._keep:
                del s[: len(s) - self._keep]

    def report(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for tag, n in self._counts.items():
                s = sorted(self._samples[tag])
                p50 = s[len(s) // 2] if s else 0.0
                p99 = s[min(len(s) - 1, int(len(s) * 0.99))] if s else 0.0
                out[tag] = {
                    "count": n,
                    "total_ms": round(self._totals[tag] * 1000, 3),
                    "p50_ms": round(p50 * 1000, 3),
                    "p99_ms": round(p99 * 1000, 3),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counts.clear()
            self._totals.clear()


GLOBAL_TRACER = Tracer()


_TRACE_LOCK = threading.Lock()  # torch.profiler runs one trace per process


@contextmanager
def device_trace(tag: str = "trace"):
    """torch.profiler trace (CPU activities, and CUDA ones when a card is
    present) written as a Chrome trace under $NEXTSEARCH_PROFILE_DIR/<tag>/
    when the variable is set; a no-op otherwise. On a card the trace waits
    for the kernels launched inside it before it closes (a trace records
    the kernels launched while it is open). The reference's
    jax.profiler.trace cannot nest either: a trace asked for while another
    is open (overlapping requests) is skipped and logged, and a profiler
    that fails to start or to write is logged; the traced call runs
    either way."""
    profile_dir = os.environ.get("NEXTSEARCH_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    if not _TRACE_LOCK.acquire(blocking=False):
        log("profile", f"trace {tag!r} skipped: another trace is open")
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = None
        try:
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 - never fail the traced call
            log("profile", f"trace {tag!r} not started: {e}", level="error")
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                try:
                    if cuda:  # the kernels launched inside run to their end
                        torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                    out = os.path.join(profile_dir, tag)
                    os.makedirs(out, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        out, f"trace_{os.getpid()}_{time.time_ns()}.json"))
                except Exception as e:  # noqa: BLE001
                    log("profile", f"trace {tag!r} not written: {e}",
                        level="error")
    finally:
        _TRACE_LOCK.release()
