"""Tracing and profiling utilities.

The reference's tracing is steady_clock spans around search surfaced as
response timing fields (src/api_server.cpp:120-175) — those fields are kept
by api/server.py. This module adds the framework-level layer promised in
SURVEY.md §5: the port's one tracer (GLOBAL_TRACER: named spans at the
served path's layer boundaries, integer counters, and while it records a
bounded ring of timestamped span records) and optional torch.profiler
trace capture.

The tracer records between GLOBAL_TRACER.start() and stop(), and whenever
a torch.profiler session is active; then each span is also a
torch.profiler.record_function range, so the program's spans land in the
profiler's Chrome trace beside the kernels, on the trace's clock. Records
carry time.perf_counter_ns() stamps.

Env: NEXTSEARCH_PROFILE_DIR=<dir> enables torch.profiler traces around
device calls, written as Chrome traces (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler

from .logging import log

# records the ring keeps while the tracer records; the oldest drop
RING = 65536


def _profiler_active() -> bool:
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class Record(NamedTuple):
    """One span as recorded: its name, start and end (perf_counter_ns),
    the thread that ran it, the name of the span around it on that thread
    (None at the top) and the batch id set on that thread (None outside a
    batch)."""

    name: str
    t0_ns: int
    t1_ns: int
    thread: int
    parent: Optional[str]
    batch: Optional[int]


class _Local(threading.local):
    def __init__(self):
        self.stack: List[str] = []  # names of the open recorded spans
        self.batch: Optional[int] = None


class _Span:
    """One span: totals always; a record (and under a profiler a
    record_function range) where the tracer records at its start. Its
    times hold the record_function's own cost, so a parent's time outside
    its children is its own work."""

    __slots__ = ("_tracer", "_name", "_t0", "_parent", "_rf", "_rec")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name
        self._rf = None

    def __enter__(self):
        tr = self._tracer
        prof = _profiler_active()
        self._rec = tr._started or prof
        self._t0 = time.perf_counter_ns()
        if self._rec:
            stack = tr._local.stack
            self._parent = stack[-1] if stack else None
            stack.append(self._name)
            if prof:
                self._rf = _autograd_profiler.record_function(self._name)
                self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        if self._rec:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            tr._local.stack.pop()
        t1 = time.perf_counter_ns()
        tr._total(self._name, t1 - self._t0)
        if self._rec:
            tr._ring.append(Record(self._name, self._t0, t1,
                                   threading.get_ident(), self._parent,
                                   tr._local.batch))
        return False


class Tracer:
    """Thread-safe named spans and counters.

    span(name) always adds to the name's count and total (the operator's
    totals); count(name, n) keeps integer counters, always on. While the
    tracer records (between start() and stop(), or while a torch.profiler
    session is active) each span also appends a Record to a ring of
    `ring` records, the oldest dropping, with its parent from a
    thread-local stack and the batch id that batch() set on its thread."""

    def __init__(self, ring: int = RING):
        self._lock = threading.Lock()
        self._spans: Dict[str, List[int]] = {}  # name -> [count, total ns]
        self._counters: Dict[str, int] = {}
        self._ring: "deque[Record]" = deque(maxlen=ring)
        self._started = False
        self._local = _Local()
        self._batch_ids = itertools.count(1)

    def start(self) -> None:
        self._started = True

    def stop(self) -> None:
        self._started = False

    def recording(self) -> bool:
        return self._started or _profiler_active()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _total(self, name: str, ns: int) -> None:
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                self._spans[name] = [1, ns]
            else:
                s[0] += 1
                s[1] += ns

    def add(self, name: str, t0_ns: int, t1_ns: int,
            batch: Optional[int] = None) -> None:
        """A span timed elsewhere (a unit's wait in a queue, the card's
        idle gap): to the totals always, and to the ring while the tracer
        records, under `batch` (else the thread's batch id) and the
        thread's open span as parent."""
        self._total(name, t1_ns - t0_ns)
        if self.recording():
            loc = self._local
            self._ring.append(Record(
                name, t0_ns, t1_ns, threading.get_ident(),
                loc.stack[-1] if loc.stack else None,
                loc.batch if batch is None else batch))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def new_batch(self) -> int:
        """A fresh batch id (unique in the process)."""
        return next(self._batch_ids)

    def batch_id(self) -> Optional[int]:
        """The batch id set on this thread, or None."""
        return self._local.batch

    @contextmanager
    def batch(self, batch_id: int):
        """Tag the spans this thread records inside with `batch_id`."""
        loc = self._local
        prev, loc.batch = loc.batch, batch_id
        try:
            yield
        finally:
            loc.batch = prev

    def records(self, t0_ns: Optional[int] = None,
                t1_ns: Optional[int] = None) -> List[Record]:
        """The ring's records that overlap [t0_ns, t1_ns] (either end
        open where None), oldest first."""
        recs = list(self._ring)
        return [r for r in recs
                if (t0_ns is None or r.t1_ns >= t0_ns)
                and (t1_ns is None or r.t0_ns <= t1_ns)]

    def report(self) -> dict:
        """{"spans": {name: {count, total_ms}}, "counters": {name: n}}."""
        with self._lock:
            return {
                "spans": {name: {"count": n, "total_ms": round(ns / 1e6, 3)}
                          for name, (n, ns) in self._spans.items()},
                "counters": dict(self._counters),
            }

    def reset(self) -> None:
        """Drop every total, counter and record."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._ring.clear()


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
