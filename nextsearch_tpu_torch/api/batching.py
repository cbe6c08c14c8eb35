"""Request-batching queue: coalesce concurrent searches into one launch.

The reference serializes every search behind an engine-wide mutex
(include/api_engine.hpp:62). Here concurrent HTTP threads submit into a
queue; a dispatcher thread drains up to `max_batch` requests within a
`window_ms` coalescing window and runs them as ONE batched device kernel
(Engine.search_batch), amortizing kernel launches across requests — the
BASELINE.json north-star serving pattern.

PipelinedBatcher extends this with the depth-2 launch pipeline the bench
harness measures: the dispatcher launches batch N+1 (host planning + device
dispatch via Engine.search_batch_async) BEFORE gathering batch N, so the
~12.7 ms per-launch relay floor and the host planning of the next batch are
hidden behind device execution instead of serialized after it. Depth 2 is
enough (probe_depth.py: 13,988/13,997 QPS at depths 2/8; deeper queues only
add wait time).

Tracing (utils/profiling.GLOBAL_TRACER): the dispatcher numbers its
launches with batch ids and sets each around its launch and gather, so
the spans below them carry it; each unit's wait from its submit to the
launch that takes it is a span `<name>.queue`, and each coalescing window
that forms a batch a span `<name>.form`.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Tuple

from ..config import BatchingConfig
from ..utils.profiling import GLOBAL_TRACER

# A queue unit: (requests, future, multi, submitted). `multi` units carry a
# LIST of requests resolved by ONE future (the batched HTTP endpoint) —
# per-request future wakeups cost ~40us each on the 1-core host, so a
# 512-query HTTP batch pays one wakeup instead of 512. `submitted` is the
# perf_counter_ns of its submit.
_Unit = Tuple[list, Future, bool, int]


class MicroBatcher:
    """Generic coalescing dispatcher: many submit() -> one batch_fn call.

    Two modes:
      - sync: `batch_fn(requests) -> results` (one blocking call per window)
      - pipelined: `launch_fn(requests) -> state`, `gather_fn(state) ->
        results`, with up to `depth` launches in flight.
    """

    def __init__(
        self,
        batch_fn=None,
        config: BatchingConfig = None,
        name: str = "batcher",
        launch_fn=None,
        gather_fn=None,
        depth: int = 1,
    ):
        if batch_fn is None and (launch_fn is None or gather_fn is None):
            raise ValueError("need batch_fn or launch_fn+gather_fn")
        self.batch_fn = batch_fn
        self.launch_fn = launch_fn
        self.gather_fn = gather_fn
        self.depth = max(1, int(depth))
        self.config = config
        self._queue_span = f"{name}.queue"
        self._form_span = f"{name}.form"
        self._q: "queue.Queue[_Unit]" = queue.Queue()
        # One-slot pushback buffer: a unit that would overflow max_batch is
        # held here for the NEXT window instead of being appended (only the
        # dispatcher thread touches it). Without this, a single coalescing
        # with a 512-query chunk forms a 513-wide batch — an UNPINNED Q
        # envelope, i.e. a fresh XLA compile mid-serving (the recompile
        # failure class the serving rules forbid).
        self._pushback: Optional[_Unit] = None
        self._stop = threading.Event()
        run = self._run_pipelined if launch_fn is not None else self._run
        self._thread = threading.Thread(target=run, name=name, daemon=True)
        self._thread.start()

    def submit(self, request) -> Future:
        fut: Future = Future()
        self._q.put(([request], fut, False, time.perf_counter_ns()))
        return fut

    def submit_many(self, requests: list) -> Future:
        """One future resolving to the result list for `requests` (in order).

        The unit coalesces with concurrently submitted singles; results are
        sliced back out by the dispatcher. Units larger than max_batch are
        split across launches by the caller (see SearchBatcher.search_many).
        """
        fut: Future = Future()
        self._q.put((list(requests), fut, True, time.perf_counter_ns()))
        return fut

    def call(self, request):
        return self.submit(request).result()

    def shutdown(self) -> None:
        self._stop.set()
        self._q.put(([], None, False, 0))  # wake the dispatcher
        self._thread.join(timeout=2)

    # ---------------- internals ----------------

    def _drain(self, block: bool) -> List[_Unit]:
        """One coalescing window of queue units (possibly empty).

        Invariant: the flat batch never exceeds max_batch (every envelope the
        dispatcher emits is one warmup pinned). A unit that would overflow
        the current window waits in the one-slot pushback buffer.
        """
        if self._pushback is not None:
            units = [self._pushback]
            self._pushback = None
        else:
            try:
                item = (
                    self._q.get(timeout=0.2) if block else self._q.get_nowait()
                )
            except queue.Empty:
                return []
            if item[1] is None:
                return []
            units = [item]
        count = sum(len(u[0]) for u in units)
        # Adaptive operating point: a shallow queue targets the SMALL
        # warmed envelope with a short window (interactive p50 — batch-64
        # exec is ~31 ms vs 85 ms at 512, measured BENCH_r04); a deep
        # queue keeps the throughput point. Queue depth is re-checked as
        # units drain so a burst arriving mid-window still widens the
        # target to max_batch.
        small = self.config.small_batch
        max_batch = self.config.max_batch
        adaptive = 0 < small < max_batch
        if adaptive and count + self._q.qsize() > small:
            target, window_ms = max_batch, self.config.window_ms
        elif adaptive:
            target, window_ms = small, self.config.small_window_ms
        else:
            target, window_ms = max_batch, self.config.window_ms
        deadline = time.monotonic() + window_ms / 1000.0
        while count < target:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt[1] is None:
                continue
            if count + len(nxt[0]) > target:
                if (
                    adaptive
                    and target < max_batch
                    and count + len(nxt[0]) <= max_batch
                ):
                    # burst mid-window: widen to the throughput point
                    target = max_batch
                    deadline = time.monotonic() + (
                        self.config.window_ms / 1000.0
                    )
                else:
                    self._pushback = nxt
                    break
            units.append(nxt)
            count += len(nxt[0])
        return units

    @staticmethod
    def _resolve(units: List[_Unit], results) -> None:
        pos = 0
        for reqs, fut, multi, _t in units:
            n = len(reqs)
            if fut.done():
                pos += n
                continue
            if multi:
                fut.set_result(list(results[pos : pos + n]))
            else:
                fut.set_result(results[pos])
            pos += n

    @staticmethod
    def _fail(units: List[_Unit], exc: Exception) -> None:
        for _reqs, fut, _multi, _t in units:
            if fut is not None and not fut.done():
                fut.set_exception(exc)

    def _abandon_remaining(self) -> None:
        """Fail everything still queued at shutdown so no caller blocks
        forever in fut.result() (search_many waits without a timeout)."""
        exc = RuntimeError("batcher shut down")
        leftovers: List[_Unit] = []
        if self._pushback is not None:
            leftovers.append(self._pushback)
            self._pushback = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        self._fail(leftovers, exc)

    def _take(self, units: List[_Unit], formed_from: int) -> int:
        """Number the launch that takes `units` and record, under its batch
        id, the window that formed it (from `formed_from`) and each unit's
        wait since its submit."""
        bid = GLOBAL_TRACER.new_batch()
        now = time.perf_counter_ns()
        GLOBAL_TRACER.add(self._form_span, formed_from, now, batch=bid)
        for unit in units:
            GLOBAL_TRACER.add(self._queue_span, unit[3], now, batch=bid)
        return bid

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter_ns()
            units = self._drain(block=True)
            if not units:
                continue
            bid = self._take(units, t0)
            flat = [r for reqs, _f, _m, _t in units for r in reqs]
            try:
                with GLOBAL_TRACER.batch(bid):
                    results = self.batch_fn(flat)
                self._resolve(units, results)
            except Exception as e:  # propagate to all waiters
                self._fail(units, e)
        self._abandon_remaining()

    def _run_pipelined(self) -> None:
        inflight: deque = deque()  # (units, state, batch id)
        while not (self._stop.is_set() and not inflight):
            units = []
            if len(inflight) < self.depth and not self._stop.is_set():
                # Block only when the pipe is empty; with work in flight a
                # dry queue should fall through to the gather immediately.
                t0 = time.perf_counter_ns()
                units = self._drain(block=not inflight)
            if units:
                bid = self._take(units, t0)
                flat = [r for reqs, _f, _m, _t in units for r in reqs]
                try:
                    with GLOBAL_TRACER.batch(bid):
                        state = self.launch_fn(flat)
                except Exception as e:
                    self._fail(units, e)
                else:
                    inflight.append((units, state, bid))
                continue
            if inflight:
                done_units, state, bid = inflight.popleft()
                try:
                    with GLOBAL_TRACER.batch(bid):
                        results = self.gather_fn(state)
                    self._resolve(done_units, results)
                except Exception as e:
                    self._fail(done_units, e)
        self._abandon_remaining()


class SearchBatcher(MicroBatcher):
    """Pipelined search dispatcher over Engine.search_batch_async/gather."""

    def __init__(self, engine, config: BatchingConfig):
        super().__init__(
            config=config,
            name="search-batcher",
            launch_fn=engine.search_batch_async,
            gather_fn=engine.search_batch_gather,
            depth=config.pipeline_depth,
        )
        self.engine = engine

    def search(self, query: str, k: int) -> dict:
        return self.call((query, k))

    def search_many(self, requests: List[Tuple[str, int]]) -> List[dict]:
        """Batched entry (POST /api/search_batch): one future per max_batch
        chunk; chunks pipeline through the same dispatcher as singles."""
        mb = self.config.max_batch
        futs = [
            self.submit_many(requests[i : i + mb])
            for i in range(0, len(requests), mb)
        ]
        out: List[dict] = []
        for f in futs:
            out.extend(f.result())
        return out


class SuggestBatcher(MicroBatcher):
    """Coalesce /api/suggest lookups into one prefix-range device launch."""

    def __init__(self, engine, config: BatchingConfig):
        def batch_fn(requests):
            # Snapshot the autocomplete table instead of holding engine.mtx
            # through the device launch: reload() swaps engine.ac atomically
            # (engine.reload builds new_ac then assigns), so suggests never
            # serialize behind a slow search/reload.
            ac = engine.ac
            if ac.empty():
                return [[] for _ in requests]
            # group by limit (kernel L is static); usually one group
            out = [None] * len(requests)
            by_limit = {}
            for i, (q, lim) in enumerate(requests):
                by_limit.setdefault(lim, []).append((i, q))
            for lim, items in by_limit.items():
                res = ac.suggest_batch([q for _, q in items], lim)
                for (i, _q), r in zip(items, res):
                    out[i] = r
            return out

        super().__init__(batch_fn, config, name="suggest-batcher")
        self.engine = engine

    def suggest(self, user_input: str, limit: int) -> list:
        return self.call((user_input, limit))
