"""The one traffic generator: a closed loop over a SearchBatcher.

A traffic mix is a JSON file under searchbench/traffic/ that this module
reads; no mix has code of its own. Keys:

  loop                 "closed" (the only loop this generator drives)
  clients              threads, each sending search_many requests of
  queries_per_request  queries, the next as soon as the last returns
  stream               queries of the window, drawn from the seed, every
                       text distinct; taken in order, wrapping around
  warm_seconds         the same traffic before the window (set-up), on
                       queries of its own, distinct from the window's
  host_cpus            optional: the CPUs, each on a core of its own, that
                       the whole process is pinned to from the warm stretch
                       on (run.pin_host)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .corpus import draw_queries, query_text


@dataclass
class Window:
    """What one stretch of traffic sent and got back."""

    t_start: float
    t_end: float
    # (term ids, query text, sent time, done time, served or None)
    answers: List[tuple] = field(default_factory=list)
    # (sent time, done time, queries, answered) of each request
    requests: List[tuple] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    answered_in_window: int = 0


def query_stream(cfg: dict, n: int, rng):
    """n (term ids, text) queries of configuration `cfg`."""
    return [(t, query_text(t)) for t in draw_queries(cfg, n, rng)]


def distinct_stream(cfg: dict, n: int, rng):
    """n queries with distinct texts, in the order drawn."""
    seen, out = set(), []
    while len(out) < n:
        for t, text in query_stream(cfg, n, rng):
            if text not in seen:
                seen.add(text)
                out.append((t, text))
                if len(out) == n:
                    break
    return out


class Traffic:
    """The requests of one run, drawn from its seed before any is sent."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.mix = mix
        self.k = int(cfg["k"])
        rng = np.random.default_rng([int(seed), 1])
        n = int(mix["stream"])
        queries = distinct_stream(cfg, n + n // 8, rng)
        self.stream, self.warm = queries[:n], queries[n:]

    def warm_up(self, batcher) -> None:
        self._closed(batcher, self.warm, float(self.mix["warm_seconds"]))

    def extra(self, batcher, seconds: float) -> Window:
        """More of the same traffic after the window (the traced stretch),
        on the warm stretch's queries."""
        return self._closed(batcher, self.warm, seconds)

    def window(self, batcher, seconds: float) -> Window:
        return self._closed(batcher, self.stream, seconds)

    def _closed(self, batcher, stream, seconds: float) -> Window:
        per = int(self.mix["queries_per_request"])
        lock = threading.Lock()
        cursor = [0]
        t0 = time.perf_counter()
        win = Window(t0, t0 + seconds)
        records: list = []

        def client():
            while True:
                with lock:
                    if time.perf_counter() >= win.t_end:
                        return
                    i = cursor[0]
                    cursor[0] += per
                qs = [stream[(i + j) % len(stream)] for j in range(per)]
                t_sent = time.perf_counter()
                try:
                    res: Optional[list] = batcher.search_many(
                        [(text, self.k) for _t, text in qs])
                except Exception:  # noqa: BLE001 - a failed request counts
                    res = None
                records.append((qs, t_sent, time.perf_counter(), res))

        threads = [threading.Thread(target=client, name=f"client-{c}")
                   for c in range(int(self.mix["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for qs, t_sent, t_done, res in records:
            win.attempted += len(qs)
            ok = res is not None and len(res) == len(qs)
            win.requests.append((t_sent, t_done, len(qs), ok))
            if not ok:
                win.failed += len(qs)
                res = [None] * len(qs)
            elif t_done <= win.t_end:
                win.answered_in_window += len(qs)
            for (tids, text), r in zip(qs, res):
                win.answers.append((tids, text, t_sent, t_done, r))
        return win
