"""LRU result caches with JSON persistence.

Parity contract (reference: src/api_engine.cpp:195-366 and :545-806):
  - hashmap + LRU list; get() refreshes recency and returns a copy with
    from_cache=true; put() updates-in-place or evicts the least recently used
  - persisted to a JSON array of {key, result} on every `save_interval`
    updates (reference CACHE_SAVE_INTERVAL=1) and on shutdown
  - load() places file order as oldest-first recency
Keys: search/overview "query|k" (src/api_engine.cpp:190-192), summary
"summary|cord_uid" (src/api_ai_summary.cpp:96).

Each cache counts `<tag>.hits`, `<tag>.misses`, `<tag>.evictions` and
`<tag>.flushes` (writes of its file) in utils/profiling.GLOBAL_TRACER, and
each write is a span `<tag>.flush`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional

from ..utils.logging import log
from ..utils.profiling import GLOBAL_TRACER


def make_cache_key(query: str, k: int) -> str:
    return f"{query}|{k}"


class Rendered(tuple):
    """A pre-serialized per-query search response (native render path).

    `fragment` is the compact JSON bytes of the full per-query response
    object; `cached` marks an LRU hit (the dict path's from_cache flag).
    Immutable, so cache get() can return it without a deep copy; to_dict()
    recovers the dict shape for consumers that mutate (single-GET route,
    AI overview)."""

    __slots__ = ()

    def __new__(cls, fragment: bytes, cached: bool = False):
        return tuple.__new__(cls, (fragment, cached))

    @property
    def fragment(self) -> bytes:
        return self[0]

    @property
    def cached(self) -> bool:
        return self[1]

    def to_dict(self) -> dict:
        d = json.loads(self[0])
        if self[1]:
            d["from_cache"] = True
        return d


def _dump(snapshot) -> bytes:
    """The cache file for (key, result) pairs: a JSON array of
    {"key": key, "result": result}, an entry a line."""
    rows = [
        b'{"key": ' + json.dumps(k).encode() + b', "result": '
        + (v.fragment if isinstance(v, Rendered) else json.dumps(v).encode())
        + b"}"
        for k, v in snapshot
    ]
    return b"[\n" + b",\n".join(rows) + b"\n]\n" if rows else b"[]\n"


class LRUCache:
    """Thread-safe LRU cache of JSON-serializable results."""

    def __init__(
        self,
        capacity: int,
        persist_path: Optional[str | os.PathLike] = None,
        save_interval: int = 1,
        tag: str = "cache",
        flush_ms: float = 0.0,
    ):
        """flush_ms=0 (default): write-through every `save_interval` puts —
        the reference's CACHE_SAVE_INTERVAL=1 semantics. flush_ms>0:
        write-behind — puts mark dirty and a daemon thread persists at most
        once per flush_ms (serving: a full 2600-entry JSON dump PER PUT is
        ~10 ms of host CPU, i.e. a ~100 puts/s ceiling on one core)."""
        self.capacity = int(capacity)
        self.persist_path = Path(persist_path) if persist_path else None
        self.save_interval = max(1, int(save_interval))
        self.tag = tag
        # counter names, made once: a probe and a fill count per query
        self._hits, self._misses, self._evictions = (
            f"{tag}.hits", f"{tag}.misses", f"{tag}.evictions")
        self._data: "OrderedDict[str, Any]" = OrderedDict()  # newest last
        self._updates_since_save = 0
        self._lock = threading.Lock()
        # one writer of <path>.tmp at a time (the flush thread and save())
        self._write_lock = threading.Lock()
        self._dirty = False
        self._flush_ms = float(flush_ms)
        if self._flush_ms > 0:
            self._flush_stop = threading.Event()
            threading.Thread(
                target=self._flush_loop, name=f"{tag}-flush", daemon=True
            ).start()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: str) -> Optional[Any]:
        """Cached result (deep copy) with from_cache=True, or None.

        Rendered fragments are immutable, so they skip the deep copy and
        return re-tagged with cached=True."""
        with self._lock:
            if key not in self._data:
                GLOBAL_TRACER.count(self._misses)
                return None
            GLOBAL_TRACER.count(self._hits)
            self._data.move_to_end(key)
            raw = self._data[key]
            if isinstance(raw, Rendered):
                return Rendered(raw.fragment, True)
            result = json.loads(json.dumps(raw))
        if isinstance(result, dict):
            result["from_cache"] = True
        return result

    def put(self, key: str, result: Any) -> None:
        self.put_many(((key, result),))

    def put_many(self, items) -> None:
        """put(key, result) for each pair in turn, under one hold of the
        lock: the same recency, evictions, dirty flag and saved file as the
        puts one by one. The evictions count once, by their number, and a
        write-through cache writes its file once, as the last of those puts
        that would have written it left it."""
        snapshot = None
        evicted = 0
        due = False  # a write of the cache as it now stands is due
        with self._lock:
            data = self._data
            for key, result in items:
                new = key not in data
                if due and not (new and self._updates_since_save + 1
                                >= self.save_interval):
                    # this put is not itself written: the due write holds
                    # the cache as it was before it
                    snapshot = list(data.items())
                    due = False
                if not new:
                    data.move_to_end(key)
                    data[key] = result
                    continue
                if len(data) >= self.capacity:
                    data.popitem(last=False)
                    evicted += 1
                data[key] = result
                if self._flush_ms > 0:
                    self._dirty = True
                    continue
                self._updates_since_save += 1
                if self._updates_since_save >= self.save_interval:
                    self._updates_since_save = 0
                    due = True
            if due:
                snapshot = list(data.items())
        if evicted:
            GLOBAL_TRACER.count(self._evictions, evicted)
        if snapshot is not None:
            self._save(snapshot)

    # ---------------- persistence ----------------

    def _flush_loop(self) -> None:
        while not self._flush_stop.wait(self._flush_ms / 1000.0):
            with self._lock:
                if not self._dirty:
                    continue
                self._dirty = False
                snapshot = list(self._data.items())
            self._save(snapshot)

    def _save(self, snapshot) -> None:
        if self.persist_path is None:
            return
        GLOBAL_TRACER.count(f"{self.tag}.flushes")
        with GLOBAL_TRACER.span(f"{self.tag}.flush"):
            try:
                # the reference's JSON array of {key, result}, one entry a
                # line; a Rendered fragment is already the result's compact
                # JSON and is written as it is, so a flush of a full cache
                # is a join of bytes, not a re-encoding under the GIL
                data = _dump(snapshot)
                tmp = self.persist_path.with_suffix(".tmp")
                with self._write_lock:
                    tmp.write_bytes(data)
                    tmp.replace(self.persist_path)
            except OSError as e:
                log(self.tag, f"Error saving cache: {e}", level="error")

    def save(self) -> None:
        with self._lock:
            snapshot = list(self._data.items())
        self._save(snapshot)

    def load(self) -> int:
        if self.persist_path is None or not self.persist_path.exists():
            return 0
        try:
            payload = json.loads(self.persist_path.read_text(encoding="utf-8"))
        except (OSError, ValueError) as e:
            log(self.tag, f"Error loading cache: {e}", level="error")
            return 0
        if not isinstance(payload, list):
            return 0
        with self._lock:
            self._data.clear()
            loaded = 0
            for item in payload:
                if not isinstance(item, dict) or "key" not in item or "result" not in item:
                    continue
                self._data[item["key"]] = item["result"]
                loaded += 1
            # trim to capacity, evicting oldest (front)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
        return loaded
