"""The port's LRU cache file: the reference's JSON array of {key, result},
with a rendered fragment written as the compact JSON it already is."""

from __future__ import annotations

import json
from collections import OrderedDict

import pytest

from nextsearch_tpu_torch.api.caches import LRUCache, Rendered

RESULTS = {
    "covid|10": {"query": "covid", "found": 2, "results": [
        {"cord_uid": "ab12", "score": 1.5, "title": "Café \"quoted\""}]},
    "flu|5": {"query": "flu", "found": 0, "results": []},
}


@pytest.fixture()
def lru():
    """LRUCache(...), with each write-behind cache's flush thread stopped
    after the test; it would otherwise wait out its flush_ms (1e9 here) for
    the rest of the process, and a join of every flush thread (the
    harness's stop_flushers) would wait for it."""
    made = []

    def make(*args, **kw):
        made.append(LRUCache(*args, **kw))
        return made[-1]

    yield make
    for cache in made:
        stop = getattr(cache, "_flush_stop", None)
        if stop is not None:
            stop.set()


def rendered(result: dict) -> Rendered:
    return Rendered(json.dumps(result, separators=(",", ":"),
                               ensure_ascii=False).encode())


@pytest.mark.parametrize("form", ["dict", "rendered", "mixed"])
def test_saved_file_holds_every_result_in_lru_order(tmp_path, form):
    path = tmp_path / "c.json"
    cache = LRUCache(10, path)
    for i, (key, result) in enumerate(RESULTS.items()):
        as_fragment = form == "rendered" or (form == "mixed" and i == 0)
        cache.put(key, rendered(result) if as_fragment else result)
    cache.get("covid|10")  # now the newest
    cache.save()
    payload = json.loads(path.read_text(encoding="utf-8"))
    assert payload == [{"key": k, "result": RESULTS[k]}
                       for k in ("flu|5", "covid|10")]
    fresh = LRUCache(10, path)
    assert fresh.load() == 2
    got = fresh.get("covid|10")
    assert got.pop("from_cache") is True
    assert got == RESULTS["covid|10"]


def test_empty_cache_saves_an_empty_array(tmp_path):
    path = tmp_path / "c.json"
    cache = LRUCache(10, path)
    cache.save()
    assert json.loads(path.read_text()) == []
    assert LRUCache(10, path).load() == 0


def test_saves_at_once_all_land(tmp_path):
    """The flush thread and save() write through one <path>.tmp: saves from
    several threads at once each replace the file whole."""
    import threading

    path = tmp_path / "c.json"
    cache = LRUCache(100, path)
    for i in range(50):
        cache.put(f"q{i}|10", rendered({"query": f"q{i}", "found": i}))
    errors = []

    def saver():
        for _ in range(20):
            try:
                cache.save()
            except Exception as e:  # noqa: BLE001 - any failure fails
                errors.append(e)

    threads = [threading.Thread(target=saver) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(json.loads(path.read_text())) == 50
    assert not path.with_suffix(".tmp").exists()


def _puts(n_keys=9):
    """Puts with new keys, updates of present keys and, at capacity 5,
    evictions, then a key evicted in the run and put again."""
    keys = [f"q{i % n_keys}|10" for i in (0, 1, 2, 3, 1, 4, 5, 6, 2, 7, 8, 0)]
    return [(key, rendered({"query": key, "n": i}) if i % 2 else
             {"query": key, "n": i}) for i, key in enumerate(keys)]


class Model:
    """The reference's LRU semantics, put by put: a present key moves to
    the newest end; a new one evicts the oldest at capacity and, written
    through, counts toward save_interval, the file then holding the cache
    as that put left it; written behind, it marks the cache dirty."""

    def __init__(self, capacity, save_interval, write_behind):
        self.data = OrderedDict()
        self.capacity, self.every = capacity, save_interval
        self.write_behind = write_behind
        self.since = self.evicted = 0
        self.dirty = False
        self.saved = None

    def put(self, key, result):
        if key in self.data:
            self.data.move_to_end(key)
            self.data[key] = result
            return
        if len(self.data) >= self.capacity:
            self.data.popitem(last=False)
            self.evicted += 1
        self.data[key] = result
        if self.write_behind:
            self.dirty = True
            return
        self.since += 1
        if self.since >= self.every:
            self.since = 0
            self.saved = list(self.data.items())


@pytest.mark.parametrize("flush_ms,save_interval", [(1e9, 1), (0.0, 1),
                                                    (0.0, 3)])
@pytest.mark.parametrize("prefill", [0, 2, 4])
def test_put_many_equals_puts_one_by_one(tmp_path, monkeypatch, lru,
                                         flush_ms, save_interval, prefill):
    """put_many and the same puts one by one leave the model's recency
    order, evictions, dirty flag, save counter and saved file, written
    behind (flush_ms; the flush thread never wakes here) and through every
    save_interval puts; put_many counts its evictions once, by their
    number."""
    from nextsearch_tpu_torch.api import caches

    counts = []
    monkeypatch.setattr(caches.GLOBAL_TRACER, "count",
                        lambda name, n=1: counts.append((name, n)))
    items = _puts()
    model = Model(5, save_interval, flush_ms > 0)
    for key, result in items[:prefill]:
        model.put(key, result)
    if prefill:
        model.data.move_to_end(items[0][0])  # the get below
    model.evicted = 0
    for key, result in items[prefill:]:
        model.put(key, result)
    want = dict(order=list(model.data.items()), dirty=model.dirty,
                since_save=model.since,
                file=None if model.saved is None else caches._dump(model.saved),
                evicted=model.evicted)
    assert want["evicted"] > 0
    for way in ("one_by_one", "many"):
        path = tmp_path / way / "c.json"
        path.parent.mkdir()
        cache = lru(5, path, save_interval, tag="t", flush_ms=flush_ms)
        for key, result in items[:prefill]:
            cache.put(key, result)
        if prefill:
            cache.get(items[0][0])
        del counts[:]
        if way == "many":
            cache.put_many(items[prefill:])
        else:
            for key, result in items[prefill:]:
                cache.put(key, result)
        evictions = [n for name, n in counts if name == "t.evictions"]
        got = dict(
            order=list(cache._data.items()), dirty=cache._dirty,
            since_save=cache._updates_since_save,
            file=path.read_bytes() if path.exists() else None,
            evicted=sum(evictions))
        assert got == want, way
        assert len(evictions) == (1 if way == "many" else want["evicted"])


def test_put_many_of_present_keys_only_refreshes_them(tmp_path, lru):
    """Updates of keys already held move them to the newest end, evict
    nothing and leave a write-behind cache clean, as put does."""
    cache = lru(3, tmp_path / "c.json", flush_ms=1e9)
    cache.put_many([("a|1", 1), ("b|1", 2), ("c|1", 3)])
    cache._dirty = False
    cache.put_many([("a|1", 10), ("b|1", 20)])
    assert list(cache._data.items()) == [("c|1", 3), ("a|1", 10), ("b|1", 20)]
    assert not cache._dirty
    cache.put_many([])
    assert len(cache) == 3
