"""The port's LRU cache file: the reference's JSON array of {key, result},
with a rendered fragment written as the compact JSON it already is."""

from __future__ import annotations

import json

import pytest

from nextsearch_tpu_torch.api.caches import LRUCache, Rendered

RESULTS = {
    "covid|10": {"query": "covid", "found": 2, "results": [
        {"cord_uid": "ab12", "score": 1.5, "title": "Café \"quoted\""}]},
    "flu|5": {"query": "flu", "found": 0, "results": []},
}


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
