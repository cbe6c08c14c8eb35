"""The reference's concurrency property tests (tests/test_concurrency.py)
that assert no latency bound, run on the torch port's Engine on the CPU:
concurrent searches, suggests and reloads stay consistent, parallel cache
writes all land, and NEXTSEARCH_RELOAD_IN_PLACE=1 reloads and serves.
The two timed cases stay with the reference (ROADMAP "Watch")."""

import threading
import time

import pytest
import torch

from nextsearch_tpu_torch.engine import Engine
from nextsearch_tpu_torch.index.builder import build_segment_arrays
from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment

torch.set_num_threads(1)


@pytest.fixture()
def engine(tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": f"u{i}", "text": f"covid vaccine term{i % 7} study"}
        for i in range(30)
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text(
        "cord_uid,title\n" + "".join(f"u{i},T{i}\n" for i in range(30))
    )
    e = Engine(d, cache_dir=tmp_path, device="cpu")
    assert e.reload()
    return e


def test_concurrent_search_suggest_reload(engine):
    errors = []
    stop = threading.Event()

    def searcher(seed):
        i = 0
        while not stop.is_set():
            try:
                j = engine.search(f"covid term{(seed + i) % 7}", 10)
                assert j["query"].startswith("covid")
                if "found" in j:
                    assert j["found"] >= 0
                i += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def suggester():
        while not stop.is_set():
            try:
                s = engine.suggest("te", 5)
                assert isinstance(s["suggestions"], list)
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def reloader():
        for _ in range(3):
            try:
                assert engine.reload()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = (
        [threading.Thread(target=searcher, args=(s,)) for s in range(4)]
        + [threading.Thread(target=suggester) for _ in range(2)]
        + [threading.Thread(target=reloader)]
    )
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    # engine still consistent after the storm
    assert engine.search("covid", 10)["found"] == 30


def test_concurrent_cache_writes(engine):
    """Parallel distinct queries: every cache entry lands intact."""
    qs = [f"term{i % 7} covid" for i in range(14)]
    threads = [
        threading.Thread(target=lambda q=q: engine.search(q, 10)) for q in qs
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for q in set(qs):
        j = engine.search(q, 10)
        assert j.get("from_cache") is True


def test_reload_in_place_mode(engine, monkeypatch):
    """NEXTSEARCH_RELOAD_IN_PLACE=1 (cards where two device indexes cannot
    coexist) drops the old index before the build; reload still succeeds
    and serves afterwards."""
    monkeypatch.setenv("NEXTSEARCH_RELOAD_IN_PLACE", "1")
    assert engine.reload()
    res = engine.search("covid", 5)
    assert res["found"] > 0
