"""NEXTSEARCH_PROFILE_DIR in the torch port: utils/profiling.device_trace (a
torch.profiler Chrome trace under <dir>/<tag>/, a no-op without the
variable, a skipped inner trace when two overlap) and the port's Engine,
which traces its device gathers under search/ as the JAX Engine does at
nextsearch_tpu/engine.py's two search.device sites. Traces are read with
profile_paths.py's reader."""

import json
import threading

import torch

import profile_paths as pp
from nextsearch_tpu_torch.engine import Engine as TorchEngine
from nextsearch_tpu_torch.utils.profiling import device_trace

from test_torch_engine import PORT_CFG, QUERIES, index_dir  # noqa: F401

torch.set_num_threads(1)


def _traces(d):
    return sorted(d.glob("*.json"))


def _work():
    x = torch.arange(4096, dtype=torch.float32)
    return float(torch.sort(x * 2.0).values.sum())


def test_device_trace_is_a_noop_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("NEXTSEARCH_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace("search"):
        assert _work() > 0
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("NEXTSEARCH_PROFILE_DIR", str(tmp_path))
    with device_trace("probe"):
        assert _work() > 0
    (path,) = _traces(tmp_path / "probe")
    trace = json.loads(path.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::sort") for n in names)
    assert pp.device_events(trace) == []  # no card: CPU events only


def test_overlapping_traces_skip_the_inner_one(tmp_path, monkeypatch):
    """A trace asked for while another is open runs its body untraced and
    never fails it; the next trace after both runs again."""
    monkeypatch.setenv("NEXTSEARCH_PROFILE_DIR", str(tmp_path))
    done = []
    with device_trace("outer"):
        t = threading.Thread(target=lambda: done.append(
            _traced_body("inner")))
        t.start()
        t.join()
    assert done == [True]
    assert len(_traces(tmp_path / "outer")) == 1
    assert not (tmp_path / "inner").exists()
    with device_trace("inner"):
        _work()
    assert len(_traces(tmp_path / "inner")) == 1


def _traced_body(tag):
    with device_trace(tag):
        return _work() > 0


def test_engine_traces_its_searches(index_dir, tmp_path,  # noqa: F811
                                    monkeypatch):
    """An Engine on the CPU with the variable set answers as without it and
    leaves traces under search/: one per device launch and one per its
    gather."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    plain = TorchEngine(index_dir, PORT_CFG, cache_dir=tmp_path / "a",
                        device="cpu")
    assert plain.reload()
    want = [plain.search(q, 5) for q in QUERIES]
    prof = tmp_path / "prof"
    monkeypatch.setenv("NEXTSEARCH_PROFILE_DIR", str(prof))
    traced = TorchEngine(index_dir, PORT_CFG, cache_dir=tmp_path / "b",
                         device="cpu")
    assert traced.reload()
    got = [traced.search(q, 5) for q in QUERIES]
    assert [g["results"] for g in got] == [w["results"] for w in want]
    assert [g["found"] for g in got] == [w["found"] for w in want]
    assert any(w["results"] for w in want)
    files = _traces(prof / "search")
    assert len(files) % 2 == 0 and 2 <= len(files) <= 2 * len(QUERIES)
    for path in files:
        assert json.loads(path.read_text())["traceEvents"]
