"""BENCHMARK.json and every file it names: present, parsed, and named and
measured in the characters and units the benchmark's contract allows."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["searchbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"])
    for key in ("n_docs", "mean_tokens", "vocab", "zipf_s",
                "query_terms", "k", "mode", "env", "assumed"):
        assert key in cfg, key
    assert cfg["mode"] in ("fused", "exact", "fast", "sparse")
    assert all(k.startswith("NEXTSEARCH_") for k in cfg["env"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key]), cell[key]
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = json.loads((ROOT / "searchbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    assert mix["loop"] == "closed"
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in
               BENCH["per_layer"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    path = ROOT / "searchbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        if metric["name"].endswith("roofline"):
            assert metric["unit"] == "%"
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
