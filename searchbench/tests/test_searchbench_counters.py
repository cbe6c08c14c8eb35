"""The readers of the program's counters: the guard's trip and relaunch
shares read the tracer's counters and span counts, 0 where the program
counted sparse launches but no trip, and nothing where it counts none (a
program without these counters, as before they existed)."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import ROOT
from nextsearch_tpu_torch.utils import profiling
from searchbench import counters


def reader(name):
    path = ROOT / "searchbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture()
def tracer(monkeypatch):
    fresh = profiling.Tracer()
    monkeypatch.setattr(profiling, "GLOBAL_TRACER", fresh)
    return fresh


def launches(tracer, n):
    for _ in range(n):
        with tracer.span("index.launch"):
            pass


def test_no_counters_read_nothing(tracer):
    launches(tracer, 3)  # a program that counts no sparse launch
    assert counters.counters() == {}
    assert counters.span_count("index.launch") == 3
    assert reader("index.trip_share.closed")(None) is None
    assert reader("index.relaunch_share.closed")(None) is None


def test_launches_without_trips_read_zero(tracer):
    launches(tracer, 4)
    tracer.count("index.queries_launched", 1000)
    assert reader("index.trip_share.closed")(None) == 0.0
    assert reader("index.relaunch_share.closed")(None) == 0.0


def test_shares(tracer):
    launches(tracer, 8)
    tracer.count("index.queries_launched", 2000)
    tracer.count("index.guard_trips", 5)
    tracer.count("index.relaunches", 2)
    assert reader("index.trip_share.closed")(None) == pytest.approx(0.25)
    assert reader("index.relaunch_share.closed")(None) == pytest.approx(25.0)
