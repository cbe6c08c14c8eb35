"""The readers of the program's own spans (searchbench/spans.py and the
metrics that read it) on fabricated tracer records: each gives the mean of
its span over the traced stretch, and None outside it, without a traced
stretch, or with nothing recorded. The program's spans enter the profiler's
Chrome trace as user annotations (and their device side as
gpu_user_annotation), which leave the trace's busy and idle time as they
were."""

from __future__ import annotations

import pytest

from conftest import ROOT
from searchbench import devtrace
from searchbench.run import Run, reader

from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER

READERS = {
    "batcher.queue_wait_ms.closed": "search-batcher.queue",
    "engine.prepare_ms.closed": "engine.prepare",
    "engine.render_ms.closed": "engine.render",
    "plan.host_ms.closed": "index.plan",
    "launch.enqueue_ms.closed": "index.enqueue",
    "gather.wait_ms.closed": "index.wait",
    "device.gap_ms.closed": "device.idle",
}
H0, H1 = 1000.0, 1002.0  # the traced stretch, perf_counter seconds
MS = 1_000_000


@pytest.fixture
def tracer():
    GLOBAL_TRACER.reset()
    GLOBAL_TRACER.start()
    try:
        yield GLOBAL_TRACER
    finally:
        GLOBAL_TRACER.stop()
        GLOBAL_TRACER.reset()


def _run(stretch=(H0, H1)):
    run = Run()
    run.trace_host = stretch
    return run


@pytest.mark.parametrize("metric,span", sorted(READERS.items()))
def test_reader_means_its_span_over_the_stretch(tracer, metric, span):
    t0 = int(H0 * 1e9)
    tracer.add(span, t0 - 5 * MS, t0 + 90 * MS, batch=1)  # starts before
    tracer.add(span, t0 + 100 * MS, t0 + 102 * MS, batch=2)
    tracer.add(span, t0 + 500 * MS, t0 + 506 * MS, batch=3)
    tracer.add("other.span", t0 + 600 * MS, t0 + 900 * MS, batch=3)
    tracer.add(span, int(H1 * 1e9) + MS, int(H1 * 1e9) + 9 * MS, batch=4)
    read = reader(metric, ROOT)
    assert read(_run()) == pytest.approx(4.0)
    assert read(_run((H0 + 10, H1 + 10))) is None
    assert read(_run(None)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_when_nothing_was_recorded(metric):
    GLOBAL_TRACER.reset()
    with GLOBAL_TRACER.span(READERS[metric]):  # not recording: totals only
        pass
    assert reader(metric, ROOT)(_run((0.0, 1e12))) is None
    GLOBAL_TRACER.reset()


def test_span_annotations_leave_busy_and_idle_unchanged():
    events = [
        dict(cat="user_annotation", name="searchbench.trace", ts=0, dur=100),
        dict(cat="kernel", name="k1", ts=10, dur=20),
        dict(cat="gpu_memcpy", name="copy", ts=50, dur=5),
        dict(cat="kernel", name="k2", ts=70, dur=10),
    ]
    spans = [
        dict(cat="user_annotation", name="engine.launch", ts=0, dur=40),
        dict(cat="user_annotation", name="index.plan", ts=2, dur=30),
        dict(cat="user_annotation", name="index.enqueue", ts=33, dur=6),
        dict(cat="gpu_user_annotation", name="index.enqueue", ts=10,
             dur=80),
        dict(cat="gpu_user_annotation", name="engine.launch", ts=5,
             dur=95),
    ]
    host = [(0.0, 40.0, "planner")]

    def reduced(evs):
        trace = {"traceEvents": [dict(ph="X", **e) for e in evs]}
        t0, t1 = devtrace.annotation(trace, "searchbench.trace")
        return devtrace.reduce(trace, t0, t1, host)

    plain, annotated = reduced(events), reduced(events + spans)
    assert annotated["busy_s"] == plain["busy_s"] == pytest.approx(35e-6)
    assert annotated["window_s"] == plain["window_s"]
    assert annotated["idle_gaps"] == plain["idle_gaps"]
    assert annotated["kernel_s"] == plain["kernel_s"]
    assert not {"user_annotation", "gpu_user_annotation"} & set(
        devtrace.DEVICE_CATS)
