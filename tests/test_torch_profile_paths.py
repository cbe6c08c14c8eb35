"""The trace arithmetic of profile_paths.py (device busy time, idle share,
kernel counts), on hand-made chrome traces; the profiling itself needs a
card."""

import pytest

import profile_paths as pp


def _ev(ts, dur, cat="kernel", name="k", ph="X"):
    return dict(ph=ph, cat=cat, name=name, ts=ts, dur=dur)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),              # a gap
    ([(0, 10), (5, 12), (12, 14)], 14.0),     # overlap, then touching
    ([(30, 40), (0, 50), (60, 61)], 51.0),    # nested, out of order
])
def test_busy_us_is_union_length(intervals, busy):
    assert pp.busy_us([(s, e, "k", "kernel") for s, e in intervals]) == busy


def test_summarize_counts_device_events_only():
    trace = {"traceEvents": [
        _ev(0, 4, name="gemm"), _ev(2, 4, name="sort"),  # overlap: busy 6
        _ev(10, 2, cat="gpu_memcpy", name="Memcpy HtoD"),
        _ev(20, 5, name="gemm"),
        _ev(0, 100, cat="cpu_op", name="aten::mm"),       # host: not counted
        _ev(0, 100, cat="cuda_runtime", name="cudaLaunchKernel"),
        dict(ph="i", cat="kernel", name="marker", ts=50),  # not a span
    ]}
    s = pp.summarize(trace, n_batches=2)
    assert s["device_ms_per_batch"] == pytest.approx(13 / 1e3 / 2)
    assert s["kernel_sum_ms_per_batch"] == pytest.approx(13 / 1e3 / 2)
    assert s["kernels_per_batch"] == 1.5
    assert s["span_ms"] == pytest.approx(25 / 1e3)
    assert s["idle_share"] == pytest.approx(1 - 13 / 25)
    assert s["top_kernels"][0] == ("gemm", pytest.approx(9 / 1e3 / 2))


def test_summarize_empty_trace():
    s = pp.summarize({"traceEvents": []}, n_batches=1)
    assert s["device_ms_per_batch"] == 0 and s["idle_share"] is None
