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
    assert s["kernels_by_name"] == {"gemm": 2, "sort": 1}
    assert (s["copies_per_batch"], s["memsets_per_batch"]) == (0.5, 0.0)
    assert s["batches"] == 2


def test_kernel_mix_diff_names_what_differs():
    eager = {"kernels_by_name": {"gemm": 20, "sort": 10}}
    assert pp.kernel_mix_diff(eager, eager) == {}
    graphed = {"kernels_by_name": {"gemm": 20, "sort": 9, "fill": 3}}
    assert pp.kernel_mix_diff(eager, graphed) == {"sort": -1, "fill": 3}


def _mix(kernels, copies=15.0, memsets=20.0):
    return {"kernels_by_name": kernels, "copies_per_batch": copies,
            "memsets_per_batch": memsets, "batches": 10}


@pytest.mark.parametrize("graphed,added,bad", [
    (_mix({"gemm": 400, "sort": 100}), 0.0, {}),
    (_mix({"gemm": 398, "sort": 101}), 0.0, {}),               # trace noise
    (_mix({"gemm": 400, "sort": 100, "fill": 2}), 0.0, {}),
    (_mix({"gemm": 400, "sort": 100, "fill": 3}), 0.0, {"fill": 3}),
    (_mix({"gemm": 390, "sort": 100}), 0.0, {"gemm": -10, "total": -10}),
    (_mix({"gemm": 400, "sort": 100, "a": 2, "b": 2, "c": 2}), 0.0,
     {"total": 6}),                                            # > 1% of 500
    (_mix({"gemm": 400, "sort": 100, **{f"k{i}": 1 for i in range(31)}}),
     0.0, {"total": 31}),
    # CUDA ran 18 memsets and 13 copies a batch as node kernels, and
    # the replays copied a plan in and a result out
    (_mix({"gemm": 400, "sort": 100, "memset32": 180, "memcpy128": 50,
           "memcpy32_post": 80}, copies=3.9, memsets=2.0), 2.0, {}),
    (_mix({"gemm": 400, "sort": 100}, copies=17.0), 2.0, {}),
    (_mix({"gemm": 400, "sort": 100}, copies=19.0), 2.0,
     {"memory operations a batch": 4.0}),
    (_mix({"gemm": 400, "sort": 100, "memset32": 20}), 0.0,
     {"memory operations a batch": 2.0}),
])
def test_kernel_mix_mismatch_passes_noise_only(graphed, added, bad):
    eager = _mix({"gemm": 400, "sort": 100})
    assert pp.kernel_mix_mismatch(eager, graphed, added) == bad


def test_split_node_kernels():
    kern, mem = pp.split_node_kernels(_mix(
        {"gemm": 4, "memset32": 10, "memcpy128": 5, "memcpy32_post": 5,
         "memsetFoo": 1}, copies=1.0, memsets=2.0))
    assert kern == {"gemm": 4, "memsetFoo": 1} and mem == 5.0
