"""The reduction of a profiler trace: busy time as the union of device
intervals clipped to the traced stretch, kernels by name, and idle gaps
named by the host span around their middle."""

from __future__ import annotations

import pytest

from searchbench import devtrace, roofline


def trace(*events):
    return {"traceEvents": [dict(ph="X", **e) for e in events]}


def test_reduce_clips_and_names_gaps():
    tr = trace(
        dict(cat="user_annotation", name="searchbench.trace", ts=8, dur=20),
        dict(cat="kernel", name="k1", ts=5, dur=10),  # clipped to [8, 15)
        dict(cat="kernel", name="k2", ts=12, dur=2),  # inside k1
        dict(cat="gpu_memcpy", name="copy", ts=20, dur=5),
        dict(cat="cpu_op", name="aten::add", ts=15, dur=5),  # not device
        dict(cat="kernel", name="k1", ts=40, dur=5),  # after the stretch
    )
    t0, t1 = devtrace.annotation(tr, "searchbench.trace")
    r = devtrace.reduce(tr, t0, t1, [(14.0, 21.0, "planner")])
    assert (r["busy_s"], r["window_s"]) == (pytest.approx(12e-6), 20e-6)
    assert r["kernel_count"] == {"k1": 1, "k2": 1}
    assert r["kernel_s"]["k1"] == pytest.approx(7e-6)
    assert dict(r["idle_gaps"]) == {"planner": pytest.approx(5e-6),
                                    "waiting": pytest.approx(3e-6)}


def test_kernel_share():
    red = {"kernel_count": {"void score_epilogue_kernel<float, true>(x)": 4,
                            "other": 9},
           "kernel_s": {"void score_epilogue_kernel<float, true>(x)": 1e-3,
                        "other": 1.0}}
    n, s = roofline.kernel_time(red, "score_epilogue")
    assert (n, s) == (4, 1e-3)
    share = roofline.share(roofline.epilogue_bytes(256, 1000), n, s)
    assert share == pytest.approx(100 * 4 * 12 * 256 * 1000 / 1e-3 / 3.35e12)
    assert roofline.share(1.0, 0, 0.0) is None
