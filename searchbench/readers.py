"""Helpers that the metric readers under searchbench/metrics/ share.

A reader is a file searchbench/metrics/<metric>.py with read(run), which
returns the metric's value or None where the run holds nothing to read
(the harness then leaves the metric out). `run` is run.Run.
"""

from __future__ import annotations

import math

from . import roofline


def request_ms(run) -> list:
    """Each request of the window, from sending to its answer, in ms; a
    request that failed waits forever (inf)."""
    return [1e3 * (t1 - t0) if ok else math.inf
            for t0, t1, _n, ok in run.window.requests]


def host_ms(run, name: str):
    """Mean ms per call of the harness's span `name` in the window."""
    spans = run.spans_in(name)
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for _n, t0, t1, _a in spans) / len(spans)


def traced_launches(run):
    """The program's index launches (their query lists) that started
    inside the traced stretch."""
    if run.trace is None:
        return []
    h0, h1 = run.trace_host
    return [a for _n, _t0, _t1, a in
            run.spans_in("TorchIndex.search_batch_async", h0, h1)]


def kernel_share(run, kernel: str, bytes_of_launch):
    """A kernel's share of the HBM roofline over the traced stretch: the
    mean bytes that a launch's inputs need, times the kernel's launches in
    the trace, over their time; None where the trace holds none."""
    launches = traced_launches(run)
    if not launches:
        return None
    n, secs = roofline.kernel_time(run.trace, kernel)
    mean = sum(bytes_of_launch(q) for q in launches) / len(launches)
    return roofline.share(mean, n, secs)
