"""The program's own spans over the traced stretch, for the metric readers.

The program's tracer (nextsearch_tpu_torch.utils.profiling.GLOBAL_TRACER)
records its spans while a torch.profiler session is active, so the traced
stretch of a --trace 1 run (run.traced_stretch) leaves them in its ring.
Their time.perf_counter_ns() stamps are on the clock of run.trace_host
(time.perf_counter). A run without a traced stretch, or a program whose
tracer keeps no records, gives nothing to read.
"""

from __future__ import annotations


def records(run, name: str) -> list:
    """The program's records called `name` that start inside the traced
    stretch; [] where there are none to read."""
    if run.trace_host is None:
        return []
    from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER

    read = getattr(GLOBAL_TRACER, "records", None)
    if read is None:
        return []
    h0, h1 = run.trace_host
    t0, t1 = int(h0 * 1e9), int(h1 * 1e9)
    return [r for r in read(t0, t1)
            if r.name == name and t0 <= r.t0_ns <= t1]


def mean_ms(run, name: str):
    """Mean ms of the program's span `name` over the traced stretch, or
    None where there is none."""
    recs = records(run, name)
    if not recs:
        return None
    return sum(r.t1_ns - r.t0_ns for r in recs) / len(recs) / 1e6
