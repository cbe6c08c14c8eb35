"""The program's own counters and span counts, for the metric readers.

The program's tracer (nextsearch_tpu_torch.utils.profiling.GLOBAL_TRACER)
keeps integer counters and each span's count at all times, from the
process's start: a run's readings cover its warm-up, its window and its
traced stretch. A program that keeps no such counter gives nothing to read.
"""

from __future__ import annotations


def _report() -> dict:
    from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER

    report = getattr(GLOBAL_TRACER, "report", None)
    return report() if report is not None else {}


def counters() -> dict:
    """{counter name: count} of the program's tracer ({} where none)."""
    return dict(_report().get("counters", {}))


def span_count(name: str) -> int:
    """How many times the program's span `name` ran (0 where never)."""
    return int(_report().get("spans", {}).get(name, {}).get("count", 0))
