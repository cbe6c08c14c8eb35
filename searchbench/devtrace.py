"""Device trace of a steady stretch of the window, and its reduction.

device_events is a frozen copy of nextsearch_tpu_torch/benchmarks/common.py's
(commit df737fb): the device events of a torch.profiler Chrome trace
(kernels, copies, memsets); busy time is, as there, the length of the
union of their intervals. The harness's host spans enter the
trace as user annotations (torch.profiler.record_function), on the same
clock; one of them, around the traced stretch, ties the host clock of the
harness's other spans to the trace's, so each idle gap of the device is
named by what the dispatcher thread was doing at its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from pathlib import Path

# trace event categories that are device time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace: dict) -> list:
    """(start_us, end_us, name, cat) of the trace's device events."""
    return [
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""),
         e["cat"])
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    ]


def merged(events) -> list:
    """The union of the events' intervals as sorted disjoint [s, e)."""
    out: list = []
    for s, e, *_ in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events) -> float:
    """Length of the union of the events' [start, end) intervals."""
    return sum(e - s for s, e in merged(events))


def annotation(trace: dict, name: str):
    """(start_us, end_us) of the first user annotation called `name`."""
    for e in trace.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == name):
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
    raise ValueError(f"the trace holds no annotation {name!r}")


def host_activity(spans: list, starts: list, t: float) -> str:
    """The innermost of the sorted `spans` (whose starts are `starts`)
    around time t, or "waiting" outside them all."""
    best = None
    i = bisect_right(starts, t)
    for s, e, name in reversed(spans[max(0, i - 64):i]):
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best[2] if best else "waiting"


def reduce(trace: dict, t0_us: float, t1_us: float, spans: list,
           top: int = 10) -> dict:
    """busy and idle of [t0_us, t1_us]: device events clipped to it, the
    kernels' total seconds by name, and the idle seconds by host activity:
    `spans` are the dispatcher thread's (start_us, end_us, name), sorted,
    on the trace's clock."""
    ev = [(max(s, t0_us), min(e, t1_us), n, c)
          for s, e, n, c in device_events(trace) if e > t0_us and s < t1_us]
    busy = busy_us(ev)
    by_kernel: dict = {}
    count: dict = {}
    for s, e, name, cat in ev:
        if cat == "kernel":
            by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
            count[name] = count.get(name, 0) + 1
    idle: dict = {}
    starts = [s for s, _e, _n in spans]
    prev = t0_us
    for s, e in merged(ev) + [[t1_us, t1_us]]:
        if s > prev:
            name = host_activity(spans, starts, (prev + s) / 2)
            idle[name] = idle.get(name, 0.0) + (s - prev)
        prev = max(prev, e)
    return dict(
        busy_s=busy / 1e6,
        window_s=(t1_us - t0_us) / 1e6,
        kernel_s={n: t / 1e6 for n, t in by_kernel.items()},
        kernel_count=count,
        device_ops=[[n[:120], t / 1e6] for n, t in
                    sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, t / 1e6] for n, t in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    )


def load(prof) -> dict:
    """The profiler's Chrome trace as a dict, through a file under TMPDIR
    that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return json.loads(Path(path).read_text())
    finally:
        os.unlink(path)
