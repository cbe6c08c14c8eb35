"""index.trip_share.closed: the percentage of the queries sent to a sparse
launch whose fast guard tripped (the program's counters index.guard_trips
over index.queries_launched, over the whole run, warm-up included); None
where the program keeps no such counters."""

from searchbench.counters import counters


def read(run):
    c = counters()
    n = c.get("index.queries_launched", 0)
    if n <= 0:
        return None
    return 100.0 * c.get("index.guard_trips", 0) / n
