"""index.relaunch_share.closed: the percentage of the index's launches that
were relaunched exactly after a guard trip (the program's counter
index.relaunches over the count of its span index.launch, over the whole
run, warm-up included); None where the program counts no sparse launch
(index.queries_launched)."""

from searchbench.counters import counters, span_count


def read(run):
    c = counters()
    n = span_count("index.launch")
    if c.get("index.queries_launched", 0) <= 0 or n <= 0:
        return None
    return 100.0 * c.get("index.relaunches", 0) / n
