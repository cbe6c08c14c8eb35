"""device.busy_ms.closed: device ms a batch: the union of kernel, copy and
memset intervals in the traced stretch over the index launches that
started in it."""

from searchbench.readers import traced_launches


def read(run):
    n = len(traced_launches(run))
    return 1e3 * run.trace["busy_s"] / n if n else None
