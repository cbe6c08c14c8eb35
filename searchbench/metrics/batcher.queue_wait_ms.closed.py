"""batcher.queue_wait_ms.closed: mean ms a unit of the
closed loop waits in the SearchBatcher's queue, from its submit to the
launch that takes it (the program's span search-batcher.queue, over the
traced stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "search-batcher.queue")
