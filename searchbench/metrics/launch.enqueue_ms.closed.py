"""launch.enqueue_ms.closed: mean host ms of a batch's
enqueue in TorchIndex: plan uploads, the graph's replay or the eager
launch, the copy-out (the program's span index.enqueue, over the traced
stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "index.enqueue")
