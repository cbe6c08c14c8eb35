"""gather.wait_ms.closed: mean ms the dispatcher waits at a
batch's gather for the card to finish it (the program's span index.wait:
the copy-out event's sync, over the traced stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "index.wait")
