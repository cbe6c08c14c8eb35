"""device.gap_ms.closed: mean ms the card's stream stood
empty before a launch (the program's span device.idle: the gap from the
previous launch's end event to this one's start event, over the traced
stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "device.idle")
