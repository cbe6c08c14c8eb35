"""engine.render_ms.closed: mean ms a batch spends in the
Engine's render and cache fill, metadata fetch included (the program's
span engine.render, over the traced stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "engine.render")
