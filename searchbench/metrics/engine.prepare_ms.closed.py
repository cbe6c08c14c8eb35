"""engine.prepare_ms.closed: mean ms a batch spends in the
Engine before the index's launch: cache probes, tokenizer, expansion (the
program's span engine.prepare, over the traced stretch)."""

from searchbench.spans import mean_ms


def read(run):
    return mean_ms(run, "engine.prepare")
