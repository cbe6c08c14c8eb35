"""setup_s: from process start to the first request of the window: imports,
the corpus drawn on the card, Engine.reload, Engine.warmup (pins and graph
captures) and the traffic's warm stretch."""


def read(run):
    return run.setup_s
