"""setup.warmup_s: seconds of Engine.warmup (pins and graph captures)."""


def read(run):
    return run.warmup_s
