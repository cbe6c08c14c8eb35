"""setup.index_build_s: seconds of TorchIndex's build, the sum of its
build_phases."""


def read(run):
    return sum(run.build_phases.values()) if run.build_phases else None
