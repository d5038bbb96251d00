"""setup_s: seconds from the run's start to the window's, the kernels'
build, the NTT's tables, the inputs and the warm-up included."""


def read(run):
    return run.setup_s
