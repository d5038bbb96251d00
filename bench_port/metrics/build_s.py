"""build_s: seconds of the NTT's construction (plan and tables) in set-up."""


def read(run):
    return run.build_s
