"""device_idle.<kind>: share of the traced part of the window in which no
operation ran on the device, in %."""


def read(run):
    tr = run.window.trace
    return tr.idle_percent() if tr else None
