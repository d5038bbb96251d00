"""ntt_per_s: transforms completed over the whole window, divided by the
window."""


def read(run):
    t = run.window.work.get("transforms")
    return t / run.window.seconds if t else None
