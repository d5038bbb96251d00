"""polymul_per_s: cyclic products completed over the whole window,
divided by the window."""


def read(run):
    p = run.window.work.get("products")
    return p / run.window.seconds if p else None
