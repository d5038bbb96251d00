"""pointwise_launches.<kind>: kernel launches inside a product's pointwise
step (its span ``sventt.convolve.pointwise``), per step, from the trace.
Nothing where the program records no spans."""

from bench_port import spans


def read(run):
    tr = run.window.trace
    steps = spans.pointwise(tr) if tr else []
    if not steps:
        return None
    return spans.launches_in(tr, steps) / len(steps)
