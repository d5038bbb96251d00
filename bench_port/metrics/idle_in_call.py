"""idle_in_call.<kind>: share of the traced part in which no operation ran
on the device while the host was inside a call into the program, in %.
Nothing where the program records no spans."""

from bench_port import spans, yardstick


def read(run):
    tr = run.window.trace
    calls = spans.calls(tr) if tr else []
    if not calls:
        return None
    idle = yardstick.idle_gaps([(s, s + d) for _, s, d in tr.ops], tr.lo, tr.hi)
    return 100.0 * spans.overlap_seconds(idle, calls) / tr.window_s
