"""launches.<kind>: kernel launches (``cudaLaunchKernel`` and the other
launch calls of ``spans.LAUNCH_EVENTS``) that start inside a call into the
program, per call, from the trace.  Nothing where the program records no spans."""

from bench_port import spans


def read(run):
    tr = run.window.trace
    calls = spans.calls(tr) if tr else []
    if not calls:
        return None
    return spans.launches_in(tr, calls) / len(calls)
