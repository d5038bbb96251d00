"""plan_host_ms.<kind>: host ms of a call into the program (the span of
``NTT``'s forward or inverse, or of a product) less its kernels' launch
spans: the API's checks and the planner's walk, per call, from the trace.
Nothing where the program records no spans."""

from bench_port import spans


def read(run):
    tr = run.window.trace
    calls = spans.calls(tr) if tr else []
    if not calls:
        return None
    host = sum(e - s for s, e in calls) - spans.launch_host_seconds(tr, calls)
    return 1e3 * host / len(calls)
