"""launch_host_ms.<kind>: host ms a call into the program spends in its
kernels' launch spans (argument building, geometry, the C call), from the
trace.  Nothing where the program records no spans."""

from bench_port import spans


def read(run):
    tr = run.window.trace
    calls = spans.calls(tr) if tr else []
    if not calls:
        return None
    return 1e3 * spans.launch_host_seconds(tr, calls) / len(calls)
