"""enqueue_ms.<kind>: mean host ms of a call into the program until it
returns (before any wait for its output), outside the traced part."""


def read(run):
    s = run.window.host_call_s
    return 1e3 * sum(s) / len(s) if s else None
