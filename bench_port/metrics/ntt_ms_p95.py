"""ntt_ms_p95: the 95th percentile of every synchronous call in the window,
each timed on the host's clock from the call until the wait for its
output returned."""

from bench_port import yardstick


def read(run):
    lat = run.window.latency_ms
    return yardstick.percentile(lat, 95) if lat else None
