"""ntt_roofline.<kind>: the least time of the traced transforms (16 bytes
a point at the HBM peak) over the device time of every operation in the
traced part, in %."""

from bench_port import yardstick


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("transforms") or not tr.device_seconds():
        return None
    least = yardstick.least_seconds(yardstick.transform_bytes(run.n) * tr.work["transforms"])
    return 100.0 * least / tr.device_seconds()
