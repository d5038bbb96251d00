"""polymul_roofline: the least time of the traced products (three
transforms' 16 bytes a point and the pointwise step's 24, at the HBM
peak) over the device time of every operation in the traced part, in %."""

from bench_port import yardstick


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("products") or not tr.device_seconds():
        return None
    least = yardstick.least_seconds(yardstick.polymul_bytes(run.n) * tr.work["products"])
    return 100.0 * least / tr.device_seconds()
