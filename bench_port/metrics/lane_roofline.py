"""lane_roofline.<kind>: the least time of the traced transforms' root
level (16 bytes a point at the HBM peak; ``lane_bytes``) over the device
time of the radix-2 register kernel's lane instantiations (K6, ``LANE``
true), in %.  Nothing where no such kernel ran or the window counts no
transforms."""

from bench_port import lane_bytes


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("transforms"):
        return None
    s = tr.device_seconds(lane_bytes.is_lane)
    if not s:
        return None
    return 100.0 * lane_bytes.root_seconds(run.n, tr.work["transforms"]) / s
