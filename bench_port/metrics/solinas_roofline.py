"""solinas_roofline.<kind>: the least time of the traced transforms (16
bytes a point at the HBM peak; ``solinas_bytes``) over the device time of
the radix-2 register kernel's Solinas instantiations (``MM`` = 2), in %.
Nothing where no such kernel ran or the window counts no transforms."""

from bench_port import solinas_bytes


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("transforms"):
        return None
    s = tr.device_seconds(solinas_bytes.is_solinas)
    if not s:
        return None
    return 100.0 * solinas_bytes.transform_seconds(run.n, tr.work["transforms"]) / s
