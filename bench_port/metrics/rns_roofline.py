"""rns_roofline.<kind>: the least time of the traced multi-modular products
(every limb's three transforms at 16 bytes a point and pointwise step at
24, at the HBM peak; ``rns_bytes``) over the device time of every operation
in the traced part, in %.  Nothing where the window counts no limb
products."""

from bench_port import rns_bytes


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("limb_products") or not tr.device_seconds():
        return None
    least = rns_bytes.product_seconds(run.n, tr.work["limb_products"])
    return 100.0 * least / tr.device_seconds()
