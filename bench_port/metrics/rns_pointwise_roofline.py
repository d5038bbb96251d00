"""rns_pointwise_roofline.<kind>: the least time of the traced
multi-modular products' pointwise steps (24 bytes a point a limb, at the
HBM peak; ``rns_bytes``) over the device time of the port's pointwise
kernel (names holding ``rns_bytes.POINTWISE_KERNEL``), in %.  Nothing where
no such kernel ran or the window counts no limb products."""

from bench_port import rns_bytes


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("limb_products"):
        return None
    s = tr.device_seconds(lambda name: rns_bytes.POINTWISE_KERNEL in name)
    if not s:
        return None
    return 100.0 * rns_bytes.pointwise_seconds(run.n, tr.work["limb_products"]) / s
