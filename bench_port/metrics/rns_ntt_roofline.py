"""rns_ntt_roofline.<kind>: the least time of the traced multi-modular
products' transforms (three a limb product, 16 bytes a point, at the HBM
peak; ``rns_bytes``) over the device time of the port's matrix NTT kernel
(names holding ``rns_bytes.TRANSFORM_KERNEL``), in %.  Nothing where no
such kernel ran or the window counts no limb products."""

from bench_port import rns_bytes


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("limb_products"):
        return None
    s = tr.device_seconds(lambda name: rns_bytes.TRANSFORM_KERNEL in name)
    if not s:
        return None
    return 100.0 * rns_bytes.transform_seconds(run.n, tr.work["limb_products"]) / s
