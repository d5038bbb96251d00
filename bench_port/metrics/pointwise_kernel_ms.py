"""pointwise_kernel_ms.<kind>: device ms a product spends in the program's
pointwise kernel (names holding ``pointwise_mont_mul_kernel``), from the
trace.  Nothing where no such kernel ran: a program whose pointwise step
is PyTorch's own kernels (``pointwise_ms``)."""

KERNEL = "pointwise_mont_mul_kernel"


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("products"):
        return None
    s = tr.device_seconds(lambda name: KERNEL in name)
    return 1e3 * s / tr.work["products"] if s else None
