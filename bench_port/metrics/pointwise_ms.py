"""pointwise_ms.<kind>: device ms a product spends in PyTorch's own kernels
(names under ``at::native``), from the trace.  The transforms at the
benchmark's shapes launch none of them, so in a product they are its
pointwise step; a product without any reads nothing."""


def read(run):
    tr = run.window.trace
    if tr is None or not tr.work.get("products"):
        return None
    s = tr.device_seconds(lambda name: "at::native" in name)
    return 1e3 * s / tr.work["products"] if s else None
