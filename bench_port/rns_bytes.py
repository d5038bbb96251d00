"""The least bytes of a multi-modular product, and the kernels whose device
time the RNS roofline shares read, for ``metrics/rns_*roofline.py``.

A limb product is one cyclic product of n words over one limb's modulus:
two forwards and one inverse of 16 bytes a point (``yardstick``'s
``transform_bytes``) and the pointwise step's 24 (``pointwise_bytes``).
A traced window's ``work["limb_products"]`` counts them (``ops/
rns_polymul.py``: the limbs of every completed product).  Each function
returns the least seconds at the HBM peak (``yardstick.least_seconds``).
"""

from __future__ import annotations

from . import yardstick

#: The port's matrix NTT kernel (csrc/mxu_tc.cuh), every level of a
#: transform, and its pointwise product kernel (csrc/pointwise.cu).
TRANSFORM_KERNEL = "mxu_tc_kernel"
POINTWISE_KERNEL = "pointwise_mont_mul_kernel"


def product_seconds(n: int, limb_products: int) -> float:
    """Least seconds of ``limb_products`` whole limb products."""
    return yardstick.least_seconds(yardstick.polymul_bytes(n) * limb_products)


def transform_seconds(n: int, limb_products: int) -> float:
    """Least seconds of their three transforms."""
    return yardstick.least_seconds(3 * yardstick.transform_bytes(n) * limb_products)


def pointwise_seconds(n: int, limb_products: int) -> float:
    """Least seconds of their pointwise steps."""
    return yardstick.least_seconds(yardstick.pointwise_bytes(n) * limb_products)
