"""The least bytes of the traced transforms, and the kernels whose device
time the Solinas roofline reads, for ``metrics/solinas_roofline.py``.

A transform must read its input once and write its output once, 16 bytes
a point (``yardstick``'s ``transform_bytes``), whatever multiply computes
it.  The Solinas kernels are the instantiations of the port's radix-2
register kernel (K4 leaf, K5 mid, K6 lane; ``csrc/ntt_radix2.cu``
``radix2_reg_kernel<INV, MM, LAZY, RMAX, SWZ, LANE>``) whose stage
multiply ``MM``, the second template argument, is 2 (0 Montgomery, 1
Shoup), named in the trace as
``void (anonymous namespace)::radix2_reg_kernel<false, 2, false, 4, true, false>(...)``.
"""

from __future__ import annotations

import re

from . import yardstick

#: A demangled radix-2 register-kernel name whose second template argument is 2.
KERNEL = re.compile(r"radix2_reg_kernel<\s*\w+\s*,\s*2\s*,")


def is_solinas(name: str) -> bool:
    """Whether the device operation ``name`` is a Solinas instantiation."""
    return KERNEL.search(name) is not None


def transform_seconds(n: int, transforms: int) -> float:
    """Least seconds of ``transforms`` transforms of n words."""
    return yardstick.least_seconds(yardstick.transform_bytes(n) * transforms)
