"""The least bytes of the traced transforms' root level, and the kernels
whose device time the lane roofline reads, for ``metrics/lane_roofline.py``.

The root level of a butterfly plan is the K6 lane launch: it must read a
transform's data once and write it once, 16 bytes a point
(``yardstick``'s ``transform_bytes``), as every level must.  Its
inter-step twiddle is not counted: a table read (16 bytes a point as a
pair, 8 companion-free) or a twiddle computed in flight are the kernel's
choices, and a count that took one in would read over 100% once a change
took the other.  The lane kernels are the instantiations of the port's
radix-2 register kernel (``csrc/ntt_radix2.cu``
``radix2_reg_kernel<INV, MM, LAZY, RMAX, SWZ, LANE>``) whose last template
argument ``LANE`` is true, named in the trace as
``void (anonymous namespace)::radix2_reg_kernel<false, 0, false, 4, true, true>(...)``.
"""

from __future__ import annotations

import re

from . import yardstick

#: A demangled radix-2 register-kernel name whose last template argument is true.
KERNEL = re.compile(r"radix2_reg_kernel<[^<>]*,\s*true\s*>")


def is_lane(name: str) -> bool:
    """Whether the device operation ``name`` is a lane instantiation."""
    return KERNEL.search(name) is not None


def root_seconds(n: int, transforms: int) -> float:
    """Least seconds of the root level of ``transforms`` transforms of n
    words."""
    return yardstick.least_seconds(yardstick.transform_bytes(n) * transforms)
