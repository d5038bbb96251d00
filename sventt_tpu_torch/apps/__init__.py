"""Applications: NTT convolution pipelines and the magic-series counters.

The counterpart of ``sventt_tpu/apps/``: the q-series generators and the
chunked power-series division behind the magic-series count (``series``),
and the NTT-free Kinnaes closed form (``kinnaes``), an independent
cross-check of the same counts.  Each runs on the CUDA card unless given
``device="cpu"``.
"""

from .convolve import cyclic_convolve, make_convolver, poly_multiply
from .kinnaes import kinnaes_magic_series_count, kinnaes_parameters
from .series import (
    gaussian_binomial_coefficient,
    magic_series_count,
    q_pochhammer_coeffs,
    restricted_partition_series,
)

__all__ = [
    "cyclic_convolve",
    "make_convolver",
    "poly_multiply",
    "q_pochhammer_coeffs",
    "restricted_partition_series",
    "gaussian_binomial_coefficient",
    "magic_series_count",
    "kinnaes_magic_series_count",
    "kinnaes_parameters",
]
