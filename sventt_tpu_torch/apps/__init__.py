"""Applications: NTT convolution pipelines.

The counterpart of ``sventt_tpu/apps/`` for its convolutions; the
magic-series counters (``series``, ``kinnaes``) are not ported yet (ROADMAP
Queue 1 item 9).
"""

from .convolve import cyclic_convolve, make_convolver, poly_multiply

__all__ = ["cyclic_convolve", "make_convolver", "poly_multiply"]
