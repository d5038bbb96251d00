"""Counterparts of the JAX package's experimental probes (``experimental/``)
that hold a TPU kernel: ``mxu_fused_kernel`` (K11)."""
