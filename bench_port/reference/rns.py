"""The plain reference of a multi-modular (RNS) configuration: one radix-2
``ReferenceNTT`` (``reference/ntt.py``) a limb, applied limb by limb.

Data is (L, n), limb l at row l, each row held to the single-modulus
contract of ``reference/ntt.py`` over its own modulus q_l: ``forward`` in
bit-reversed order, ``inverse`` in natural order scaled by 1/n, canonical
values in [0, q_l).  ``arithmetic="float64"`` is the control: every limb's
modular products with float64 quotients.
"""

from __future__ import annotations

import torch

from .ntt import ReferenceNTT


class ReferenceRNS:
    """Forward and inverse transforms and cyclic products of length n over
    each limb's Z/q_l, on ``device``."""

    def __init__(self, moduli, generators, n: int, device, arithmetic: str = "exact"):
        if len(moduli) != len(generators) or not moduli:
            raise ValueError("one generator a modulus, and at least one limb")
        self.limbs = [ReferenceNTT(q, g, n, device, arithmetic=arithmetic)
                      for q, g in zip(moduli, generators)]

    def _each(self, method: str, *xs: torch.Tensor) -> torch.Tensor:
        if any(x.shape[0] != len(self.limbs) for x in xs):
            raise ValueError(f"expected {len(self.limbs)} limbs along axis 0")
        return torch.stack([getattr(ref, method)(*(x[i] for x in xs))
                            for i, ref in enumerate(self.limbs)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._each("forward", x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        return self._each("inverse", x)

    def polymul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Each limb's length-n cyclic convolution of a and b."""
        return self._each("polymul", a, b)


def build(config: dict, device, arithmetic: str = "exact") -> ReferenceRNS:
    """The reference of a configuration file with ``moduli``, ``generators``
    and ``n``."""
    return ReferenceRNS(config["moduli"], config["generators"], config["n"], device,
                        arithmetic=arithmetic)
