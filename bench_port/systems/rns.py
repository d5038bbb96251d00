"""The system ``rns``: the port's ``NTT`` of a multi-modular (RNS)
configuration on one card, every limb (one modulus each) in one call, built
and called as a user builds and calls it.

The port is imported only as its users import it: ``NTT``, ``NttConfig``
and ``apps.convolve.cyclic_convolve``.  A configuration gives ``moduli``
and ``generators`` (one a limb), ``n``, the ``NttConfig`` keywords
(``ntt_config``) and the ``NTT`` ones (``ntt_options``).  Data is (L, n),
limb l at row l.
"""

from __future__ import annotations


class System:
    """``forward``, ``inverse`` and ``polymul`` of one multi-modular NTT on
    ``device``."""

    def __init__(self, config: dict, mix: dict, device, chips: int):
        from sventt_tpu_torch import NTT, NttConfig
        from sventt_tpu_torch.apps.convolve import cyclic_convolve

        if chips > 1:
            raise ValueError("the system 'rns' runs on one card")
        cfg = NttConfig(tuple(config["moduli"]), tuple(config["generators"]), config["n"],
                        **config.get("ntt_config", {}))
        # a forward-only mix builds no inverse tables
        self.ntt = NTT(cfg, device=device, enable_forward=True,
                       enable_inverse=mix["op"] != "forward",
                       **config.get("ntt_options", {}))
        self._convolve = cyclic_convolve

    def forward(self, x):
        return self.ntt.compute_forward(x)

    def inverse(self, x):
        return self.ntt.compute_inverse(x)

    def polymul(self, a, b):
        return self._convolve(self.ntt, a, b)
