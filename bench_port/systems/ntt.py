"""The system ``ntt``: the port's ``NTT`` on one card, built and called as a
user builds and calls it.

The port is imported only as its users import it: ``NTT``, ``NttConfig``
and ``apps.convolve.cyclic_convolve``.  A configuration gives
``modulus``, ``generator``, ``n``, the ``NttConfig`` keywords
(``ntt_config``) and the ``NTT`` ones (``ntt_options``).
"""

from __future__ import annotations


class System:
    """``forward``, ``inverse`` and ``polymul`` of one NTT on ``device``."""

    def __init__(self, config: dict, mix: dict, device, chips: int):
        from sventt_tpu_torch import NTT, NttConfig
        from sventt_tpu_torch.apps.convolve import cyclic_convolve

        if chips > 1:
            raise ValueError("the system 'ntt' runs on one card")
        cfg = NttConfig(config["modulus"], config["generator"], config["n"],
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
