"""Plan layer of the PyTorch port: config, planner, the NTT wrapper and the
autotuner."""

from .autotune import tune
from .config import NttConfig
from .wrapper import NTT

__all__ = ["NTT", "NttConfig", "tune"]
