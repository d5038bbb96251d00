"""Plan layer of the PyTorch port: config, planner and the NTT wrapper."""

from .config import NttConfig
from .wrapper import NTT

__all__ = ["NTT", "NttConfig"]
