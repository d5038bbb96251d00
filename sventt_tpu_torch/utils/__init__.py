"""Utilities of the PyTorch port."""

from .fill import device_fill, host_fill

__all__ = ["device_fill", "host_fill"]
