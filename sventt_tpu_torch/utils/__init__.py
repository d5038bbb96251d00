"""Utilities of the PyTorch port."""

from .device import resolve_device
from .fill import device_fill, host_fill

__all__ = ["device_fill", "host_fill", "resolve_device"]
