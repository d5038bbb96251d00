"""Kernels and table builders of the PyTorch port."""
