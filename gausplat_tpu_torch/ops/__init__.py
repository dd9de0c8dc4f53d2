"""Operators: projection, binning, the expansion and rasterizer kernels."""

from . import binning, blend, projection, rasterize

__all__ = ["binning", "blend", "projection", "rasterize"]
