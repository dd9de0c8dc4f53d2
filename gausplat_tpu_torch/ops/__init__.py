"""Operators: projection, binning, the expansion and rasterizer kernels."""
