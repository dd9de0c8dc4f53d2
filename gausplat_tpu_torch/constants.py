"""Shared pipeline constants.

The same values as ``gausplat_tpu/constants.py``, restated so the port
imports no JAX. Sources in the reference renderer (gausplat-renderer):

- Spherical harmonics: src/spherical_harmonics/mod.rs:6-77
- Tile size / batch size: .../jit/kernel/rasterize/mod.rs:66-68 (16x16)
- Depth window: .../jit/kernel/transform/kernel.wgsl:104-106
- Radius factor / low-pass filter: .../jit/kernel/transform/kernel.wgsl:108-110
- Opacity clamps / transmittance floor: .../jit/kernel/rasterize/kernel.wgsl:50-52
- Depth-order bit trick: .../jit/kernel/rank/kernel.wgsl:31,112-114
- Tile-count ceiling / pixel ceiling: .../jit/kernel/rank/mod.rs:45, jit/mod.rs:19
"""

import math

import numpy as np

# --- Spherical harmonics ----------------------------------------------------

#: Maximum supported SH degree.
SH_DEGREE_MAX = 3

#: Number of SH coefficients at ``SH_DEGREE_MAX`` ((d+1)^2).
SH_COUNT_MAX = (SH_DEGREE_MAX + 1) ** 2

#: Real coefficients of the orthonormalized spherical harmonics, degree 0..3.
#: Grouped per degree, float64 (cast at use sites).
SH_COEF = (
    np.array([math.sqrt(1.0 / (4.0 * math.pi))]),
    np.array(
        [
            -math.sqrt(3.0 / (4.0 * math.pi)),
            math.sqrt(3.0 / (4.0 * math.pi)),
            -math.sqrt(3.0 / (4.0 * math.pi)),
        ]
    ),
    np.array(
        [
            math.sqrt(15.0 / (4.0 * math.pi)),
            -math.sqrt(15.0 / (4.0 * math.pi)),
            math.sqrt(5.0 / (16.0 * math.pi)),
            -math.sqrt(15.0 / (4.0 * math.pi)),
            math.sqrt(15.0 / (16.0 * math.pi)),
        ]
    ),
    np.array(
        [
            -math.sqrt(35.0 / (32.0 * math.pi)),
            math.sqrt(105.0 / (4.0 * math.pi)),
            -math.sqrt(21.0 / (32.0 * math.pi)),
            math.sqrt(7.0 / (16.0 * math.pi)),
            -math.sqrt(21.0 / (32.0 * math.pi)),
            math.sqrt(105.0 / (16.0 * math.pi)),
            -math.sqrt(35.0 / (32.0 * math.pi)),
        ]
    ),
)

#: SH DC coefficient (degree 0), used by point-cloud color init.
SH_C0 = float(SH_COEF[0][0])

# --- Rasterization geometry --------------------------------------------------

#: Tile width/height in pixels. One raster work unit covers one tile.
TILE_SIZE_X = 16
TILE_SIZE_Y = 16

#: Max tiles per frame: the (tile | depth) sort key keeps the tile id in the
#: high 16 bits, so the tile index must fit 16 bits.
TILE_COUNT_MAX = 1 << 16

#: Max pixels per frame.
PIXEL_COUNT_MAX = TILE_SIZE_X * TILE_SIZE_Y * TILE_COUNT_MAX

# --- Projection / culling ----------------------------------------------------

#: Accepted depth window. Chosen so depth maps monotonically onto a 16-bit
#: key (see ``DEPTH_ORDER_OFFSET``): [2^-2, 2^14).
DEPTH_MIN = 1.0 / float(1 << (3 - 1))
DEPTH_MAX = float(1 << (17 - 3))

#: r solving 0.9973 = integral[-r, r] exp(-x^2/2) dx / sqrt(2 pi).
FACTOR_RADIUS = 2.9999771

#: EWA low-pass filter added to the diagonal of the 2D covariance.
FILTER_LOW_PASS = 0.3

# --- Alpha blending ----------------------------------------------------------

#: Per-point 2D opacity clamp range.
OPACITY_2D_MAX = 252.0 / 255.0
OPACITY_2D_MIN = 1.0 / 255.0

#: A pixel stops accumulating once its transmittance would drop below this.
TRANSMITTANCE_MIN = (1.0 - OPACITY_2D_MAX) ** 2

# --- Depth sort key ----------------------------------------------------------

#: Bias added to the raw float32 bits of a depth in [2^-2, 2^14) so that
#: ``(bits(depth) + DEPTH_ORDER_OFFSET) >> 11`` (wrapping u32 add) is a
#: monotone 16-bit integer.
DEPTH_ORDER_OFFSET = ((3 << 23) + 0xC0000000) & 0xFFFFFFFF

# --- Misc ---------------------------------------------------------------------

#: Default RNG seed for scene initialisation.
SEED = 0x3D65

#: Default capacity multiplier for the tile-point entry buffer: the entry
#: buffers have a fixed size, budgeted as
#: ``capacity = point_count * TILE_POINT_EXPANSION`` unless overridden.
TILE_POINT_EXPANSION = 65
