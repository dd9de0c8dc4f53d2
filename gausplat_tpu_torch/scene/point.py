"""Point cloud types (numpy only).

The same ``Points`` as ``gausplat_tpu/scene/point.py``, restated so the
port imports no JAX. Reference: src/scene/point/mod.rs:10-41 (Point struct
and the COLMAP conversions). A cloud is stored columnar, as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Points:
    """A point cloud: normalized RGB colors and world positions.

    - ``colors_rgb``: float32 ``[P, 3]`` in [0, 1].
    - ``positions``: float64 ``[P, 3]``.
    """

    colors_rgb: np.ndarray
    positions: np.ndarray

    def __post_init__(self):
        self.colors_rgb = np.ascontiguousarray(self.colors_rgb, dtype=np.float32)
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float64)
        if self.colors_rgb.shape != (len(self), 3):
            raise ValueError(f"colors_rgb shape {self.colors_rgb.shape}")
        if self.positions.shape != (len(self), 3):
            raise ValueError(f"positions shape {self.positions.shape}")

    def __len__(self) -> int:
        return self.positions.shape[0]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Points)
            and np.array_equal(self.colors_rgb, other.colors_rgb)
            and np.array_equal(self.positions, other.positions)
        )

    @classmethod
    def default(cls, count: int) -> "Points":
        """``count`` default points (black, at the origin)."""
        return cls(np.zeros((count, 3), np.float32), np.zeros((count, 3), np.float64))

    # -- COLMAP conversions (reference point/mod.rs:17-41) --------------------

    @classmethod
    def from_colmap(cls, colors_rgb_u8: np.ndarray, positions: np.ndarray) -> "Points":
        """From COLMAP u8 colors: normalized as ``c / 255``."""
        colors = np.asarray(colors_rgb_u8, dtype=np.float32) / 255.0
        return cls(colors, positions)

    def to_colmap(self) -> tuple[np.ndarray, np.ndarray]:
        """To COLMAP u8 colors: ``clamp(c * 255 + 0.5, 0, 255)`` truncated."""
        colors_u8 = np.clip(
            self.colors_rgb * np.float32(255.0) + np.float32(0.5), 0.0, 255.0
        ).astype(np.uint8)
        return colors_u8, self.positions
