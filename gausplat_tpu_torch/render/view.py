"""Camera views (numpy only).

The same ``View`` as ``gausplat_tpu/render/view.py``, restated so the port
imports no JAX. Reference: src/render/view/mod.rs:9-79 (View struct,
``transform`` constructor, ``resize_max``) and views.rs (Views map).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np


@dataclasses.dataclass
class View:
    """A camera view.

    ``view_transform`` is the affine world-to-view transform stored in
    **column-major order** (``M[col][row]``), matching the reference layout::

        [R_v   | T_v]
        [...   | ...]
        [0 0 0 | 1  ]

    so ``R_v = view_transform[:3, :3].T`` and ``T_v = view_transform[3, :3]``.
    """

    field_of_view_x: float = 0.0
    field_of_view_y: float = 0.0
    image_height: int = 0
    image_width: int = 0
    view_id: int = 0
    view_position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64)
    )
    view_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((4, 4), np.float64)
    )

    def __post_init__(self):
        self.view_position = np.asarray(self.view_position, dtype=np.float64)
        self.view_transform = np.asarray(self.view_transform, dtype=np.float64)

    @staticmethod
    def transform(rotation, translation) -> np.ndarray:
        """Build the column-major affine transform from ``R_v`` (given
        column-major, ``rotation[col][row]``) and ``T_v``."""
        rotation = np.asarray(rotation, dtype=np.float64)
        translation = np.asarray(translation, dtype=np.float64)
        out = np.zeros((4, 4), np.float64)
        out[:3, :3] = rotation
        out[3, :3] = translation
        out[3, 3] = 1.0
        return out

    # -- derived quantities ----------------------------------------------------

    @property
    def aspect_ratio(self) -> float:
        return self.image_width / self.image_height

    def resize_max(self, to: int) -> "View":
        """Resize so the longer side equals ``to`` (in place), keeping ratio."""
        ratio = np.float32(self.image_width) / np.float32(self.image_height)
        if ratio > 1.0:
            self.image_width = to
            self.image_height = int(math.ceil(np.float32(to) / ratio))
        else:
            self.image_width = int(math.ceil(np.float32(to) * ratio))
            self.image_height = to
        return self

    def view_rotation(self) -> np.ndarray:
        """``R_v`` as a row-major math operator: ``p_view = R_v @ p + T_v``."""
        return self.view_transform[:3, :3].T

    def view_translation(self) -> np.ndarray:
        return self.view_transform[3, :3]


#: Keyed collection of views (reference: ``Views = IndexMap<u32, View>``).
Views = Dict[int, View]
