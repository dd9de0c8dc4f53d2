"""3DGS scene representation as a ``torch.nn.Module``.

Counterpart of ``gausplat_tpu/scene/gaussian_3d.py``. Reference:
src/scene/gaussian_3d/mod.rs:54-275 (scene params) and property.rs:61-170
(inner/outer property transforms).

The scene holds the five *inner* (optimisable) parameters:

- ``colors_sh``  [P, 48]   SH coefficients ([P, M, 3] flattened, M=16)
- ``opacities``  [P, 1]    logit-space opacity (outer = sigmoid(inner))
- ``positions``  [P, 3]    world positions
- ``rotations``  [P, 4]    quaternion, scalar-last (x, y, z, w); normalized on read
- ``scalings``   [P, 3]    log-space scale (outer = exp(inner))
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..constants import SH_COUNT_MAX
from ..errors import MismatchedTensorShapeError

#: Trailing (per-point) dimension of each parameter tensor, in order.
PARAM_DIMS = {
    "colors_sh": SH_COUNT_MAX * 3,
    "opacities": 1,
    "positions": 3,
    "rotations": 4,
    "scalings": 3,
}


class GaussianScene(nn.Module):
    """The five inner parameters of a 3DGS scene, as ``nn.Parameter`` s."""

    def __init__(
        self,
        colors_sh: torch.Tensor,
        opacities: torch.Tensor,
        positions: torch.Tensor,
        rotations: torch.Tensor,
        scalings: torch.Tensor,
    ):
        super().__init__()
        given = dict(
            colors_sh=colors_sh, opacities=opacities, positions=positions,
            rotations=rotations, scalings=scalings,
        )
        for name, want in PARAM_DIMS.items():
            value = given[name]
            if value.dim() < 2 or value.shape[-1] != want:
                raise MismatchedTensorShapeError(
                    f"{name}: {tuple(value.shape)}", f"[..., P, {want}]"
                )
            self.register_parameter(name, nn.Parameter(value))

    # -- constructors ----------------------------------------------------------

    @classmethod
    def from_numpy(
        cls, *, colors_sh, opacities, positions, rotations, scalings, device
    ) -> "GaussianScene":
        """Build a scene from array-likes, as float32 tensors on ``device``."""

        def tensor(x):
            return torch.as_tensor(
                np.array(x, np.float32, copy=True, order="C"), device=device
            )

        return cls(
            tensor(colors_sh), tensor(opacities), tensor(positions),
            tensor(rotations), tensor(scalings),
        )

    @classmethod
    def from_arrays(cls, obj, *, device) -> "GaussianScene":
        """Build a scene from any object with the five parameter attributes.

        Each attribute goes through ``np.asarray``, so this takes a
        ``gausplat_tpu.GaussianScene`` (whose leaves are JAX arrays)
        without importing JAX here.
        """
        return cls.from_numpy(
            **{name: np.asarray(getattr(obj, name)) for name in PARAM_DIMS},
            device=device,
        )

    # -- attributes ------------------------------------------------------------

    @property
    def point_count(self) -> int:
        shapes = {name: tuple(getattr(self, name).shape) for name in PARAM_DIMS}
        if len({s[:-1] for s in shapes.values()}) != 1:
            raise MismatchedTensorShapeError(
                shapes,
                "a single shared point dimension across all five parameters",
            )
        return self.colors_sh.shape[-2]

    @property
    def size_bytes(self) -> int:
        return sum(
            getattr(self, name).numel() * getattr(self, name).element_size()
            for name in PARAM_DIMS
        )

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def extra_repr(self) -> str:
        return f"point_count={self.point_count}, size={self.size_bytes}B"

    # -- outer property getters (property.rs:61-93) ----------------------------

    def get_colors_sh(self) -> torch.Tensor:
        return self.colors_sh

    def get_opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacities)

    def get_positions(self) -> torch.Tensor:
        return self.positions

    def get_rotations(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.rotations**2, dim=-1, keepdim=True))
        return self.rotations / norm

    def get_scalings(self) -> torch.Tensor:
        return torch.exp(self.scalings)
