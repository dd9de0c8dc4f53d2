"""3DGS scene representation as a ``torch.nn.Module``.

Counterpart of ``gausplat_tpu/scene/gaussian_3d.py``. Reference:
src/scene/gaussian_3d/mod.rs:54-275 (scene params), property.rs:61-170
(inner/outer property transforms) and import.rs:92-258 (point-cloud
initialisation).

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

from ..constants import SEED, SH_C0, SH_COUNT_MAX
from ..errors import MismatchedTensorShapeError
from .point import Points

_F32_EPS = float(np.finfo(np.float32).eps)

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

    @classmethod
    def from_points(
        cls,
        points: Points,
        *,
        device="cuda",
        seed: int = SEED,
        seed_compat: str = "reference",
    ) -> "GaussianScene":
        """Initialise a scene from an SfM point cloud, on ``device``.

        The numpy arithmetic of the JAX package's ``from_points``, so the
        arrays are bit-identical: SH DC from RGB, opacity 0.1, identity
        rotations, seeded LogNormal(0, e) scales normalized by the max, then
        square-rooted and repeated over the 3 axes (import.rs:92-258).
        ``seed_compat="reference"`` draws the scale samples from the
        reference's RNG stream (:mod:`gausplat_tpu_torch.utils.rand_compat`),
        ``"numpy"`` from numpy's PCG64 (same distribution, another stream).
        """
        point_count = len(points)

        colors_sh = np.zeros((point_count, SH_COUNT_MAX * 3), np.float32)
        colors_sh[:, 0:3] = (points.colors_rgb - 0.5) / np.float32(SH_C0)

        opacities = np.full((point_count, 1), 25.5 / 255.0, np.float32)
        opacities = np.log(opacities / (1.0 - opacities))

        positions = points.positions.astype(np.float32)

        rotations = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (point_count, 1))

        if seed_compat == "reference":
            from ..utils.rand_compat import reference_lognormal_e_f32

            samples = reference_lognormal_e_f32(point_count, seed)[:, None]
        else:
            rng = np.random.default_rng(seed)
            samples = rng.lognormal(
                mean=0.0, sigma=float(np.e), size=(point_count, 1)
            ).astype(np.float32)
        samples = np.maximum(samples, _F32_EPS)
        sample_max = max(float(samples.max()) if point_count else 0.0, _F32_EPS)
        scalings = np.sqrt(samples / np.float32(sample_max))
        scalings = np.maximum(scalings, _F32_EPS)
        scalings = np.log(np.repeat(scalings, 3, axis=1))

        return cls.from_numpy(
            colors_sh=colors_sh, opacities=opacities, positions=positions,
            rotations=rotations, scalings=scalings, device=device,
        )

    @classmethod
    def default(cls, *, device="cuda") -> "GaussianScene":
        """16 default points, as the reference's ``Default`` impl."""
        return cls.from_points(Points.default(16), device=device)

    def to_points(self) -> Points:
        """Export as a point cloud (export.rs:75-106)."""
        colors_rgb = self.get_colors_sh()[:, 0:3].detach().cpu().numpy() * np.float32(
            SH_C0
        ) + np.float32(0.5)
        positions = self.get_positions().detach().cpu().numpy().astype(np.float64)
        return Points(colors_rgb, positions)

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
        return make_colors_sh(self.colors_sh)

    def get_opacities(self) -> torch.Tensor:
        return make_opacities(self.opacities)

    def get_positions(self) -> torch.Tensor:
        return make_positions(self.positions)

    def get_rotations(self) -> torch.Tensor:
        return make_rotations(self.rotations)

    def get_scalings(self) -> torch.Tensor:
        return make_scalings(self.scalings)

    # -- outer property setters (property.rs:96-137) ---------------------------
    #
    # Each returns a new scene that owns copies of its parameters, as the
    # JAX package's functional setters leave the old scene as it was. The
    # value goes to float32 on the scene's device before the inverse
    # transform, as ``jnp.asarray`` keeps a float32 array.

    def _with(self, **inner) -> "GaussianScene":
        params = {name: getattr(self, name).detach().clone() for name in PARAM_DIMS}
        params.update(inner)
        return GaussianScene(**params)

    def _outer(self, value) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, np.float32))
        return value.detach().to(device=self.device, dtype=torch.float32).clone()

    def set_colors_sh(self, value) -> "GaussianScene":
        return self._with(colors_sh=self._outer(value))

    def set_opacities(self, value) -> "GaussianScene":
        return self._with(opacities=make_inner_opacities(self._outer(value)))

    def set_positions(self, value) -> "GaussianScene":
        return self._with(positions=self._outer(value))

    def set_rotations(self, value) -> "GaussianScene":
        return self._with(rotations=self._outer(value))

    def set_scalings(self, value) -> "GaussianScene":
        return self._with(scalings=make_inner_scalings(self._outer(value)))


# --- inner <-> outer transforms (property.rs) ---------------------------------
#
# ``make_*`` map an inner (optimisable) parameter to its outer value,
# ``make_inner_*`` the outer value back. An array-like that is not a tensor
# becomes a float32 tensor, as ``jnp.asarray`` keeps a float32 array.


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, np.float32))


def make_colors_sh(colors_sh):
    return colors_sh


def make_opacities(opacities):
    return torch.sigmoid(opacities)


def make_positions(positions):
    return positions


def make_rotations(rotations):
    norm = torch.sqrt(torch.sum(rotations**2, dim=-1, keepdim=True))
    return rotations / norm


def make_scalings(scalings):
    return torch.exp(scalings)


def make_inner_colors_sh(colors_sh):
    return _tensor(colors_sh)


def make_inner_opacities(opacities):
    opacities = _tensor(opacities)
    return torch.log(opacities / (1.0 - opacities))


def make_inner_positions(positions):
    return _tensor(positions)


def make_inner_rotations(rotations):
    return _tensor(rotations)


def make_inner_scalings(scalings):
    return torch.log(_tensor(scalings))
