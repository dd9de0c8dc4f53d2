"""Densification / pruning controller.

Counterpart of ``gausplat_tpu/train/densify.py``. Driven by the two signals
the reference renderer exports for it (render/gaussian_3d/mod.rs:78-93):
the per-point 2-D position gradient norms and the visible radii. Standard
3DGS adaptive density control: clone small high-gradient Gaussians, split
large ones, prune transparent or oversized ones, reset opacity now and then.

The JAX package runs this on the host in numpy. Here the statistics, the
masks, the split geometry and the concatenation stay on the scene's
device; only the split samples' ``[k * n_split, 3]`` standard normals cross
from the host, drawn from the same ``np.random.default_rng(seed + P)``
stream as the JAX package draws them, so both make the same points from
the same statistics. Reading the split and clone counts syncs with the
host once per event.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.gaussian_3d import PARAM_DIMS, GaussianScene


def zero_densify_acc(point_count: int, device) -> dict:
    """Fresh on-device densification accumulators (grad-norm sums,
    visibility counts, max radii)."""
    return {
        "grad_norm_sum": torch.zeros((point_count,), dtype=torch.float32, device=device),
        "visible_count": torch.zeros((point_count,), dtype=torch.int32, device=device),
        "max_radii": torch.zeros((point_count,), dtype=torch.int32, device=device),
    }


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2.0e-4
    percent_dense: float = 0.01
    scene_extent: float = 1.0
    split_factor: float = 1.6
    split_samples: int = 2
    min_opacity: float = 5.0e-3
    max_screen_radius: float = 0.0  # 0 disables radius pruning
    opacity_reset_value: float = 0.01
    seed: int = 0


@dataclasses.dataclass
class DensifyState:
    """Accumulated densification statistics between densify events."""

    grad_norm_sum: torch.Tensor  # [P] float32
    visible_count: torch.Tensor  # [P] int32
    max_radii: torch.Tensor  # [P] int32

    @classmethod
    def zeros(cls, point_count: int, *, device) -> "DensifyState":
        return cls(**zero_densify_acc(point_count, device))

    def accumulate(self, grad_norm: torch.Tensor, radii: torch.Tensor) -> None:
        """Add one view's statistics in place: the grad norms of the points
        it sees (``radii > 0``), their visibility, and the running max
        radius."""
        visible = radii > 0
        self.grad_norm_sum.add_(torch.where(visible, grad_norm, torch.zeros_like(grad_norm)))
        self.visible_count.add_(visible.to(torch.int32))
        torch.maximum(self.max_radii, radii, out=self.max_radii)


def _rotation_matrices(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (x, y, z, w) [n, 4] -> rotation matrices [n, 3, 3]."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ).reshape(-1, 3, 3)


@torch.no_grad()
def densify_and_prune(
    scene: GaussianScene,
    state: DensifyState,
    config: DensifyConfig = DensifyConfig(),
) -> tuple[GaussianScene, DensifyState, dict]:
    """One densify/prune event. Returns (new scene, fresh state, stats)."""
    params = {name: getattr(scene, name).detach() for name in PARAM_DIMS}
    device = params["positions"].device
    p = params["positions"].shape[0]
    rng = np.random.default_rng(config.seed + p)

    # float64, as numpy divides float32 sums by int32 counts.
    avg_grad = state.grad_norm_sum.to(torch.float64) / torch.clamp_min(state.visible_count, 1)
    high_grad = avg_grad > config.grad_threshold
    scales = torch.exp(params["scalings"])
    max_scale = scales.amax(dim=1)
    dense_limit = config.percent_dense * config.scene_extent

    clone_mask = high_grad & (max_scale <= dense_limit)
    split_mask = high_grad & (max_scale > dense_limit)

    # Clones: exact copies (they drift apart under their own gradients).
    clones = {k: v[clone_mask] for k, v in params.items()}

    # Splits: sample positions from the Gaussian, shrink the scales.
    k = config.split_samples
    idx = torch.nonzero(split_mask).flatten()
    splits = {key: v[idx].repeat_interleave(k, dim=0) for key, v in params.items()}
    if idx.numel():
        q = params["rotations"][idx]
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        rot = _rotation_matrices(q).repeat_interleave(k, dim=0)
        noise = rng.standard_normal((idx.numel() * k, 3)).astype(np.float32)
        local = torch.as_tensor(noise, device=device)
        split_scales = scales[idx].repeat_interleave(k, dim=0)
        local = local * split_scales
        splits["positions"] = splits["positions"] + torch.einsum("pij,pj->pi", rot, local)
        splits["scalings"] = torch.log(split_scales / config.split_factor)

    # Prune: split originals, transparent points, and optionally big ones.
    opacity = 1.0 / (1.0 + torch.exp(-params["opacities"][:, 0]))
    prune_mask = split_mask | (opacity < config.min_opacity)
    if config.max_screen_radius > 0:
        prune_mask |= state.max_radii > config.max_screen_radius
    keep = ~prune_mask

    new_scene = GaussianScene(
        **{key: torch.cat([v[keep], clones[key], splits[key]], dim=0)
           for key, v in params.items()}
    )
    stats = {
        "cloned": int(clone_mask.sum()),
        "split": int(idx.numel()),
        "pruned": int(prune_mask.sum()),
        "point_count": new_scene.point_count,
    }
    return new_scene, DensifyState.zeros(new_scene.point_count, device=device), stats


@torch.no_grad()
def reset_opacity(scene: GaussianScene, config: DensifyConfig = DensifyConfig()) -> GaussianScene:
    """Clamp opacity (outer) to at most ``opacity_reset_value``; the other
    parameters are shared with ``scene``."""
    outer = torch.sigmoid(scene.opacities)
    clamped = torch.clamp(torch.clamp_max(outer, config.opacity_reset_value), 1e-6, 1 - 1e-6)
    inner = torch.log(clamped / (1.0 - clamped))
    params = {name: getattr(scene, name).detach() for name in PARAM_DIMS}
    return GaussianScene(**{**params, "opacities": inner})


def camera_extent(views) -> float:
    """Scene extent from the training cameras, as standard 3DGS derives it:
    the radius of the camera centres' bounding sphere times 1.1. Feed it to
    ``DensifyConfig.scene_extent`` and ``OptimizerConfig.scene_extent``."""
    centers = np.stack([np.asarray(v.view_position, np.float64) for v in views])
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max())
    return max(radius * 1.1, 1e-6)
