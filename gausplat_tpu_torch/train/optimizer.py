"""Per-parameter Adam for 3DGS scenes (the standard 3DGS schedule).

Counterpart of ``gausplat_tpu/train/optimizer.py``, written out on tensors
rather than through ``torch.optim.Adam``: one tensor, ``colors_sh``, needs
two learning rates (its DC columns at ``colors_sh_dc_lr``, the rest at
``dc_lr / colors_sh_rest_div``), which parameter groups cannot give.

The state mirrors ``optax.scale_by_adam(eps=1e-15)`` field by field:
``{"adam": {field: (count, mu, nu)}, "count": int32}``. Each field keeps
its own bias-correction count; the outer ``count`` drives the position
learning-rate schedule. A fresh state (after densification) restarts the
bias corrections, and :func:`seed_count` re-keys only the outer count to
the global step. Every count is a 0-d int32 tensor on the parameters'
device, so an update never syncs with the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..scene.gaussian_3d import PARAM_DIMS

FIELDS = tuple(PARAM_DIMS)

#: optax.scale_by_adam's decay rates.
ADAM_B1 = 0.9
ADAM_B2 = 0.999


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_max_steps: int = 30_000
    colors_sh_dc_lr: float = 2.5e-3
    colors_sh_rest_div: float = 20.0  # rest lr = dc lr / 20
    opacity_lr: float = 5.0e-2
    scaling_lr: float = 5.0e-3
    rotation_lr: float = 1.0e-3
    scene_extent: float = 1.0
    eps: float = 1e-15


def position_lr_schedule(config: OptimizerConfig):
    """Log-linear interpolation from init to final over max_steps, in
    float32 on the step's device. The logs of init and final are made once
    per device, so a schedule inside a captured CUDA graph copies nothing
    from the host."""
    init = config.position_lr_init * config.scene_extent
    final = config.position_lr_final * config.scene_extent
    logs = {}

    def schedule(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step / config.position_lr_max_steps, 0.0, 1.0)
        if t.device not in logs:
            logs[t.device] = tuple(
                torch.log(torch.tensor(x, dtype=torch.float32, device=t.device))
                for x in (init, final))
        log_init, log_final = logs[t.device]
        return torch.exp((1.0 - t) * log_init + t * log_final)

    return schedule


def _sh_lr_scale(config: OptimizerConfig, device) -> torch.Tensor:
    """Column-wise lr scale for colors_sh: DC columns (0:3) at 1, the
    higher orders at 1 / ``colors_sh_rest_div``."""
    scale = torch.ones((1, 48), dtype=torch.float32, device=device) / config.colors_sh_rest_div
    scale[:, 0:3] = 1.0
    return scale


def seed_count(state: dict, step: int) -> dict:
    """Re-key a fresh optimizer state to the global step: the position-lr
    schedule continues from the training iteration after a densify, while
    the per-field bias corrections restart."""
    return {**state, "count": torch.tensor(step, dtype=torch.int32,
                                           device=state["count"].device)}


class Optimizer(NamedTuple):
    """``init(scene) -> state`` and ``update(grads, state) -> (updates,
    state)``, as an optax GradientTransformation; ``grads`` and ``updates``
    are ``{field: tensor}``, and the caller adds the updates. ``update``
    writes the new moments and counts into the state's own tensors and
    returns that state, so a captured step keeps their addresses."""

    init: object
    update: object


def make_optimizer(config: OptimizerConfig = OptimizerConfig()) -> Optimizer:
    """Explicit per-field Adam: each of the five parameters has its own
    moments and learning rate (positions on the decaying schedule; the
    higher-order SH columns at dc_lr / 20)."""
    schedule = position_lr_schedule(config)
    sh_scales = {}  # the colors_sh lr scale, made once per device

    def init(scene) -> dict:
        params = {f: getattr(scene, f) for f in FIELDS}
        device = params["positions"].device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return {
            "adam": {
                f: (zero.clone(), torch.zeros_like(p.detach()), torch.zeros_like(p.detach()))
                for f, p in params.items()
            },
            "count": zero.clone(),
        }

    def update(grads: dict, state: dict):
        count = state["count"].add_(1)
        updates = {}
        for f in FIELDS:
            g = grads[f]
            c, mu, nu = state["adam"][f]
            torch.add((1 - ADAM_B1) * g, ADAM_B1 * mu, out=mu)
            torch.add((1 - ADAM_B2) * (g * g), ADAM_B2 * nu, out=nu)
            c.add_(1)
            cf = c.to(torch.float32)
            mu_hat = mu / (1 - ADAM_B1**cf)
            nu_hat = nu / (1 - ADAM_B2**cf)
            updates[f] = mu_hat / (torch.sqrt(nu_hat) + config.eps)
        device = updates["colors_sh"].device
        if device not in sh_scales:
            sh_scales[device] = _sh_lr_scale(config, device)
        updates["colors_sh"] = updates["colors_sh"] * (-config.colors_sh_dc_lr * sh_scales[device])
        updates["opacities"] = updates["opacities"] * (-config.opacity_lr)
        updates["positions"] = updates["positions"] * (-schedule(count))
        updates["rotations"] = updates["rotations"] * (-config.rotation_lr)
        updates["scalings"] = updates["scalings"] * (-config.scaling_lr)
        return updates, state

    return Optimizer(init, update)


def optimizer_state_from_arrays(state, *, device) -> dict:
    """The JAX package's optimizer state (``{"adam": {field: (count, mu,
    nu)}, "count"}``, leaves as arrays of any kind, e.g. the
    ``ScaleByAdamState`` tuples of ``make_optimizer(...).init``) as this
    package's, on ``device``."""

    def tensor(x, dtype):
        return torch.as_tensor(np.array(x, dtype, copy=True), device=device)

    adam = {}
    for f in FIELDS:
        count, mu, nu = tuple(state["adam"][f])
        adam[f] = (tensor(count, np.int32), tensor(mu, np.float32), tensor(nu, np.float32))
    return {"adam": adam, "count": tensor(state["count"], np.int32)}

