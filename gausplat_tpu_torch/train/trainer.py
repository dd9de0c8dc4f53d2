"""The 3DGS training loop: one differentiable step plus host-side density
control.

Counterpart of ``gausplat_tpu/train/trainer.py``. One step renders,
computes L1 + D-SSIM, takes the gradients of the five parameters and of
the densification ref by autograd, and applies the per-parameter Adam in
place. The densify statistics accumulate on the device; the host reads
them only at densify events, and reads the entry-count watermark only at
its cadence, so a step without a host event never waits for the device.

SH-degree warm-up raises ``colors_sh_degree_max`` every
``sh_warmup_interval`` steps. The JAX package recompiles its step there;
here the next render simply takes the new degree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import SH_DEGREE_MAX
from ..render.pipeline import RenderOptions, _capacity, render
from ..render.view import View
from ..scene.gaussian_3d import GaussianScene
from .densify import (
    DensifyConfig,
    DensifyState,
    densify_and_prune,
    reset_opacity,
    zero_densify_acc,
)
from .losses import photometric_loss, psnr
from .optimizer import FIELDS, OptimizerConfig, make_optimizer, seed_count


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 30_000
    ssim_weight: float = 0.2
    sh_warmup_interval: int = 1_000
    densify_from: int = 500
    densify_until: int = 15_000
    densify_interval: int = 100
    opacity_reset_interval: int = 3_000
    #: Grow the tile-entry buffer when usage crosses this fraction.
    capacity_grow_at: float = 0.85
    capacity_grow_factor: float = 2.0
    #: Steps between host reads of the entry-count watermark; the buffer
    #: keeps ``capacity_grow_at`` headroom so a few unread steps cannot clip.
    overflow_check_interval: int = 50
    optimizer: OptimizerConfig = OptimizerConfig()
    densify: DensifyConfig = DensifyConfig()
    render: RenderOptions = RenderOptions()


def next_host_event(c: TrainConfig, now: int, end: int) -> int:
    """First step index > ``now`` at which a host intervention is due
    (SH warm-up, overflow check, densify, opacity reset), or ``end``."""

    def nxt(interval: int) -> int:
        interval = max(interval, 1)
        return (now // interval + 1) * interval

    cands = [end, nxt(c.sh_warmup_interval), nxt(c.overflow_check_interval)]
    d = max(
        nxt(c.densify_interval),
        -(-c.densify_from // c.densify_interval) * c.densify_interval,
    )
    if d < c.densify_until:
        cands.append(d)
    r = nxt(c.opacity_reset_interval)
    if c.densify_from <= r < c.densify_until:
        cands.append(r)
    return min(cands)


class Trainer:
    """Host-side orchestration of the training step and density control.

    The optimizer state starts afresh whenever densification reshapes the
    scene (new points start with fresh Adam moments); its outer count keeps
    the global step.
    """

    def __init__(
        self,
        scene: GaussianScene,
        image_width: int,
        image_height: int,
        config: TrainConfig = TrainConfig(),
    ):
        self.scene = scene
        self.config = config
        self.image_width = image_width
        self.image_height = image_height
        self.step_count = 0
        self.device = scene.device
        self._optimizer = make_optimizer(config.optimizer)
        self._densify_acc = zero_densify_acc(scene.point_count, self.device)
        self._opt_state = None
        self._opt_point_count = -1
        # Adaptive tile-entry capacity: start from the configured or
        # estimated budget, grow on near-overflow.
        self._entry_capacity = _capacity(scene.point_count, config.render)
        # Running on-device max of tile_point_total since the last check.
        self._entry_watermark = torch.zeros((), dtype=torch.int32, device=self.device)

    # -- internals -------------------------------------------------------------

    def _sh_degree(self) -> int:
        warm = self.step_count // max(self.config.sh_warmup_interval, 1)
        return min(min(warm, SH_DEGREE_MAX), self.config.render.colors_sh_degree_max)

    def _options(self) -> RenderOptions:
        return dataclasses.replace(
            self.config.render,
            colors_sh_degree_max=self._sh_degree(),
            tile_entry_capacity=self._entry_capacity,
        )

    def _prepare(self) -> torch.Tensor:
        """Fresh optimizer state and statistics after a reshape; returns the
        densification ref of this step."""
        p = self.scene.point_count
        if self._opt_point_count != p:
            self._opt_state = seed_count(self._optimizer.init(self.scene), self.step_count)
            self._opt_point_count = p
            self._densify_acc = zero_densify_acc(p, self.device)
        return torch.zeros((p,), dtype=torch.float32, device=self.device, requires_grad=True)

    def _apply_gradients(self, loss: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """Adam step from ``loss``; returns the ref's gradient (grad norms)."""
        params = [getattr(self.scene, f) for f in FIELDS]
        *grads, grad_norm = torch.autograd.grad(
            loss, params + [ref], allow_unused=True, materialize_grads=True
        )
        updates, self._opt_state = self._optimizer.update(
            dict(zip(FIELDS, grads)), self._opt_state
        )
        with torch.no_grad():
            for f, p in zip(FIELDS, params):
                p.add_(updates[f])
        return grad_norm

    def _target(self, target) -> torch.Tensor:
        return torch.as_tensor(target, dtype=torch.float32, device=self.device)

    # -- public API ------------------------------------------------------------

    def train_step(self, view: View, target) -> dict:
        """One optimization step against one view.

        Returns metrics as 0-d device tensors: the step does not wait for
        the device. Convert with ``float()`` when a value is needed.
        """
        ref = self._prepare()
        target = self._target(target)
        out = render(self.scene, view, self._options(), ref)
        loss = photometric_loss(out.colors_rgb_2d, target, self.config.ssim_weight)
        grad_norm = self._apply_gradients(loss, ref)
        acc = DensifyState(**self._densify_acc)
        acc.accumulate(grad_norm, out.radii)
        self._densify_acc = vars(acc)
        metrics = {
            "loss": loss.detach(),
            "psnr": psnr(out.colors_rgb_2d.detach(), target),
            "tile_point_total": out.tile_point_total,
        }
        self.step_count += 1
        self._entry_watermark = torch.maximum(self._entry_watermark, out.tile_point_total)
        stats = self._host_events()
        return {**metrics, **stats} if stats else metrics

    def train_step_batch(self, views, targets) -> dict:
        """One optimization step from the mean loss over a view batch (the
        views render one after another into one graph). The densify
        statistics match ``len(views)`` successive single-view steps;
        ``step_count`` advances by the batch size. As in the JAX package,
        no host event runs here."""
        views = list(views)
        ref = self._prepare()
        targets = [self._target(t) for t in targets]
        options = self._options()
        outs = [render(self.scene, v, options, ref) for v in views]
        losses = [
            photometric_loss(o.colors_rgb_2d, t, self.config.ssim_weight)
            for o, t in zip(outs, targets)
        ]
        loss = torch.mean(torch.stack(losses))
        grad_norm = self._apply_gradients(loss, ref)
        n = len(views)
        radii = torch.stack([o.radii for o in outs])
        acc = self._densify_acc
        self._densify_acc = {
            # The shared ref's gradient sums the per-view norms of the mean
            # loss's gradients; times V it equals V single-view steps.
            "grad_norm_sum": acc["grad_norm_sum"] + grad_norm * n,
            "visible_count": acc["visible_count"] + (radii > 0).to(torch.int32).sum(0),
            "max_radii": torch.maximum(acc["max_radii"], radii.amax(0)),
        }
        self.step_count += n
        return {
            "loss": loss.detach(),
            "psnr": psnr(torch.stack([o.colors_rgb_2d.detach() for o in outs]),
                         torch.stack(targets)),
            "tile_point_total": torch.stack([o.tile_point_total for o in outs]).amax(),
        }

    def fit(self, views, targets, iterations: Optional[int] = None) -> list:
        """Round-robin fit over (views, targets). Returns the metric
        history as host floats, read once at the end."""
        iterations = iterations or self.config.iterations
        history = []
        n = len(views)
        for _ in range(iterations):
            # By the global step, so a resumed trainer replays the sequence.
            j = self.step_count % n
            history.append(self.train_step(views[j], targets[j]))
        return [
            {k: (float(v) if isinstance(v, torch.Tensor) and v.dim() == 0 else v)
             for k, v in h.items()}
            for h in history
        ]

    def _host_events(self) -> dict:
        """Host interventions after the step at ``step_count``: densify,
        opacity reset, and the overflow watch at its cadence. Returns the
        densify stats when a densify ran."""
        c = self.config
        stats = {}
        check_overflow = self.step_count % c.overflow_check_interval == 0
        watermark_scale = 1.0
        if c.densify_from <= self.step_count < c.densify_until:
            if self.step_count % c.densify_interval == 0:
                old_count = self.scene.point_count
                state = DensifyState(**self._densify_acc)
                self.scene, _, stats = densify_and_prune(self.scene, state, c.densify)
                self._densify_acc = zero_densify_acc(self.scene.point_count, self.device)
                # The entry load changes with the points: check now, with
                # the watermark scaled by the growth.
                check_overflow = True
                watermark_scale = self.scene.point_count / max(old_count, 1)
            if self.step_count % c.opacity_reset_interval == 0:
                self.scene = reset_opacity(self.scene, c.densify)
        if check_overflow:
            total = int(int(self._entry_watermark) * watermark_scale)
            if total > c.capacity_grow_at * self._entry_capacity:
                b = c.render.block_size
                new_cap = int(total * c.capacity_grow_factor)
                self._entry_capacity = max((new_cap + b - 1) // b * b, self._entry_capacity)
            self._entry_watermark = torch.zeros((), dtype=torch.int32, device=self.device)
        return stats
