"""The 3DGS training loop: one differentiable step plus host-side density
control.

Counterpart of ``gausplat_tpu/train/trainer.py``. One step renders,
computes L1 + D-SSIM, takes the gradients of the five parameters and of
the densification ref by autograd, and applies the per-parameter Adam in
place. The densify statistics accumulate on the device; the host reads
them only at densify events, and reads the entry-count watermark only at
its cadence, so a step without a host event never waits for the device.

The step writes all of its state in place (the parameters, the Adam
moments and counts, the densify accumulators, the watermark), and copies
nothing from the host once its camera and target are on the device, so
on the card it is captured as a CUDA graph (:mod:`..utils.step_graph`)
and replayed: :meth:`Trainer.train_step` and :meth:`Trainer.train_step_batch`
(and so :meth:`Trainer.fit`) are one replay a call, as the JAX package's
jitted ``step`` and ``step_batch`` are one dispatch, and
:meth:`Trainer.fit_scan` replays its step for each step of a chunk between
host events, the counterpart of the JAX package's ``lax.scan`` chunks.
Each keeps a graph of its own, so alternating them recaptures nothing.
The host events stay on the host, after the replay. On a CPU scene the
same step bodies run eagerly; :meth:`Trainer._train_step_eager` and
:meth:`Trainer._train_step_batch_eager` are the steps launched op by op.

SH-degree warm-up raises ``colors_sh_degree_max`` every
``sh_warmup_interval`` steps. The JAX package recompiles its step there;
here the next render simply takes the new degree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import SH_DEGREE_MAX
from ..ops.projection import Camera
from ..render.pipeline import (
    RenderOptions,
    _capacity,
    _render_core,
    _use_kernels,
    _validate,
    scene_params,
)
from ..render.view import View
from ..render.views_graph import CAMERA_FLOATS, camera_at, pack_cameras, stacked_camera
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
from ..utils.step_graph import StepGraph


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
        # fit_scan's captured step and its device-side inputs.
        self._graph = StepGraph()
        self._scan = None
        # train_step's and train_step_batch's captured steps and inputs.
        self._step_graph, self._batch_graph = StepGraph(), StepGraph()
        self._one, self._batch = None, None

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

    def _prepare(self) -> None:
        """Fresh optimizer state and statistics after a reshape."""
        p = self.scene.point_count
        if self._opt_point_count != p:
            self._opt_state = seed_count(self._optimizer.init(self.scene), self.step_count)
            self._opt_point_count = p
            self._densify_acc = zero_densify_acc(p, self.device)

    def _ref(self) -> torch.Tensor:
        """The densification ref of one step."""
        return torch.zeros((self.scene.point_count,), dtype=torch.float32, device=self.device,
                           requires_grad=True)

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

    def _step(self, camera: Camera, target: torch.Tensor, width: int, height: int) -> dict:
        """One optimisation step of a ``width`` x ``height`` render from
        ``camera`` against ``target`` (both on the device), written in place
        into the scene, the optimizer state, the densify accumulators and
        the watermark. Returns the step's metrics as 0-d device tensors."""
        options = self._options()
        point_count = _validate(self.scene, width, height, options)
        ref = self._ref()
        out = _render_core(scene_params(self.scene), ref, camera, width, height,
                           _capacity(point_count, options), options,
                           _use_kernels(options, self.device))
        loss = photometric_loss(out.colors_rgb_2d, target, self.config.ssim_weight)
        grad_norm = self._apply_gradients(loss, ref)
        DensifyState(**self._densify_acc).accumulate(grad_norm, out.radii)
        torch.maximum(self._entry_watermark, out.tile_point_total, out=self._entry_watermark)
        return {
            "loss": loss.detach(),
            "psnr": psnr(out.colors_rgb_2d.detach(), target),
            "tile_point_total": out.tile_point_total,
        }

    def _step_info(self) -> dict:
        """Host facts added to each step's metrics, taken before the step
        (none here; a subclass may add some)."""
        return {}

    # -- public API ------------------------------------------------------------

    def train_step(self, view: View, target) -> dict:
        """One optimization step against one view.

        Returns metrics as 0-d device tensors: the step does not wait for
        the device. Convert with ``float()`` when a value is needed.

        On the card the step is one replay of its captured graph: the
        camera and the target are copied into static buffers, the graph
        replays (after a miss of its key, e.g. after a densify, one eager
        step on a side stream, then the capture), and the metrics are
        cloned out; then the host events run. On a CPU scene the same
        step runs eagerly.
        """
        self._prepare()
        info = self._step_info()
        one = self._one = _StepInputs.fill(self._one, [view], [target], self.device)
        self._step_graph.run(lambda: self._one_step(one), self._static_key("one", view),
                             self._step_tensors(one), 1)
        metrics = one.metrics()
        self.step_count += 1
        stats = self._host_events()
        return {**metrics, **info, **stats}

    def _train_step_eager(self, view: View, target) -> dict:
        """:meth:`train_step` launched op by op from the host."""
        self._prepare()
        info = self._step_info()
        metrics = self._step(Camera.from_view(view, device=self.device), self._target(target),
                             view.image_width, view.image_height)
        self.step_count += 1
        stats = self._host_events()
        return {**metrics, **info, **stats}

    def _one_step(self, one: "_StepInputs") -> None:
        """train_step's step on its static inputs."""
        one.write(self._step(camera_at(one.cameras, 0), one.targets[0], one.width, one.height))

    def train_step_batch(self, views, targets) -> dict:
        """One optimization step from the mean loss over a view batch (the
        views render one after another into one graph). The densify
        statistics match ``len(views)`` successive single-view steps;
        ``step_count`` advances by the batch size. As in the JAX package,
        no host event runs here. On the card one replay of its captured
        graph a call, as :meth:`train_step`."""
        views = list(views)
        self._prepare()
        batch = self._batch = _StepInputs.fill(self._batch, views, targets, self.device)
        self._batch_graph.run(lambda: self._batch_step(batch),
                              self._static_key("batch", views[0]),
                              self._step_tensors(batch), 1)
        self.step_count += len(views)
        return batch.metrics()

    def _train_step_batch_eager(self, views, targets) -> dict:
        """:meth:`train_step_batch` launched op by op from the host."""
        views = list(views)
        self._prepare()
        cameras = [Camera.from_view(v, device=self.device) for v in views]
        metrics = self._batch_body(cameras, [self._target(t) for t in targets],
                                   views[0].image_width, views[0].image_height)
        self.step_count += len(views)
        return metrics

    def _batch_step(self, batch: "_StepInputs") -> None:
        """train_step_batch's step on its static inputs."""
        cameras = [camera_at(batch.cameras, i) for i in range(batch.targets.shape[0])]
        batch.write(self._batch_body(cameras, list(batch.targets), batch.width, batch.height))

    def _batch_body(self, cameras, targets, width: int, height: int) -> dict:
        """One step from the mean loss over the views of ``cameras``
        against ``targets`` (on the device), written in place; returns the
        metrics as 0-d device tensors."""
        options = self._options()
        point_count = _validate(self.scene, width, height, options)
        capacity, use_kernels = _capacity(point_count, options), _use_kernels(options, self.device)
        params = scene_params(self.scene)
        ref = self._ref()
        outs = [_render_core(params, ref, camera, width, height, capacity, options, use_kernels)
                for camera in cameras]
        losses = [
            photometric_loss(o.colors_rgb_2d, t, self.config.ssim_weight)
            for o, t in zip(outs, targets)
        ]
        loss = torch.mean(torch.stack(losses))
        grad_norm = self._apply_gradients(loss, ref)
        n = len(cameras)
        radii = torch.stack([o.radii for o in outs])
        acc = self._densify_acc
        # The shared ref's gradient sums the per-view norms of the mean
        # loss's gradients; times V it equals V single-view steps.
        acc["grad_norm_sum"].add_(grad_norm * n)
        acc["visible_count"].add_((radii > 0).sum(0, dtype=torch.int32))
        torch.maximum(acc["max_radii"], radii.amax(0), out=acc["max_radii"])
        return {
            "loss": loss.detach(),
            "psnr": psnr(torch.stack([o.colors_rgb_2d.detach() for o in outs]),
                         torch.stack(targets)),
            "tile_point_total": torch.stack([o.tile_point_total for o in outs]).amax(),
        }

    def fit(self, views, targets, iterations: Optional[int] = None) -> list:
        """Round-robin fit over (views, targets). Returns the metric
        history as host floats, read once at the end."""
        return self._fit(self.train_step, views, targets, iterations)

    def _fit_eager(self, views, targets, iterations: Optional[int] = None) -> list:
        """:meth:`fit` through :meth:`_train_step_eager`."""
        return self._fit(self._train_step_eager, views, targets, iterations)

    def _fit(self, train_step, views, targets, iterations: Optional[int]) -> list:
        iterations = iterations or self.config.iterations
        history = []
        n = len(views)
        for _ in range(iterations):
            # By the global step, so a resumed trainer replays the sequence.
            j = self.step_count % n
            history.append(train_step(views[j], targets[j]))
        return [
            {k: (float(v) if isinstance(v, torch.Tensor) and v.dim() == 0 else v)
             for k, v in h.items()}
            for h in history
        ]

    def fit_scan(self, views, targets, iterations: Optional[int] = None,
                 max_chunk: int = 200) -> list:
        """Like :meth:`fit`, in chunks of at most ``max_chunk`` steps that
        break at every host event, so the result follows the schedule of
        per-step :meth:`fit`; returns one ``{loss, psnr, tile_point_total}``
        per step, read from the device once at the end.

        The views (all of the trainer's size) are stacked once and the
        step picks view ``step % V`` on the device. On a CUDA scene each
        chunk replays one captured step (:class:`..utils.step_graph.StepGraph`),
        recaptured after a host event that replaces the step's tensors; on
        a CPU scene the same step runs eagerly, step by step.
        """
        iterations = iterations or self.config.iterations
        end = self.step_count + iterations
        scan = self._scan_inputs(views, targets, max_chunk)
        chunks = []
        while self.step_count < end:
            self._prepare()
            k = min(next_host_event(self.config, self.step_count, end) - self.step_count,
                    max_chunk)
            info = self._step_info()
            scan.step.fill_(self.step_count)
            scan.slot.zero_()
            self._graph.run(lambda: self._scan_step(scan), self._static_key(),
                            self._step_tensors(scan), k)
            chunks.append((scan.values[:k].clone(), scan.totals[:k].clone(), info))
            self.step_count += k
            self._host_events()
        values = torch.cat([c[0] for c in chunks]).tolist()
        totals = torch.cat([c[1] for c in chunks]).tolist()
        infos = [c[2] for c in chunks for _ in range(c[0].shape[0])]
        return [{"loss": loss, "psnr": p, "tile_point_total": float(total), **info}
                for (loss, p), total, info in zip(values, totals, infos)]

    def _scan_inputs(self, views, targets, max_chunk: int) -> "_ScanInputs":
        """fit_scan's device-side inputs, written into the last call's
        tensors where the shapes allow, so the captured step survives."""
        from ..parallel.render import stack_cameras

        views = list(views)
        for v in views:
            if (v.image_width, v.image_height) != (self.image_width, self.image_height):
                raise ValueError(f"fit_scan renders {self.image_width}x{self.image_height}; "
                                 f"a view is {v.image_width}x{v.image_height}")
        cameras = stack_cameras(views, device=self.device)
        stacked = torch.stack([self._target(t) for t in targets])
        scan = self._scan
        if scan is None or scan.targets.shape != stacked.shape or scan.values.shape[0] != max_chunk:
            scan = self._scan = _ScanInputs(cameras, stacked, max_chunk)
        else:
            for f in _CAMERA_FIELDS:
                getattr(scan.cameras, f).copy_(getattr(cameras, f))
            scan.targets.copy_(stacked)
        return scan

    def _scan_step(self, scan: "_ScanInputs") -> None:
        """The step of fit_scan: view ``scan.step % V``, its metrics into
        row ``scan.slot``, both counters advanced, all on the device."""
        index = torch.remainder(scan.step, scan.targets.shape[0]).view(1)
        camera = Camera(**{f: getattr(scan.cameras, f).index_select(0, index)[0]
                           for f in _CAMERA_FIELDS})
        target = scan.targets.index_select(0, index)[0]
        m = self._step(camera, target, self.image_width, self.image_height)
        slot = scan.slot.view(1)
        scan.values.index_copy_(0, slot, torch.stack([m["loss"], m["psnr"]])[None])
        scan.totals.index_copy_(0, slot, m["tile_point_total"].view(1))
        scan.step.add_(1)
        scan.slot.add_(1)

    def _static_key(self, kind: str = "scan", view: Optional[View] = None) -> tuple:
        """What shapes a step besides its tensors: which step, its options
        and loss weight, and the size it renders."""
        size = ((self.image_width, self.image_height) if view is None
                else (view.image_width, view.image_height))
        return (kind, self._options(), self.config.ssim_weight, *size)

    def _step_tensors(self, inputs) -> list:
        """Every tensor a step reads or writes and keeps: the scene, the
        optimizer state, the densify accumulators, the watermark and the
        step's own inputs and outputs (``inputs.tensors()``)."""
        adam = [t for f in FIELDS for t in self._opt_state["adam"][f]]
        return [*scene_params(self.scene), *adam, self._opt_state["count"],
                *self._densify_acc.values(), self._entry_watermark, *inputs.tensors()]

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
            self._entry_watermark.zero_()
        return stats


#: The fields of a stacked camera that fit_scan picks from.
_CAMERA_FIELDS = ("focal_length", "image_size_half", "view_bound", "view_position",
                  "view_rotation", "view_translation")


class _ScanInputs:
    """fit_scan's inputs on the device, at addresses that persist from call
    to call: the stacked cameras and targets ``[V, ...]``, the global step
    that picks the view, the chunk's slot, and the metrics buffers
    (``values`` ``[max_chunk, 2]``: loss and PSNR; ``totals``
    ``[max_chunk]``: the entry totals)."""

    def __init__(self, cameras: Camera, targets: torch.Tensor, max_chunk: int):
        device = targets.device
        self.cameras = cameras
        self.targets = targets
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.values = torch.zeros((max_chunk, 2), dtype=torch.float32, device=device)
        self.totals = torch.zeros((max_chunk,), dtype=torch.int32, device=device)

    def tensors(self) -> list:
        return [*(getattr(self.cameras, f) for f in _CAMERA_FIELDS), self.targets, self.step,
                self.slot, self.values, self.totals]


class _StepInputs:
    """The static inputs and outputs of ``train_step`` (one view) or
    ``train_step_batch`` (V views) on the device, kept from call to call
    while the shapes hold, so the captured step survives: the packed
    cameras ``rows`` ``[V, 21]`` (``cameras``: their stacked view), the
    targets ``[V, H, W, 3]`` and the 0-d metrics (loss, PSNR, entry
    total)."""

    def __init__(self, count: int, width: int, height: int, device):
        self.width, self.height = width, height
        self.rows = torch.empty((count, CAMERA_FLOATS), dtype=torch.float32, device=device)
        self.cameras = stacked_camera(self.rows)
        self.targets = torch.empty((count, height, width, 3), dtype=torch.float32,
                                   device=device)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.psnr = torch.zeros((), dtype=torch.float32, device=device)
        self.total = torch.zeros((), dtype=torch.int32, device=device)

    @classmethod
    def fill(cls, inputs: Optional["_StepInputs"], views, targets, device) -> "_StepInputs":
        """``inputs`` (made anew on ``device`` where None or of other
        shapes) holding the views' cameras and the ``targets`` (arrays or
        tensors on any device)."""
        width, height = views[0].image_width, views[0].image_height
        if inputs is None or (inputs.rows.shape[0], inputs.width, inputs.height) != (
                len(views), width, height):
            inputs = cls(len(views), width, height, device)
        inputs.rows.copy_(torch.from_numpy(pack_cameras(views)), non_blocking=True)
        for dst, src in zip(inputs.targets, targets):
            dst.copy_(torch.as_tensor(src, dtype=torch.float32))
        return inputs

    def write(self, metrics: dict) -> None:
        """Copy a step's metrics (0-d tensors) into the static outputs."""
        self.loss.copy_(metrics["loss"])
        self.psnr.copy_(metrics["psnr"])
        self.total.copy_(metrics["tile_point_total"])

    def metrics(self) -> dict:
        """The step's metrics, cloned out of the static outputs."""
        return {"loss": self.loss.clone(), "psnr": self.psnr.clone(),
                "tile_point_total": self.total.clone()}

    def tensors(self) -> list:
        return [self.rows, self.targets, self.loss, self.psnr, self.total]
