"""The sharded training step: data parallelism by tile sharding on a mesh.

Counterpart of ``gausplat_tpu/parallel/train_step.py``. One step over a
2-D mesh ``(data, tiles)``, run by every rank on the same scene, views and
targets:

- the scene and the Adam state are replicated: every rank applies the same
  update;
- the views are split over ``data`` (each rank trains on ``V / D_data`` of
  them) and each view's frame over ``tiles`` by rows (the slab's camera
  shifted by its first row, as in :func:`.render.render_tile_sharded`);
- the objective is L1 + D-SSIM; the 11x11 SSIM window needs 5 rows past
  each slab's edge, which neighbouring slabs exchange
  (:func:`._collectives.halo_extend`; zeros at the frame's borders, as the
  single device's SAME padding gives);
- rows past the image's height (the last slab's padding) are masked out of
  both terms, so a height that does not split evenly trains as one device;
- the gradients are all-reduced over both axes before the update;
- the densify statistics accumulate as the single-device ``Trainer``'s do,
  and the step returns the entry total's high-water mark over views and
  slabs, so the host can grow the per-slab capacity at its own cadence.

The step copies nothing from the host once its cameras and targets are on
the device, and writes its state in place, so on a mesh over NCCL each
rank captures it as a CUDA graph with its NCCL collectives inside
(:class:`..utils.step_graph.StepGraph`): :meth:`ShardedTrainer.train_step`
(and so :meth:`ShardedTrainer.fit`) is one replay a call, as the JAX
package's jitted ``shard_map`` step is one dispatch, and
:meth:`ShardedTrainer.fit_scan` replays it for each step of a chunk
between host events, the counterpart of the JAX package's ``lax.scan``
chunks of the shard_map'd step. Each keeps a graph of its own. On gloo
the same steps run eagerly; :meth:`ShardedTrainer._train_step_eager` is
the step launched op by op.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import SH_DEGREE_MAX
from ..ops.projection import Camera
from ..render.pipeline import RenderOptions, _capacity, _render_core, _use_kernels
from ..scene.gaussian_3d import PARAM_DIMS, GaussianScene
from ..train.densify import DensifyState, densify_and_prune, reset_opacity, zero_densify_acc
from ..train.losses import ssim_map
from ..train.optimizer import OptimizerConfig, make_optimizer, seed_count
from ..train.trainer import _CAMERA_FIELDS, TrainConfig, next_host_event
from ..utils.step_graph import StepGraph
from ._collectives import MAX, all_reduce, all_reduce_each, any_rank, halo_extend
from .mesh import Mesh
from .render import _shard_capacity, camera_at, camera_count, slab_rows

#: Rows of cross-slab context the 11x11 SSIM window needs.
_HALO = 5

FIELDS = tuple(PARAM_DIMS)


class ShardedStep:
    """One sharded step, built by :func:`make_sharded_train_step`; call it
    as ``step(scene, opt_state, densify_acc, cameras, targets)``."""

    def __init__(self, mesh: Mesh, image_width: int, image_height: int, point_count: int,
                 options: RenderOptions, optimizer, data_axis: str, tile_axis: str,
                 ssim_weight: float):
        self.mesh, self.optimizer, self.options = mesh, optimizer, options
        self.width, self.height, self.point_count = image_width, image_height, point_count
        self.data_axis, self.tile_axis, self.ssim_weight = data_axis, tile_axis, ssim_weight
        self.h_local, self.h_pad = slab_rows(image_height, mesh.shape[tile_axis])
        self.capacity = _shard_capacity(_capacity(point_count, options),
                                        mesh.shape[tile_axis], options.block_size)
        self._constants = {}

    def constants(self, device) -> tuple:
        """``(shift [2], row_valid [1, h_local, 1, 1], half [2])`` on
        ``device``, made there once: the slab's screen shift, its rows that
        exist in the true image (the slab padding off) as 1.0 / 0.0, and
        the whole frame's half-size for the densification norm."""
        device = torch.device(device)
        if device not in self._constants:
            y0 = self.mesh.coords[self.tile_axis] * self.h_local
            rows = torch.arange(self.h_local, device=device)
            self._constants[device] = (
                torch.tensor([0.0, float(y0)], device=device),
                (y0 + rows < self.height).to(torch.float32)[None, :, None, None],
                torch.tensor([self.width / 2.0, self.height / 2.0], dtype=torch.float32,
                             device=device),
            )
        return self._constants[device]

    def loss_and_grads(self, scene: GaussianScene, cameras, targets) -> dict:
        """The step without its update: ``loss`` (the whole batch's), the
        five parameters' gradients ``grads`` summed over both axes,
        ``grad_norm`` (each point's densification norm summed over the
        views), ``radii`` ``[V_local, P]`` (maxed over the slabs) and
        ``max_total`` (the entry total's max over views and slabs), all
        the same on every rank."""
        mesh, h_local, ssim_weight = self.mesh, self.h_local, self.ssim_weight
        d_tiles, d_data = mesh.shape[self.tile_axis], mesh.shape[self.data_axis]
        tiles, data = mesh.groups[self.tile_axis], mesh.groups[self.data_axis]
        device = scene.device
        y0 = mesh.coords[self.tile_axis] * h_local
        if camera_count(cameras) % d_data:
            raise ValueError(f"{camera_count(cameras)} views do not split over {d_data} ranks")
        v_local = camera_count(cameras) // d_data
        first = mesh.coords[self.data_axis] * v_local
        shift, row_valid, half = self.constants(device)
        # A no-op for targets already on the device (ShardedTrainer.pad_targets).
        tgt = torch.as_tensor(targets, dtype=torch.float32, device=device)
        tgt = tgt[first:first + v_local, y0:y0 + h_local] * row_valid

        params = [getattr(scene, f) for f in FIELDS]
        ref = torch.zeros((self.point_count,), dtype=torch.float32, device=device,
                          requires_grad=True)
        use_kernels = _use_kernels(self.options, device)
        outs = [
            _render_core(params, ref, camera_at(cameras, first + i, shift), self.width,
                         h_local, self.capacity, self.options, use_kernels,
                         grad_norm_half=half, sum_over_tiles=lambda x: all_reduce(x, tiles))
            for i in range(v_local)
        ]
        rendered = torch.stack([o.colors_rgb_2d for o in outs]) * row_valid
        l1_sum = torch.sum(torch.abs(rendered - tgt))
        ssim_sum = torch.zeros((), device=device)
        if ssim_weight != 0.0:
            ext_r = halo_extend(rendered, tiles, _HALO)
            ext_t = halo_extend(tgt, tiles, _HALO)
            smap = torch.stack([ssim_map(a, b) for a, b in zip(ext_r, ext_t)])
            ssim_sum = torch.sum(smap[:, _HALO:_HALO + h_local] * row_valid)
        # Pixel sums become whole-frame means only summed over the ranks;
        # the normalisation is folded in so the gradient is of the true loss.
        scale = 1.0 / (float(self.height * self.width * 3) * v_local * d_data)
        local_loss = (1.0 - ssim_weight) * l1_sum * scale + ssim_weight * (
            1.0 / (d_tiles * d_data)  # each rank's share of the constant 1
            - ssim_sum * scale
        )
        *grads, grad_norm = torch.autograd.grad(local_loss, params + [ref],
                                                materialize_grads=True)
        # Over both axes, as one all-reduce of the mesh's group.
        *grads, loss = all_reduce_each(grads + [local_loss.detach()], mesh.group)
        max_total = torch.stack([o.tile_point_total for o in outs]).amax()
        # The ref's gradient is each local view's whole-frame norm (the
        # render core summed the position gradients over the slabs), so it
        # sums over the data axis alone. A point's radius in a view is the
        # max over the slabs.
        return dict(loss=loss, grads=dict(zip(FIELDS, grads)),
                    grad_norm=all_reduce(grad_norm, data),
                    radii=all_reduce(torch.stack([o.radii for o in outs]), tiles, MAX),
                    max_total=all_reduce(max_total, mesh.group, MAX))

    def __call__(self, scene: GaussianScene, opt_state, densify_acc, cameras, targets):
        data = self.mesh.groups[self.data_axis]
        r = self.loss_and_grads(scene, cameras, targets)
        updates, opt_state = self.optimizer.update(r["grads"], opt_state)
        with torch.no_grad():
            for f in FIELDS:
                getattr(scene, f).add_(updates[f])
        # A point is visible in a view where any slab saw it.
        radii = r["radii"]
        visible = all_reduce((radii > 0).sum(0, dtype=torch.int32), data)
        max_radii = all_reduce(radii.amax(0), data, MAX)
        densify_acc["grad_norm_sum"].add_(r["grad_norm"])
        densify_acc["visible_count"].add_(visible)
        torch.maximum(densify_acc["max_radii"], max_radii, out=densify_acc["max_radii"])
        return scene, opt_state, densify_acc, {"loss": r["loss"],
                                               "tile_point_total": r["max_total"]}


def make_sharded_train_step(
    mesh: Mesh,
    image_width: int,
    image_height: int,
    point_count: int,
    options: RenderOptions = RenderOptions(),
    optimizer_config: OptimizerConfig = OptimizerConfig(),
    data_axis: str = "data",
    tile_axis: str = "tiles",
    ssim_weight: float = 0.2,
):
    """Build ``(step, optimizer, h_pad)``. ``step(scene, opt_state,
    densify_acc, cameras, targets) -> (scene, opt_state, densify_acc,
    metrics)``, with ``cameras`` a stacked :class:`Camera` ``[V, ...]``
    (``stack_cameras``; V a multiple of the data axis' size) and
    ``targets`` ``[V, h_pad, W, 3]`` (rows padded to whole slabs; the pad
    rows' values are ignored), the same on every rank. The scene's
    parameters, the optimizer state and ``densify_acc`` are updated in
    place and returned. ``metrics``: ``{"loss", "tile_point_total"}`` as
    0-d tensors. ``densify_acc`` accumulates as the single-device
    ``Trainer``'s, summed over the views.
    ``step.loss_and_grads`` is the step without its update
    (:meth:`ShardedStep.loss_and_grads`).
    """
    step = ShardedStep(mesh, image_width, image_height, point_count, options,
                       make_optimizer(optimizer_config), data_axis, tile_axis, ssim_weight)
    return step, step.optimizer, step.h_pad


class ShardedTrainer:
    """Host-side orchestration of the sharded step and density control:
    the mesh's counterpart of :class:`gausplat_tpu_torch.train.Trainer`.

    Every rank runs it on the same scene, views and targets, and takes the
    same host decisions on statistics that the collectives made identical
    bit for bit, so a densify event reshapes every rank's replicated scene
    alike (``densify_and_prune`` draws from ``default_rng(seed + P)``). The
    optimizer state starts afresh when the point count changes; the
    overflow watermark is read at ``overflow_check_interval``.
    """

    def __init__(
        self,
        scene: GaussianScene,
        mesh: Mesh,
        image_width: int,
        image_height: int,
        config=None,
        data_axis: str = "data",
        tile_axis: str = "tiles",
    ):
        self.scene = scene
        self.mesh = mesh
        self.config = config if config is not None else TrainConfig()
        self.image_width = image_width
        self.image_height = image_height
        self.data_axis = data_axis
        self.tile_axis = tile_axis
        self.step_count = 0
        self.device = scene.device
        self._densify_acc = zero_densify_acc(scene.point_count, self.device)
        self._opt_state = None
        self._opt_point_count = -1
        self._entry_capacity = _capacity(scene.point_count, self.config.render)
        # Running on-device max of tile_point_total since the last check.
        self._entry_watermark = torch.zeros((), dtype=torch.int32, device=self.device)
        self.h_pad = slab_rows(image_height, mesh.shape[tile_axis])[1]
        # The step of the current options and point count, kept so that its
        # device constants and its optimizer's keep their addresses.
        self._step, self._step_key = None, None
        # fit_scan's captured step and its device-side inputs; train_step's.
        self._graph = StepGraph()
        self._scan = None
        self._step_graph = StepGraph()
        self._one = None

    def _sh_degree(self) -> int:
        """SH warm-up schedule, as ``Trainer._sh_degree``."""
        warm = self.step_count // max(self.config.sh_warmup_interval, 1)
        return min(min(warm, SH_DEGREE_MAX), self.config.render.colors_sh_degree_max)

    def _options(self) -> RenderOptions:
        return dataclasses.replace(
            self.config.render,
            tile_entry_capacity=self._entry_capacity,
            colors_sh_degree_max=self._sh_degree(),
        )

    def _get_step(self) -> ShardedStep:
        c = self.config
        key = (self._options(), self.scene.point_count, c.optimizer, c.ssim_weight)
        if key != self._step_key:
            self._step, _, _ = make_sharded_train_step(
                self.mesh, self.image_width, self.image_height, self.scene.point_count,
                key[0], c.optimizer, self.data_axis, self.tile_axis, c.ssim_weight,
            )
            self._step_key = key
        return self._step

    def _prepare(self) -> ShardedStep:
        """The step at ``step_count``, with a fresh optimizer state and
        statistics after a reshape."""
        step = self._get_step()
        if self._opt_point_count != self.scene.point_count:
            self._opt_state = seed_count(step.optimizer.init(self.scene), self.step_count)
            self._opt_point_count = self.scene.point_count
            self._densify_acc = zero_densify_acc(self.scene.point_count, self.device)
        return step

    def pad_targets(self, targets) -> torch.Tensor:
        """``[V, H, W, 3]`` -> ``[V, h_pad, W, 3]`` on the scene's device
        (zero rows; their values are ignored)."""
        t = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, self.h_pad - t.shape[1]))

    def train_step(self, cameras, targets_padded) -> dict:
        """One optimisation step on the view batch. Returns the metrics as
        0-d tensors (no wait for the device), with the densify stats where
        a densify ran.

        On a mesh over NCCL the step is one replay of its graph on each
        rank: the cameras and the padded targets are copied into static
        buffers (a caller's loop may pass other ones each call), the ranks
        decide a miss of the key together (a max over the mesh, as
        :meth:`fit_scan` does; after a miss every rank steps eagerly on a
        side stream, then captures), the graph replays and the metrics
        are cloned out; then the host events run. On gloo the same step
        runs eagerly."""
        step = self._prepare()
        one = self._one = self._static_inputs(self._one, cameras, targets_padded, 1)
        self._step_graph.run(lambda: self._one_step(step, one), self._static_key(),
                             self._step_tensors(step, one), 1,
                             capture=self.mesh.backend == "nccl", any_miss=self._any_rank_missed)
        metrics = {"loss": one.losses[0].clone(), "tile_point_total": one.totals[0].clone()}
        self.step_count += 1
        stats = self._host_events()
        return {**metrics, **stats} if stats else metrics

    def _train_step_eager(self, cameras, targets_padded) -> dict:
        """:meth:`train_step` launched op by op from the host."""
        step = self._prepare()
        _, _, _, metrics = step(self.scene, self._opt_state, self._densify_acc, cameras,
                                targets_padded)
        self.step_count += 1
        torch.maximum(self._entry_watermark, metrics["tile_point_total"],
                      out=self._entry_watermark)
        stats = self._host_events()
        return {**metrics, **stats} if stats else metrics

    def _host_events(self) -> dict:
        """Densify, opacity reset and the overflow watch at ``step_count``,
        on ``Trainer._host_events``' schedule."""
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
                # Check the capacity now, with the watermark scaled by the growth.
                check_overflow = True
                watermark_scale = self.scene.point_count / max(old_count, 1)
            if self.step_count % c.opacity_reset_interval == 0:
                self.scene = reset_opacity(self.scene, c.densify)
        if check_overflow:
            # The per-slab capacity is the global one over d_tiles, so the
            # slab watermark times d_tiles is held to the global budget.
            total = int(int(self._entry_watermark) * self.mesh.shape[self.tile_axis]
                        * watermark_scale)
            if total > c.capacity_grow_at * self._entry_capacity:
                b = c.render.block_size
                new_cap = int(total * c.capacity_grow_factor)
                self._entry_capacity = max((new_cap + b - 1) // b * b, self._entry_capacity)
            self._entry_watermark.zero_()
        return stats

    def fit(self, cameras, targets, iterations: int) -> list:
        """``iterations`` steps on the fixed view batch; the metric history
        as host floats, read once at the end."""
        return self._fit(self.train_step, cameras, targets, iterations)

    def _fit_eager(self, cameras, targets, iterations: int) -> list:
        """:meth:`fit` through :meth:`_train_step_eager`."""
        return self._fit(self._train_step_eager, cameras, targets, iterations)

    def _fit(self, train_step, cameras, targets, iterations: int) -> list:
        padded = self.pad_targets(targets)
        history = [train_step(cameras, padded) for _ in range(iterations)]
        return [{k: (float(v) if isinstance(v, torch.Tensor) and v.dim() == 0 else v)
                 for k, v in h.items()} for h in history]

    def fit_scan(self, cameras, targets, iterations: int, max_chunk: int = 100) -> list:
        """Like :meth:`fit`, in chunks of at most ``max_chunk`` steps that
        break at every host event (``next_host_event``), so the result
        follows the schedule of per-step :meth:`fit`; returns one
        ``{loss, tile_point_total}`` per step, read from the device once at
        the end.

        On a mesh over NCCL each chunk replays the step captured as one
        CUDA graph on each rank, its collectives inside
        (:class:`..utils.step_graph.StepGraph`), recaptured by every rank
        together after a host event that replaces the step's tensors; an
        error in capture or replay raises. gloo cannot be captured (it
        copies CUDA tensors through the host), so on a mesh over gloo (CPU
        ranks, or ranks that share one card) the same step runs eagerly,
        step by step, on the same schedule, and gives :meth:`fit`'s
        answers.
        """
        end = self.step_count + iterations
        scan = self._scan = self._static_inputs(self._scan, cameras, self.pad_targets(targets),
                                                max_chunk)
        capture = self.mesh.backend == "nccl"
        chunks = []
        while self.step_count < end:
            step = self._prepare()
            k = min(next_host_event(self.config, self.step_count, end) - self.step_count,
                    max_chunk)
            scan.slot.zero_()
            self._graph.run(lambda: self._scan_step(step, scan), self._static_key(),
                            self._step_tensors(step, scan), k, capture=capture,
                            any_miss=self._any_rank_missed)
            chunks.append((scan.losses[:k].clone(), scan.totals[:k].clone()))
            self.step_count += k
            self._host_events()
        losses = torch.cat([c[0] for c in chunks]).tolist()
        totals = torch.cat([c[1] for c in chunks]).tolist()
        return [{"loss": loss, "tile_point_total": float(total)}
                for loss, total in zip(losses, totals)]

    def _static_inputs(self, scan, cameras, padded: torch.Tensor,
                       max_chunk: int) -> "_ScanInputs":
        """A step's device-side inputs: ``cameras`` and ``padded`` written
        into ``scan``'s tensors where the shapes allow, so the captured
        step survives, else into new ones."""
        if (scan is None or scan.targets.shape != padded.shape
                or scan.cameras.focal_length.shape != cameras.focal_length.shape
                or scan.losses.shape[0] != max_chunk):
            cameras = Camera(**{f: getattr(cameras, f).to(self.device, copy=True)
                                for f in _CAMERA_FIELDS})
            return _ScanInputs(cameras, padded.clone(), max_chunk)
        for f in _CAMERA_FIELDS:
            getattr(scan.cameras, f).copy_(getattr(cameras, f))
        scan.targets.copy_(padded)
        return scan

    def _one_step(self, step: ShardedStep, one: "_ScanInputs") -> None:
        """The step of train_step: the whole view batch, its metrics into
        row 0 of ``one``'s buffers, the watermark advanced, on the device."""
        _, _, _, m = step(self.scene, self._opt_state, self._densify_acc, one.cameras,
                          one.targets)
        torch.maximum(self._entry_watermark, m["tile_point_total"], out=self._entry_watermark)
        one.losses.copy_(m["loss"].view(1))
        one.totals.copy_(m["tile_point_total"].view(1))

    def _scan_step(self, step: ShardedStep, scan: "_ScanInputs") -> None:
        """The step of fit_scan: the whole view batch, its metrics into row
        ``scan.slot``, the watermark and the slot advanced, on the device."""
        _, _, _, m = step(self.scene, self._opt_state, self._densify_acc, scan.cameras,
                          scan.targets)
        torch.maximum(self._entry_watermark, m["tile_point_total"], out=self._entry_watermark)
        slot = scan.slot.view(1)
        scan.losses.index_copy_(0, slot, m["loss"].view(1))
        scan.totals.index_copy_(0, slot, m["tile_point_total"].view(1))
        scan.slot.add_(1)

    def _static_key(self) -> tuple:
        """What shapes the step besides its tensors: the mesh, the options
        (the capacity and the SH degree among them), the optimizer's
        settings, the loss's weight and the sizes."""
        mesh, c = self.mesh, self.config
        return (mesh.axis_names, tuple(mesh.shape.items()), tuple(mesh.coords.items()),
                self._options(), c.optimizer, c.ssim_weight, self.image_width,
                self.image_height, self.scene.point_count, self.data_axis, self.tile_axis)

    def _step_tensors(self, step: ShardedStep, scan: "_ScanInputs") -> list:
        """Every tensor the step reads or writes and keeps."""
        adam = [t for f in FIELDS for t in self._opt_state["adam"][f]]
        return [*(getattr(self.scene, f) for f in FIELDS), *adam, self._opt_state["count"],
                *self._densify_acc.values(), self._entry_watermark, *scan.tensors(),
                *step.constants(self.device)]

    def _any_rank_missed(self, missed: bool) -> bool:
        """Whether any rank of the mesh missed its graph's key: the ranks
        then recapture together (a max over the mesh's group)."""
        return any_rank(missed, self.mesh.group, self.device)


class _ScanInputs:
    """fit_scan's (or, with one row, train_step's) inputs on the device, at
    addresses that persist from call to call: the stacked cameras and the
    padded targets ``[V, ...]``, the chunk's slot, and the metrics buffers
    (``losses`` and ``totals`` ``[max_chunk]``)."""

    def __init__(self, cameras: Camera, targets: torch.Tensor, max_chunk: int):
        device = targets.device
        self.cameras = cameras
        self.targets = targets
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = torch.zeros((max_chunk,), dtype=torch.float32, device=device)
        self.totals = torch.zeros((max_chunk,), dtype=torch.int32, device=device)

    def tensors(self) -> list:
        return [*(getattr(self.cameras, f) for f in _CAMERA_FIELDS), self.targets, self.slot,
                self.losses, self.totals]
