"""The render pipeline, differentiable.

Counterpart of ``gausplat_tpu/render/pipeline.py``. Reference
orchestration and validation: .../render/gaussian_3d/jit/mod.rs:32-331;
autodiff bridge (the custom backward op and the
``positions_2d_grad_norm`` side channel):
src/scene/gaussian_3d/mod.rs:85-324.

One render runs: project -> bin (expand, sort, segment) -> rasterize
forward -> untile. On CUDA tensors the expansion and both rasterizers are
the hand-written kernels of :mod:`gausplat_tpu_torch.ops.expand` and
:mod:`gausplat_tpu_torch.ops.rasterize`; the rest is PyTorch operators.

The gradient: :class:`RasterizeFunction` is a ``torch.autograd.Function``
over the per-point rows ``[9, P + 1]`` and ``positions_2d_grad_norm_ref``
``[P]``, with the binning saved as non-differentiable state. Its backward
tiles the image cotangent, runs the backward rasterizer, reduces the
per-entry gradients per point (:func:`reduce_entry_grads`) and gives the
reference's densification signal as the gradient of the ref. Autograd
carries the rest: the sigmoid of the opacities and the projection, whose
VJP the JAX package takes with ``jax.vjp``.

``RenderOptions(entry_dtype="bf16")`` packs the rows into the bf16-pair
layout (``ops/blend.py``) inside the forward, which rasterizes and saves
the packed rows; the backward's per-entry rows come packed too and are
decoded in the reduce. The gradient of the f32 rows is the per-point sum
straight through the rounding, as the JAX package's custom VJP gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..constants import (
    PIXEL_COUNT_MAX,
    SH_DEGREE_MAX,
    TILE_POINT_EXPANSION,
    TILE_SIZE_X,
    TILE_SIZE_Y,
)
from ..errors import (
    InvalidPixelCountError,
    MismatchedPointCountError,
    UnsupportedSphericalHarmonicsDegreeError,
)
from ..ops.binning import bin_gaussians, make_point_orders
from ..ops.blend import decode_rows, grad_rows_to_components, pack_rows
from ..ops.expand import fused_point_orders
from ..ops.projection import Camera, project_gaussians
from ..ops.rasterize import (
    DEFAULT_BLOCK_SIZE,
    pack_point_data,
    rasterize_backward,
    rasterize_backward_torch,
    rasterize_forward,
    rasterize_forward_torch,
    tile_image,
    untile_image,
    untile_map,
)
from ..scene.gaussian_3d import PARAM_DIMS, GaussianScene
from ..utils.profiling import stage
from .view import View
from .grad_graph import grad_graph
from .views_graph import (
    camera_at, capturing, needs_grad, output_specs, pack_cameras, runs_eagerly, views_graph,
)

BACKENDS = ("cuda", "torch", "auto")


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Rendering options (the reference's Gaussian3dRenderOptions plus the
    fixed-capacity entry buffer)."""

    #: Max SH degree used for color (reference mod.rs:46-52).
    colors_sh_degree_max: int = SH_DEGREE_MAX
    #: Capacity of the (tile, point) entry buffer. ``None`` derives
    #: ``point_count * TILE_POINT_EXPANSION`` (at least 2^16).
    tile_entry_capacity: Optional[int] = None
    #: Entries per window of the plain rasterizer (and the capacity's
    #: rounding unit).
    block_size: int = DEFAULT_BLOCK_SIZE
    #: 'cuda' (the hand-written kernels; CUDA tensors only), 'torch' (the
    #: plain versions on any device) or 'auto' (the kernels for CUDA
    #: tensors, the plain versions for CPU tensors).
    backend: str = "auto"
    #: Per-entry data precision: 'f32', or 'bf16' (packed bf16-pair rows:
    #: colour, conic and opacity in bf16, positions in f32).
    entry_dtype: str = "f32"
    #: Shrink each point's touched-tile AABB to its blendable ellipse
    #: (see ops.projection.project_gaussians). Off = the reference's AABB.
    tight_culling: bool = True


class RenderOutput(NamedTuple):
    """Forward render results."""

    colors_rgb_2d: torch.Tensor  # [H, W, 3]
    radii: torch.Tensor  # [P] int32 (0 = culled)
    tile_point_total: torch.Tensor  # [] int32 true entry count (overflow check)
    transmittances: torch.Tensor  # [H, W] final per-pixel transmittance
    point_rendered_counts: torch.Tensor  # [H, W] int32


def _capacity(point_count: int, options: RenderOptions) -> int:
    if options.tile_entry_capacity is not None:
        cap = int(options.tile_entry_capacity)
    else:
        cap = point_count * TILE_POINT_EXPANSION
    cap = max(cap, 1 << 16)
    # A multiple of the block size, as the JAX package rounds it.
    b = options.block_size
    return (cap + b - 1) // b * b


def _use_kernels(options: RenderOptions, device: torch.device) -> bool:
    """Whether the render goes through the hand-written kernels."""
    if options.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {options.backend!r}")
    if options.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA device, got {device}")
    return options.backend != "torch" and device.type == "cuda"


def _validate(scene: GaussianScene, width: int, height: int,
              options: RenderOptions) -> int:
    point_count = scene.point_count
    pixel_count = width * height
    if options.colors_sh_degree_max > SH_DEGREE_MAX:
        raise UnsupportedSphericalHarmonicsDegreeError(options.colors_sh_degree_max)
    if options.entry_dtype not in ("f32", "bf16"):
        raise ValueError(
            f"entry_dtype must be 'f32' or 'bf16', got {options.entry_dtype!r}"
        )
    if pixel_count == 0 or pixel_count > PIXEL_COUNT_MAX:
        raise InvalidPixelCountError(pixel_count)
    if point_count == 0:
        raise MismatchedPointCountError(0, "non-zero")
    return point_count


def _scene_device(scene: GaussianScene, device) -> torch.device:
    if device is None:
        return scene.device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if scene.device != device:
        raise ValueError(f"the scene is on {scene.device}, not on {device}")
    return device


def _prefix_sum_f64(x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Inclusive float64 prefix sum along the last axis of ``[R, n]``, as a
    scan inside chunks of ``chunk`` plus a scan of the chunk totals: the
    same sums in a fixed order, with ``R * n / chunk`` independent scans
    where one long scan per row would leave the card nearly idle."""
    r, n = x.shape
    pad = -n % chunk
    blocks = torch.nn.functional.pad(x.to(torch.float64), (0, pad)).view(r, -1, chunk)
    inner = torch.cumsum(blocks, dim=-1)
    totals = inner[..., -1]
    before = torch.cumsum(totals, dim=-1) - totals
    return (inner + before[..., None]).view(r, -1)[:, :n]


def reduce_entry_grads(
    entry_grads: torch.Tensor,
    sorted_pids: torch.Tensor,
    point_offsets: torch.Tensor,
    entry_total: torch.Tensor,
    capacity: int,
) -> torch.Tensor:
    """Per-point sums of the per-entry gradient rows, without atomics.

    ``entry_grads`` holds rows at the sorted positions, f32 ``[9,
    capacity]`` or packed int32 ``[6, capacity]`` (decoded to nine f32
    rows after the gather in point order),
    ``sorted_pids`` [capacity] their point ids (P for pads),
    ``point_offsets`` [P] the inclusive cumsum of the touched-tile counts.
    Returns [9, P]: each point's sum over its entries below ``valid_count =
    min(entry_total, capacity)``, zero for a point with none.

    As the JAX function does, a stable sort by point id groups each
    point's rows (entries keep their tile order), and a prefix sum is
    differenced at the span ends ``min(point_offsets, valid_count)``. The
    prefix sum is taken in float64, so the difference of two prefixes over
    millions of entries does not cancel, and blocked (:func:`_prefix_sum_f64`)
    so the card runs it in parallel. Slots at or past ``valid_count``
    are never read: the pads sort last, and their positions gather slot 0.
    """
    valid = torch.clamp_max(entry_total.to(torch.int64), capacity)
    order = torch.sort(sorted_pids, stable=True).indices
    position = torch.arange(order.shape[0], device=order.device)
    order = torch.where(position < valid, order, torch.zeros_like(order))
    prefix = _prefix_sum_f64(decode_rows(entry_grads[:, order]))
    hi_raw = torch.minimum(point_offsets.to(torch.int64), valid) - 1
    hi = prefix[:, hi_raw.clamp_min(0)]
    hi = torch.where(hi_raw >= 0, hi, torch.zeros_like(hi))
    lo = torch.nn.functional.pad(hi[:, :-1], (1, 0))
    return (hi - lo).to(torch.float32)


class _Frame(NamedTuple):
    """What the rasterizer's backward needs beside the saved tensors.

    ``sum_over_tiles``: where the frame is one slab of a tile-sharded
    frame, a function that sums a tensor over the slabs (an all-reduce over
    the tile axis); the backward sums the screen-position gradients with it
    before the densification norm, so a point that spans slabs gets the
    norm of the whole frame. ``None`` for a whole frame.
    """

    tile_count_x: int
    tile_count_y: int
    width: int
    height: int
    capacity: int
    block_size: int
    use_kernels: bool
    packed: bool
    sum_over_tiles: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class RasterizeFunction(torch.autograd.Function):
    """Rasterize per-point rows into an image, differentiably.

    ``apply(point_rows [9, P + 1], positions_2d_grad_norm_ref [P], binning,
    grad_norm_half [2], frame)`` returns ``(image [H, W, 3],
    transmittances [H, W], rendered counts [H, W])``; the last two carry no
    gradient. The gradient of ``point_rows`` has a zero pad column; that of
    the ref is the per-point densification signal
    ``|| dL/d pos2d * (W / 2, H / 2) ||`` (transform_backward/kernel.wgsl:
    364-370), with ``grad_norm_half`` the whole frame's half-size and the
    position gradients summed over the slabs first where
    ``frame.sum_over_tiles`` is set. With ``frame.packed`` the rows are
    packed here and the packed rows are rasterized and saved; the f32 rows'
    gradient passes straight through the rounding.
    """

    @staticmethod
    def forward(ctx, point_rows, grad_norm_ref, binning, image_size_half, frame):
        # Both rasterizers write the initial state (0, 1, 0) for empty
        # tiles, so the JAX pipeline's mask_empty_tiles step has no work here.
        if frame.packed:
            point_rows = pack_rows(point_rows)
        raster = rasterize_forward if frame.use_kernels else rasterize_forward_torch
        image_tiles, trans_tiles, count_tiles = raster(
            point_rows, binning.point_indices, binning.tile_ranges,
            tile_count_x=frame.tile_count_x, block_size=frame.block_size,
        )
        ctx.save_for_backward(
            point_rows, binning.point_indices, binning.tile_ranges,
            binning.point_offsets, binning.total, image_size_half,
            image_tiles, count_tiles,
        )
        ctx.frame = frame
        size = frame[:4]
        image = untile_image(image_tiles, *size)
        trans, counts = untile_map(trans_tiles, *size), untile_map(count_tiles, *size)
        ctx.mark_non_differentiable(trans, counts)
        return image, trans, counts

    @staticmethod
    def backward(ctx, grad_image, grad_trans, grad_counts):
        with stage("render.rasterize_vjp"):
            (point_rows, ids, ranges, offsets, total, half,
             image_tiles, count_tiles) = ctx.saved_tensors
            frame = ctx.frame
            with stage("render.rasterize_bwd"):
                grad_tiles = tile_image(grad_image, frame.tile_count_x, frame.tile_count_y)
                gdotc_tiles = torch.sum(grad_tiles * image_tiles, dim=1)
                raster = rasterize_backward if frame.use_kernels else rasterize_backward_torch
                entry_grads = raster(
                    point_rows, ids, ranges, grad_tiles, gdotc_tiles, count_tiles,
                    tile_count_x=frame.tile_count_x, block_size=frame.block_size,
                )
            with stage("render.reduce"):
                d = reduce_entry_grads(entry_grads, ids, offsets, total, frame.capacity)
                d_rows = torch.nn.functional.pad(d, (0, 1)) if ctx.needs_input_grad[0] else None
                grad_norm = None
                if ctx.needs_input_grad[1]:
                    *_, gx, gy = grad_rows_to_components(d)
                    if frame.sum_over_tiles is not None:
                        gx, gy = frame.sum_over_tiles(torch.stack([gx, gy]))
                    grad_norm = torch.sqrt((gx * half[0]) ** 2 + (gy * half[1]) ** 2)
        return d_rows, grad_norm, None, None, None


def _render_core(
    params: Sequence[torch.Tensor],
    positions_2d_grad_norm_ref: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    capacity: int,
    options: RenderOptions,
    use_kernels: bool,
    grad_norm_half=None,
    sum_over_tiles: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> RenderOutput:
    """One differentiable render of a ``width`` x ``height`` frame, the
    counterpart of the JAX package's ``_build_render_fn``; :func:`render`
    and :mod:`gausplat_tpu_torch.parallel` both call it.

    ``params``: the five inner parameters in ``PARAM_DIMS`` order.
    ``capacity``: the entry buffer's size. ``grad_norm_half``: the
    (half width, half height) of the densification norm, where the frame
    is a slab of a larger one (default: the camera's), as a tuple or as a
    ``[2]`` f32 tensor on the device (which a captured step needs: it
    copies nothing from the host). ``sum_over_tiles``:
    see :class:`_Frame`.

    Its stages: ``render.project`` (the projection, SH and the per-point
    rows), ``render.bin`` and ``render.rasterize`` (A and the untiling);
    :class:`RasterizeFunction`'s backward adds ``render.rasterize_vjp``.
    """
    colors_sh, opacities, positions, rotations, scalings = params
    tile_count_x = -(-width // TILE_SIZE_X)
    tile_count_y = -(-height // TILE_SIZE_Y)
    with stage("render.project"):
        proj = project_gaussians(
            colors_sh,
            positions,
            rotations,
            scalings,
            camera,
            sh_degree=options.colors_sh_degree_max,
            tile_count_x=tile_count_x,
            tile_count_y=tile_count_y,
            opacities=opacities,
            tight_culling=options.tight_culling,
        )
        point_rows = pack_point_data(proj, torch.sigmoid(opacities[:, 0]))
    with stage("render.bin"):
        binning = bin_gaussians(
            proj.depths.detach(),
            proj.tile_x_max,
            proj.tile_x_min,
            proj.tile_y_min,
            proj.tile_counts,
            tile_count_x=tile_count_x,
            tile_count_y=tile_count_y,
            capacity=capacity,
            expand=fused_point_orders if use_kernels else make_point_orders,
        )
    half = camera.image_size_half if grad_norm_half is None else torch.as_tensor(
        grad_norm_half, dtype=torch.float32, device=positions.device)
    frame = _Frame(tile_count_x, tile_count_y, width, height, capacity, options.block_size,
                   use_kernels, options.entry_dtype == "bf16", sum_over_tiles)
    with stage("render.rasterize"):
        image, trans, counts = RasterizeFunction.apply(
            point_rows, positions_2d_grad_norm_ref, binning, half, frame
        )
    return RenderOutput(
        colors_rgb_2d=image,
        radii=proj.radii,
        tile_point_total=binning.total,
        transmittances=trans,
        point_rendered_counts=counts,
    )


def scene_params(scene: GaussianScene) -> tuple:
    """The scene's five inner parameters in ``PARAM_DIMS`` order."""
    return tuple(getattr(scene, name) for name in PARAM_DIMS)


def render(
    scene: GaussianScene,
    view: View,
    options: RenderOptions = RenderOptions(),
    positions_2d_grad_norm_ref: Optional[torch.Tensor] = None,
    *,
    device=None,
) -> RenderOutput:
    """Render a scene from a view. Differentiable in the scene parameters.

    For the densification signal pass ``positions_2d_grad_norm_ref``
    (zeros of shape [P] that require grad) and read its gradient, as the
    reference's dummy-ref side channel (scene/gaussian_3d/mod.rs:222-229).

    Where nothing asks for a gradient (under ``torch.no_grad()``, or no
    parameter and no given ref requires grad), a render on the card is one
    dispatch, as the JAX package's jitted render is: one replay of entry
    point ``"render"``'s captured graph (:mod:`.views_graph`, which says
    what the graph is keyed on and when it is freed; the first call for a
    scene and size runs eagerly on a side stream, the second captures; a
    new view only copies its camera in). The ref is not read there: its
    values enter no output. Where grad is enabled and a parameter or the
    ref requires it (the differentiable render), a render on the card is
    one replay of a captured forward graph and its backward one replay of
    a captured backward graph, as the JAX package's jitted custom VJP
    under ``jax.grad`` is (:mod:`.grad_graph`, which says what the pair is
    keyed on and how a later forward leaves an earlier call's backward
    intact; the first call for a key runs eagerly, forward and backward,
    the second captures). The eager render (:func:`_render_eager`) runs
    on a key's first call, inside a caller's own capture (the trainers'
    steps), with the plain versions (``backend="torch"``, whose loops read
    their bounds back to the host, which no capture may do), and on a CPU
    device. All give the same values and gradients, bit for bit.

    ``device``: where the render runs; it must hold the scene's
    parameters. ``None`` takes the scene's device.
    """
    device = _scene_device(scene, device)
    params = scene_params(scene)
    given = () if positions_2d_grad_norm_ref is None else (positions_2d_grad_norm_ref,)
    if grad_graphed(params + given, options, device):
        return _render_graphed(scene, view, options, positions_2d_grad_norm_ref, device)
    if device.type == "cuda" and _use_kernels(options, device) and not capturing(device):
        return serve_views(scene, pack_cameras([view]), view.image_width, view.image_height,
                           options, "map", "render", device, batched=False)
    return _render_eager(scene, view, options, positions_2d_grad_norm_ref, device)


def grad_graphed(tensors: Sequence[torch.Tensor], options: RenderOptions,
                 device: torch.device) -> bool:
    """Whether a differentiable call takes its entry point's graph pair
    (:mod:`.grad_graph`): grad is enabled and one of ``tensors`` (the scene's
    parameters and any given ref) requires it, on the card, through the
    kernels, outside a caller's capture."""
    return (device.type == "cuda" and needs_grad(tensors) and _use_kernels(options, device)
            and not capturing(device))


def _render_graphed(scene: GaussianScene, view: View, options: RenderOptions = RenderOptions(),
                    positions_2d_grad_norm_ref: Optional[torch.Tensor] = None,
                    device=None) -> RenderOutput:
    """The differentiable :func:`render` as one forward graph replay, its
    backward as one backward graph replay (:mod:`.grad_graph`; on a CPU
    device both run eagerly, through the same static tensors and copies)."""
    device = _scene_device(scene, device)
    width, height = view.image_width, view.image_height
    point_count = _validate(scene, width, height, options)
    capacity = _capacity(point_count, options)
    use_kernels = _use_kernels(options, device)

    def body(params, ref, cameras):
        return _render_core(params, ref, camera_at(cameras, 0), width, height, capacity,
                            options, use_kernels)

    return RenderOutput(*grad_graph("render", device).run(
        scene, scene_params(scene), positions_2d_grad_norm_ref, pack_cameras([view]),
        (width, height, capacity, options), body,
        lambda: _render_eager(scene, view, options, positions_2d_grad_norm_ref, device)))


def _render_eager(scene: GaussianScene, view: View, options: RenderOptions = RenderOptions(),
                  positions_2d_grad_norm_ref: Optional[torch.Tensor] = None,
                  device=None) -> RenderOutput:
    """:func:`render` launched op by op from the host, differentiable.
    Under ``torch.no_grad()``, or when nothing requires grad, autograd
    records no node for :class:`RasterizeFunction`: no graph is built and
    its saved tensors are freed when the call returns."""
    device = _scene_device(scene, device)
    point_count = _validate(scene, view.image_width, view.image_height, options)
    if positions_2d_grad_norm_ref is None:
        positions_2d_grad_norm_ref = torch.zeros(
            (point_count,), dtype=torch.float32, device=device
        )
    return _render_core(
        scene_params(scene), positions_2d_grad_norm_ref, Camera.from_view(view, device=device),
        view.image_width, view.image_height, _capacity(point_count, options), options,
        _use_kernels(options, device),
    )


def render_views(
    scene: GaussianScene,
    views: Sequence[View],
    options: RenderOptions = RenderOptions(),
    *,
    mode: str = "vmap",
    device=None,
) -> RenderOutput:
    """Render one scene from same-resolution views. Returns a
    :class:`RenderOutput` whose fields carry a leading view axis ``[V, ...]``.

    Serving (no grad needed) on the card is one dispatch a call, as the JAX
    package's jitted batch is: the views' renders are captured once as a
    CUDA graph and each call copies its cameras in, replays the graph and
    copies the outputs out (:mod:`.views_graph`, which says what the graph
    is keyed on, when it is captured and when it is freed; the first call
    for a scene runs eagerly, the second captures). On a CPU device the
    same step runs eagerly. Where grad is enabled and a scene parameter
    requires it, a call on the card is one replay of a captured forward
    graph and its backward one replay of a captured backward graph, as the
    JAX package's jitted batch under ``jax.grad`` is
    (:func:`_render_views_graphed`, :mod:`.grad_graph`; the first call for
    a key runs eagerly, the second captures). Inside the caller's own
    capture, with the plain versions (``backend="torch"``) and, under
    grad, on a CPU device, the views are rendered one by one through
    :func:`_render_eager` (:func:`_render_views_eager`).

    ``mode``, as the JAX package's:
    - ``"vmap"``: every view in flight at once (in the graph each view on
      its own stream, every view's buffers live together; in the loop each
      view's outputs kept until all are stacked);
    - ``"map"``: one view after another (in the graph each view's buffers
      freed before the next view's are made; in the loop each view copied
      into the stacked outputs as it finishes).
    Under grad the graph pair renders the views one after another on one
    stream in both modes. All give the same values, bit for bit those of
    :func:`render`.
    """
    views = list(views)
    if not views:
        raise ValueError("render_views needs at least one view")
    w, h = views[0].image_width, views[0].image_height
    for v in views[1:]:
        if (v.image_width, v.image_height) != (w, h):
            # Stacked outputs need one resolution.
            raise InvalidPixelCountError(v.image_width * v.image_height)
    if mode not in ("vmap", "map"):
        raise ValueError(f"mode must be 'vmap' or 'map', got {mode!r}")
    params, device = scene_params(scene), _scene_device(scene, device)
    if grad_graphed(params, options, device):
        return _render_views_graphed(scene, views, options, mode, device)
    if runs_eagerly(params):
        return _render_views_eager(scene, views, options, mode, device)
    return serve_views(scene, pack_cameras(views), w, h, options, mode, "render_views", device)


def _render_views_graphed(scene: GaussianScene, views: Sequence[View],
                          options: RenderOptions = RenderOptions(), mode: str = "vmap",
                          device=None) -> RenderOutput:
    """The differentiable :func:`render_views` as one forward graph replay,
    its backward as one backward graph replay (:mod:`.grad_graph`, entry
    point ``"render_views"``; on a CPU device both run eagerly, through the
    same static tensors and copies). The views are rendered one after
    another and each field stacked, in either ``mode`` (which shapes only
    the warm-up's eager loop): under grad every view's saved state lives
    until the backward, and a forward on side streams would leave its
    backward on streams that are not capturing."""
    device = _scene_device(scene, device)
    views = list(views)
    width, height = views[0].image_width, views[0].image_height
    capacity = _capacity(_validate(scene, width, height, options), options)
    return RenderOutput(*grad_graph("render_views", device).run(
        scene, scene_params(scene), None, pack_cameras(views), (width, height, capacity, options),
        lambda params, ref, cameras: render_stacked(params, ref, cameras, width, height,
                                                    options),
        lambda: _render_views_eager(scene, views, options, mode, device)))


def render_stacked(params, ref: torch.Tensor, cameras: Camera, width: int, height: int,
                   options: RenderOptions, indices: Optional[Sequence[int]] = None
                   ) -> RenderOutput:
    """Views ``indices`` (all by default) of the stacked ``cameras``
    rendered from ``params`` on their device one after another, each field
    stacked along a new leading axis: the body of the batched renders
    under grad and of the data-parallel rank's share."""
    device, point_count = params[0].device, params[0].shape[0]
    capacity, use_kernels = _capacity(point_count, options), _use_kernels(options, device)
    if indices is None:
        indices = range(cameras.focal_length.shape[0])
    return _stack([_render_core(params, ref, camera_at(cameras, i), width, height, capacity,
                                options, use_kernels) for i in indices])


def _stack(outs: Sequence[RenderOutput]) -> RenderOutput:
    """Renders' outputs stacked field by field along a new leading axis."""
    return RenderOutput(*(torch.stack(field) for field in zip(*outs)))


def _render_views_eager(scene, views, options, mode, device) -> RenderOutput:
    """:func:`render_views` as a loop of eager renders, each view's as
    :func:`_render_eager` renders it, on :func:`call_params`."""
    device = _scene_device(scene, device)
    width, height = views[0].image_width, views[0].image_height
    point_count = _validate(scene, width, height, options)
    params, capacity = call_params(scene), _capacity(point_count, options)
    use_kernels = _use_kernels(options, device)

    def one(view):
        ref = torch.zeros((point_count,), dtype=torch.float32, device=device)
        return _render_core(params, ref, Camera.from_view(view, device=device), width, height,
                            capacity, options, use_kernels)

    if mode == "vmap":
        return _stack([one(v) for v in views])
    stacked = None
    for i, v in enumerate(views):
        out = one(v)
        if stacked is None:
            stacked = RenderOutput(*(f.new_empty((len(views),) + f.shape) for f in out))
        for dst, src in zip(stacked, out):
            dst[i] = src
    return stacked


def call_params(scene: GaussianScene) -> tuple:
    """The scene's five parameters as views of themselves, one autograd
    node each for one batched call: the call's gradient is summed over its
    views there before the calls that share a backward are summed, as the
    call's captured backward graph (:mod:`.grad_graph`) and the JAX
    package's VJP of the batch sum it."""
    return tuple(p.view_as(p) for p in scene_params(scene))


def serve_views(scene: GaussianScene, rows, width: int, height: int, options: RenderOptions,
                mode: str, name: str, device: torch.device, batched: bool = True) -> RenderOutput:
    """Render the V views of the packed camera ``rows`` (numpy, or on the
    device; :mod:`.views_graph`) as one replay of entry point ``name``'s
    graph (its step run eagerly on a CPU device), ``mode`` as
    :func:`render_views`'. Returns outputs with a leading view axis, or,
    with ``batched`` false, the one view's outputs without it."""
    point_count = _validate(scene, width, height, options)
    capacity = _capacity(point_count, options)
    use_kernels = _use_kernels(options, device)
    params, count = scene_params(scene), rows.shape[0]
    graph = views_graph(name, device)

    def one(cameras, outputs, ref, i):
        out = _render_core(params, ref, camera_at(cameras, i), width, height, capacity,
                           options, use_kernels)
        for dst, src in zip(outputs, out):
            (dst[i] if batched else dst).copy_(src)

    return RenderOutput(*graph.run(
        scene, params, rows, output_specs(count if batched else None, width, height,
                                          point_count),
        (mode, width, height, options),
        lambda cameras, outputs, ref: graph.each_view(
            count, lambda i: one(cameras, outputs, ref, i), concurrent=mode == "vmap")))


@torch.no_grad()
def count_tile_entries(
    scene: GaussianScene,
    view: View,
    options: RenderOptions = RenderOptions(),
    *,
    device=None,
) -> int:
    """True (tile, point) entry count for one view, the reference's scan
    total (read back at rank/mod.rs:61-63), from the projection alone.

    One dispatch a call, as the JAX package's one tiny jitted program: on
    the card one replay of entry point ``"count_tile_entries"``'s captured
    graph (:mod:`.views_graph`; keyed on the size, the SH degree and the
    culling, so a view set of one size replays), which writes the total
    into a static 0-d int64, read back after it. On a CPU device the same
    step runs eagerly. :func:`_count_tile_entries_eager` is the count
    launched op by op."""
    device = _scene_device(scene, device)
    width, height = view.image_width, view.image_height
    params = scene_params(scene)
    graph = views_graph("count_tile_entries", device)

    def body(cameras, outputs, ref):
        outputs[0].copy_(_entry_total(scene, camera_at(cameras, 0), width, height, options))

    (total,) = graph.run(scene, params, pack_cameras([view]), (((), torch.int64),),
                         (width, height, options.colors_sh_degree_max, options.tight_culling),
                         body)
    return int(total)


@torch.no_grad()
def _count_tile_entries_eager(scene: GaussianScene, view: View,
                              options: RenderOptions = RenderOptions(), *, device=None) -> int:
    """:func:`count_tile_entries` launched op by op from the host."""
    device = _scene_device(scene, device)
    return int(_entry_total(scene, Camera.from_view(view, device=device), view.image_width,
                            view.image_height, options))


def _entry_total(scene: GaussianScene, camera: Camera, width: int, height: int,
                 options: RenderOptions) -> torch.Tensor:
    """The projection's touched-tile counts summed, as a 0-d int64."""
    proj = project_gaussians(
        scene.colors_sh, scene.positions, scene.rotations, scene.scalings, camera,
        sh_degree=options.colors_sh_degree_max,
        tile_count_x=-(-width // TILE_SIZE_X), tile_count_y=-(-height // TILE_SIZE_Y),
        opacities=scene.opacities, tight_culling=options.tight_culling,
    )
    return proj.tile_counts.to(torch.int64).sum()


def calibrate_options(
    scene: GaussianScene,
    views: Sequence[View] | View,
    options: RenderOptions = RenderOptions(),
    *,
    margin: float = 1.0625,
    device=None,
) -> RenderOptions:
    """Right-size ``tile_entry_capacity`` for a scene and a view set: the
    worst view's true entry count times ``margin``, rounded up to the
    block size. Watch ``RenderOutput.tile_point_total`` for overflow."""
    if isinstance(views, View):
        views = [views]
    if not views:
        raise ValueError("calibrate_options needs at least one view")
    worst = max(count_tile_entries(scene, v, options, device=device) for v in views)
    b = options.block_size
    cap = max(int(worst * margin), 1 << 12)
    cap = (cap + b - 1) // b * b
    return dataclasses.replace(options, tile_entry_capacity=cap)
