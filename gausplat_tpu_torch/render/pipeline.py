"""The forward render pipeline.

Counterpart of the forward half of ``gausplat_tpu/render/pipeline.py``
(``_forward_internals`` and ``_render_fwd``). Reference orchestration and
validation: .../render/gaussian_3d/jit/mod.rs:32-331.

One render runs: project -> bin (expand, sort, segment) -> rasterize
forward -> untile. On CUDA tensors the expansion and the rasterizer are
the hand-written kernels of :mod:`gausplat_tpu_torch.ops.expand` and
:mod:`gausplat_tpu_torch.ops.rasterize`; the rest is PyTorch operators.

This slice is forward-only: :func:`render` runs under ``torch.no_grad``
and its outputs carry no autograd graph. The ``torch.autograd.Function``
around render, with the backward kernel, comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

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
from ..ops.expand import fused_point_orders
from ..ops.projection import Camera, project_gaussians
from ..ops.rasterize import (
    DEFAULT_BLOCK_SIZE,
    pack_point_data,
    rasterize_forward,
    rasterize_forward_torch,
    untile_image,
    untile_map,
)
from ..scene.gaussian_3d import GaussianScene
from .view import View

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
    #: Per-entry data precision. Only 'f32' is ported.
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
    if options.entry_dtype == "bf16":
        raise NotImplementedError(
            "entry_dtype='bf16' is not ported yet (ROADMAP.md, queue 1, "
            "item 3: bf16 entry rows)"
        )
    if options.entry_dtype != "f32":
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


@torch.no_grad()
def render(
    scene: GaussianScene,
    view: View,
    options: RenderOptions = RenderOptions(),
    *,
    device=None,
) -> RenderOutput:
    """Render a scene from a view (forward only; no autograd graph).

    ``device``: where the render runs; it must hold the scene's
    parameters. ``None`` takes the scene's device.
    """
    device = _scene_device(scene, device)
    point_count = _validate(scene, view.image_width, view.image_height, options)
    use_kernels = _use_kernels(options, device)
    capacity = _capacity(point_count, options)
    tile_count_x = -(-view.image_width // TILE_SIZE_X)
    tile_count_y = -(-view.image_height // TILE_SIZE_Y)

    proj = project_gaussians(
        scene.colors_sh,
        scene.positions,
        scene.rotations,
        scene.scalings,
        Camera.from_view(view, device=device),
        sh_degree=options.colors_sh_degree_max,
        tile_count_x=tile_count_x,
        tile_count_y=tile_count_y,
        opacities=scene.opacities,
        tight_culling=options.tight_culling,
    )
    binning = bin_gaussians(
        proj.depths,
        proj.tile_x_max,
        proj.tile_x_min,
        proj.tile_y_min,
        proj.tile_counts,
        tile_count_x=tile_count_x,
        tile_count_y=tile_count_y,
        capacity=capacity,
        expand=fused_point_orders if use_kernels else make_point_orders,
    )
    point_rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
    raster = rasterize_forward if use_kernels else rasterize_forward_torch
    # Both rasterizers write the initial state (0, 1, 0) for empty tiles,
    # so the JAX pipeline's mask_empty_tiles step has no work here.
    image_tiles, trans_tiles, count_tiles = raster(
        point_rows,
        binning.point_indices,
        binning.tile_ranges,
        tile_count_x=tile_count_x,
        block_size=options.block_size,
    )
    size = (tile_count_x, tile_count_y, view.image_width, view.image_height)
    return RenderOutput(
        colors_rgb_2d=untile_image(image_tiles, *size),
        radii=proj.radii,
        tile_point_total=binning.total,
        transmittances=untile_map(trans_tiles, *size),
        point_rendered_counts=untile_map(count_tiles, *size),
    )


def render_views(
    scene: GaussianScene,
    views: Sequence[View],
    options: RenderOptions = RenderOptions(),
    *,
    device=None,
) -> RenderOutput:
    """Render one scene from same-resolution views, one after another.
    Returns a :class:`RenderOutput` whose fields carry a leading view axis
    ``[V, ...]``."""
    views = list(views)
    if not views:
        raise ValueError("render_views needs at least one view")
    w, h = views[0].image_width, views[0].image_height
    for v in views[1:]:
        if (v.image_width, v.image_height) != (w, h):
            # Stacked outputs need one resolution.
            raise InvalidPixelCountError(v.image_width * v.image_height)
    outs = [render(scene, v, options, device=device) for v in views]
    return RenderOutput(*(torch.stack(field) for field in zip(*outs)))


@torch.no_grad()
def count_tile_entries(
    scene: GaussianScene,
    view: View,
    options: RenderOptions = RenderOptions(),
    *,
    device=None,
) -> int:
    """True (tile, point) entry count for one view, the reference's scan
    total (read back at rank/mod.rs:61-63), from the projection alone."""
    device = _scene_device(scene, device)
    tile_count_x = -(-view.image_width // TILE_SIZE_X)
    tile_count_y = -(-view.image_height // TILE_SIZE_Y)
    proj = project_gaussians(
        scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
        Camera.from_view(view, device=device),
        sh_degree=options.colors_sh_degree_max,
        tile_count_x=tile_count_x, tile_count_y=tile_count_y,
        opacities=scene.opacities, tight_culling=options.tight_culling,
    )
    return int(proj.tile_counts.to(torch.int64).sum())


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
