"""Sharded rendering: data parallelism over views, tile sharding over rows.

Counterpart of ``gausplat_tpu/parallel/render.py``. Every rank runs the
same call on the same scene and views; each renders its share through the
single-view render core (``render/pipeline.py::_render_core``) and the
collectives of :mod:`._collectives` put the results together, so every
rank gets back the whole result, and after a backward every rank's scene
holds the whole gradient, as ``jax.grad`` through the JAX function gives it.

- **Data parallel**: the view batch is split over a mesh axis, views
  ``[i V / D, (i + 1) V / D)`` on the rank at coordinate ``i``. The
  parameters are replicated (their gradients summed over the axis in the
  backward) and the outputs gathered along the view axis.
- **Tile-sharded**: one frame is split by tile rows, a slab of ``h_local``
  rows per rank, rendered with the camera's screen origin shifted by the
  slab's first row (``Camera.pos2d_shift``), on a tile grid of ``h_local``
  rows and with the capacity split D ways. Radii and the entry total are
  maxed over the axis; the slabs are gathered by rows and the padding
  cropped. The densification signal sums the slabs' screen-position
  gradients before the norm, against the whole frame's half-size, so it
  equals the single-device value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..constants import TILE_SIZE_Y
from ..ops.projection import Camera
from ..render.pipeline import (
    RenderOptions,
    RenderOutput,
    _capacity,
    _render_core,
    _use_kernels,
    scene_params,
)
from ..render.view import View
from ..scene.gaussian_3d import GaussianScene
from ._collectives import MAX, all_gather, all_reduce, gather, replicate
from .mesh import Mesh


def _shard_capacity(capacity: int, d: int, block_size: int) -> int:
    """Per-shard tile-entry capacity: the global budget split D ways (at
    least 2^14), rounded up to a block multiple."""
    local = max(capacity // d, 1 << 14)
    return -(-local // block_size) * block_size


def slab_rows(image_height: int, d: int) -> tuple[int, int]:
    """``(h_local, h_pad)``: the rows of each of ``d`` slabs (whole tile
    rows) and of the padded frame."""
    tcy = -(-image_height // TILE_SIZE_Y)
    h_local = -(-tcy // d) * TILE_SIZE_Y
    return h_local, h_local * d


def stack_cameras(views: Sequence[View], *, device) -> Camera:
    """The views' cameras as one :class:`Camera` whose fields carry a
    leading view axis."""
    cams = [Camera.from_view(v, device=device) for v in views]
    return Camera(**{f.name: torch.stack([getattr(c, f.name) for c in cams])
                     for f in dataclasses.fields(Camera) if f.name != "pos2d_shift"})


def camera_count(cameras: Camera) -> int:
    return cameras.focal_length.shape[0]


def camera_at(cameras: Camera, i: int, pos2d_shift: Optional[torch.Tensor] = None) -> Camera:
    """View ``i`` of a stacked :class:`Camera`, with ``pos2d_shift``."""
    fields = {f.name: getattr(cameras, f.name)[i] for f in dataclasses.fields(Camera)
              if f.name != "pos2d_shift"}
    return Camera(**fields, pos2d_shift=pos2d_shift)


def _stack(outs: Sequence[RenderOutput]) -> RenderOutput:
    return RenderOutput(*(torch.stack(field) for field in zip(*outs)))


def render_views(
    scene: GaussianScene,
    cameras: Camera,
    image_width: int,
    image_height: int,
    options: RenderOptions = RenderOptions(),
) -> RenderOutput:
    """Render a batch of cameras (:func:`stack_cameras`) on this rank's
    device, one after another; outputs carry a leading view axis."""
    device = scene.device
    p = scene.point_count
    params, use_kernels = scene_params(scene), _use_kernels(options, device)
    ref = torch.zeros((p,), dtype=torch.float32, device=device)
    return _stack([
        _render_core(params, ref, camera_at(cameras, i), image_width, image_height,
                     _capacity(p, options), options, use_kernels)
        for i in range(camera_count(cameras))
    ])


def render_data_parallel(
    scene: GaussianScene,
    cameras: Camera,
    image_width: int,
    image_height: int,
    mesh: Mesh,
    axis: str = "data",
    options: RenderOptions = RenderOptions(),
    positions_2d_grad_norm_ref: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render a camera batch split over ``mesh``'s ``axis``: V views (a
    multiple of the axis size D), ``V / D`` on each rank. Returns every
    view's outputs on every rank. Differentiable: the scene's and the
    ref's gradients are summed over the axis."""
    d, index, group = mesh.shape[axis], mesh.coords[axis], mesh.groups[axis]
    v = camera_count(cameras)
    if v % d:
        raise ValueError(f"{v} views do not split over {d} ranks")
    device, p = scene.device, scene.point_count
    if positions_2d_grad_norm_ref is None:
        positions_2d_grad_norm_ref = torch.zeros((p,), dtype=torch.float32, device=device)
    *params, ref = replicate([*scene_params(scene), positions_2d_grad_norm_ref], group)
    use_kernels = _use_kernels(options, device)
    local = v // d
    out = _stack([
        _render_core(params, ref, camera_at(cameras, i), image_width, image_height,
                     _capacity(p, options), options, use_kernels)
        for i in range(index * local, (index + 1) * local)
    ])
    return RenderOutput(
        colors_rgb_2d=gather(out.colors_rgb_2d, group),
        radii=all_gather(out.radii, group),
        tile_point_total=all_gather(out.tile_point_total, group),
        transmittances=all_gather(out.transmittances, group),
        point_rendered_counts=all_gather(out.point_rendered_counts, group),
    )


def render_tile_sharded(
    scene: GaussianScene,
    view: View,
    mesh: Mesh,
    axis: str = "tiles",
    options: RenderOptions = RenderOptions(),
    positions_2d_grad_norm_ref: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render one frame with its tile rows split over ``mesh``'s ``axis``.

    The frame is padded to D slabs of whole tile rows; the rank at
    coordinate ``i`` renders rows ``[i h_local, (i + 1) h_local)`` with the
    capacity divided by D (each slab bins only its own tiles). Every rank
    gets the whole frame, the radii and the entry total maxed over the
    slabs. Differentiable: the scene's gradients are summed over the axis,
    and the ref's gradient is the whole frame's densification signal."""
    d, index, group = mesh.shape[axis], mesh.coords[axis], mesh.groups[axis]
    device, p = scene.device, scene.point_count
    w, h = view.image_width, view.image_height
    h_local, _ = slab_rows(h, d)
    capacity = _shard_capacity(_capacity(p, options), d, options.block_size)
    camera = Camera.from_view(view, device=device)
    camera.pos2d_shift = torch.tensor([0.0, float(index * h_local)], device=device)
    if positions_2d_grad_norm_ref is None:
        positions_2d_grad_norm_ref = torch.zeros((p,), dtype=torch.float32, device=device)
    # The ref is not replicated: each slab's backward already sums the
    # position gradients over the slabs, so every rank's norm is whole.
    params = replicate(scene_params(scene), group)
    out = _render_core(
        params, positions_2d_grad_norm_ref, camera, w, h_local, capacity, options,
        _use_kernels(options, device), grad_norm_half=(w / 2.0, h / 2.0),
        sum_over_tiles=lambda x: all_reduce(x, group),
    )
    return RenderOutput(
        colors_rgb_2d=gather(out.colors_rgb_2d, group)[:h],
        radii=all_reduce(out.radii, group, MAX),
        tile_point_total=all_reduce(out.tile_point_total, group, MAX),
        transmittances=all_gather(out.transmittances, group)[:h],
        point_rendered_counts=all_gather(out.point_rendered_counts, group)[:h],
    )
