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

Serving (no grad needed) is one CUDA graph replay a call, as the JAX
package's jitted vmap and ``shard_map`` are one dispatch
(:mod:`gausplat_tpu_torch.render.views_graph`): :func:`render_views` on
any CUDA device, :func:`render_data_parallel` and
:func:`render_tile_sharded` where the mesh is on NCCL, each rank capturing
its renders with the collectives inside. Where grad is needed, each is
one forward graph replay and its backward one backward graph replay, as
the jitted programs under ``jax.grad`` are
(:mod:`gausplat_tpu_torch.render.grad_graph`): the forward graph holds
the renders and the gathers, the backward graph the replicated
parameters' all-reduce and the slabs' sum of the screen-position
gradients. The ranks decide a miss of a graph's key together (a max over
the mesh), so every rank captures and replays the same collectives in the
same order. Over gloo, which copies through the host and cannot be
captured, inside the caller's own capture, with the plain versions
(``backend="torch"``) under grad, and on a CPU device, they run their
eager forms (``_views_eager``, ``_data_parallel_eager``,
``_tile_sharded_eager``). A group's NCCL communicator is made by the
eager warm-up call, before any capture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..constants import TILE_SIZE_Y
from ..ops.projection import Camera
from ..render.grad_graph import grad_graph
from ..render.pipeline import (
    RenderOptions,
    RenderOutput,
    _capacity,
    _render_core,
    _use_kernels,
    call_params,
    grad_graphed,
    render_stacked,
    scene_params,
    serve_views,
)
from ..render.view import View
from ..render.views_graph import (
    camera_at,
    output_specs,
    pack_cameras,
    rows_of,
    runs_eagerly,
    views_graph,
)
from ..scene.gaussian_3d import GaussianScene
from ._collectives import MAX, all_gather, all_reduce, any_rank, gather, replicate
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


def render_views(
    scene: GaussianScene,
    cameras: Camera,
    image_width: int,
    image_height: int,
    options: RenderOptions = RenderOptions(),
) -> RenderOutput:
    """Render a batch of cameras (:func:`stack_cameras`) on this rank's
    device, one after another; outputs carry a leading view axis. With no
    grad needed, one graph replay a call on a CUDA device
    (``render/pipeline.py::serve_views``); under grad, one forward and one
    backward replay (:func:`_views_graphed`)."""
    params = scene_params(scene)
    if grad_graphed(params, options, scene.device):
        return _views_graphed(scene, cameras, image_width, image_height, options)
    if not runs_eagerly(params):
        return serve_views(scene, rows_of(cameras), image_width, image_height, options, "map",
                           "parallel.render_views", scene.device)
    return _views_eager(scene, cameras, image_width, image_height, options)


def _views_eager(scene, cameras, width, height, options):
    """:func:`render_views` launched op by op, differentiable."""
    ref = torch.zeros((scene.point_count,), dtype=torch.float32, device=scene.device)
    return render_stacked(call_params(scene), ref, cameras, width, height, options)


def _views_graphed(scene, cameras, width, height, options):
    """The differentiable :func:`render_views` through the graph pair of
    entry point ``"parallel.render_views"`` (on a CPU device every replay
    eager): the body of ``render/pipeline.py``'s ``render_views`` pair,
    from a stacked :class:`Camera` on the device."""
    return RenderOutput(*grad_graph("parallel.render_views", scene.device).run(
        scene, scene_params(scene), None, cameras, (width, height, options),
        lambda params, ref, cams: render_stacked(params, ref, cams, width, height, options),
        lambda: _views_eager(scene, cameras, width, height, options)))


def _mesh_key(mesh: Mesh, axis: str) -> tuple:
    """What a sharded graph is keyed on of its mesh: the layout, this rank's
    place, and the process groups its collectives run in (a graph captured
    in a group is never replayed in a later one)."""
    return (mesh.axis_names, tuple(mesh.shape.items()), tuple(mesh.coords.items()), axis,
            mesh.groups[axis], mesh.group)


def _any_miss(mesh: Mesh, device):
    """The ranks' common decision on a miss of their graphs' keys."""
    return lambda missed: any_rank(missed, mesh.group, device)


def _write_all(outputs, out: RenderOutput) -> None:
    for dst, src in zip(outputs, out):
        dst.copy_(src)


def _sharded_route(mesh: Mesh, scene: GaussianScene, ref, options) -> str:
    """How a sharded call runs: ``"grad"`` (the graph pair: on NCCL, grad
    needed of the scene or of a given ref, the kernels, no caller's
    capture), ``"serve"`` (one graph replay: on NCCL, no grad needed, no
    caller's capture) or ``"eager"``."""
    tensors = [*scene_params(scene), *(() if ref is None else (ref,))]
    if mesh.backend != "nccl":
        return "eager"
    if grad_graphed(tensors, options, scene.device):
        return "grad"
    return "eager" if runs_eagerly(tensors) else "serve"


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
    ref's gradients are summed over the axis. On NCCL, with no grad
    needed one graph replay a call on every rank, the gathers inside (the
    ref, which only a backward reads, is then not used); under grad one
    forward and one backward replay (:func:`_data_parallel_graphed`)."""
    d = mesh.shape[axis]
    v = camera_count(cameras)
    if v % d:
        raise ValueError(f"{v} views do not split over {d} ranks")
    route = _sharded_route(mesh, scene, positions_2d_grad_norm_ref, options)
    if route != "serve":
        form = _data_parallel_graphed if route == "grad" else _data_parallel_eager
        return form(scene, cameras, image_width, image_height, mesh, axis, options,
                    positions_2d_grad_norm_ref)
    device, p = scene.device, scene.point_count
    params = scene_params(scene)
    return RenderOutput(*views_graph("parallel.render_data_parallel", device).run(
        scene, params, rows_of(cameras), output_specs(v, image_width, image_height, p),
        (*_mesh_key(mesh, axis), image_width, image_height, options),
        lambda cams, outputs, ref: _write_all(outputs, _data_parallel_local(
            params, ref, cams, image_width, image_height, mesh, axis, options)),
        any_miss=_any_miss(mesh, device)))


def _data_parallel_local(params, ref, cameras, width, height, mesh, axis, options):
    """This rank's share of the views rendered, then every rank's gathered."""
    d, index, group = mesh.shape[axis], mesh.coords[axis], mesh.groups[axis]
    local = camera_count(cameras) // d
    out = render_stacked(params, ref, cameras, width, height, options,
                         range(index * local, (index + 1) * local))
    return RenderOutput(
        colors_rgb_2d=gather(out.colors_rgb_2d, group),
        radii=all_gather(out.radii, group),
        tile_point_total=all_gather(out.tile_point_total, group),
        transmittances=all_gather(out.transmittances, group),
        point_rendered_counts=all_gather(out.point_rendered_counts, group),
    )


def _data_parallel_replicated(params, ref, cameras, width, height, mesh, axis, options):
    """:func:`_data_parallel_local` of the parameters and the ref
    replicated together (their gradients summed over the axis in one
    flattened all-reduce)."""
    *params, ref = replicate([*params, ref], mesh.groups[axis])
    return _data_parallel_local(params, ref, cameras, width, height, mesh, axis, options)


def _data_parallel_eager(scene, cameras, width, height, mesh, axis, options, ref):
    """:func:`render_data_parallel` as a loop of renders, differentiable."""
    if ref is None:
        ref = torch.zeros((scene.point_count,), dtype=torch.float32, device=scene.device)
    return _data_parallel_replicated(scene_params(scene), ref, cameras, width, height, mesh,
                                     axis, options)


def _data_parallel_graphed(scene, cameras, width, height, mesh, axis, options, ref):
    """The differentiable :func:`render_data_parallel` through the graph
    pair of entry point ``"parallel.render_data_parallel"``: the renders and
    gathers in the forward graph, the all-reduce of the replicated inputs'
    gradients in the backward graph (on a CPU device every replay eager)."""
    device = scene.device
    return RenderOutput(*grad_graph("parallel.render_data_parallel", device).run(
        scene, scene_params(scene), ref, cameras,
        (*_mesh_key(mesh, axis), width, height, options),
        lambda params, r, cams: _data_parallel_replicated(params, r, cams, width, height, mesh,
                                                          axis, options),
        lambda: _data_parallel_eager(scene, cameras, width, height, mesh, axis, options, ref),
        any_miss=_any_miss(mesh, device)))


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
    and the ref's gradient is the whole frame's densification signal. On
    NCCL, with no grad needed one graph replay a call on every rank, the
    gathers and maxima inside, the slab's shift a constant made once; under
    grad one forward and one backward replay (:func:`_tile_sharded_graphed`)."""
    route = _sharded_route(mesh, scene, positions_2d_grad_norm_ref, options)
    if route != "serve":
        form = _tile_sharded_graphed if route == "grad" else _tile_sharded_eager
        return form(scene, view, mesh, axis, options, positions_2d_grad_norm_ref)
    device, p = scene.device, scene.point_count
    w, h = view.image_width, view.image_height
    y0 = mesh.coords[axis] * slab_rows(h, mesh.shape[axis])[0]
    params = scene_params(scene)
    graph = views_graph("parallel.render_tile_sharded", device)
    shift = graph.constant(("pos2d_shift", y0), lambda: torch.tensor(
        [0.0, float(y0)], device=device))
    # The whole view's camera: its half-size is the frame's, the
    # densification norm's (which only a backward reads).
    return RenderOutput(*graph.run(
        scene, params, pack_cameras([view]), output_specs(None, w, h, p),
        (*_mesh_key(mesh, axis), w, h, options),
        lambda cams, outputs, ref: _write_all(outputs, _tile_slab(
            params, ref, camera_at(cams, 0, shift), w, h, mesh, axis, options, None)),
        constants=(shift,), any_miss=_any_miss(mesh, device)))


def _tile_slab(params, ref, camera, width, height, mesh, axis, options, grad_norm_half):
    """This rank's slab rendered (``camera`` shifted to it), then the slabs
    joined on every rank: the frame's rows, the radii and totals maxed."""
    d, group = mesh.shape[axis], mesh.groups[axis]
    device, p = params[0].device, params[0].shape[0]
    capacity = _shard_capacity(_capacity(p, options), d, options.block_size)
    out = _render_core(
        params, ref, camera, width, slab_rows(height, d)[0], capacity, options,
        _use_kernels(options, device), grad_norm_half=grad_norm_half,
        sum_over_tiles=lambda x: all_reduce(x, group),
    )
    return RenderOutput(
        colors_rgb_2d=gather(out.colors_rgb_2d, group)[:height],
        radii=all_reduce(out.radii, group, MAX),
        tile_point_total=all_reduce(out.tile_point_total, group, MAX),
        transmittances=all_gather(out.transmittances, group)[:height],
        point_rendered_counts=all_gather(out.point_rendered_counts, group)[:height],
    )


def _tile_sharded_eager(scene, view, mesh, axis, options, ref):
    """:func:`render_tile_sharded` with the camera made per call,
    differentiable."""
    device = scene.device
    w, h = view.image_width, view.image_height
    camera = Camera.from_view(view, device=device)
    y0 = mesh.coords[axis] * slab_rows(h, mesh.shape[axis])[0]
    camera.pos2d_shift = torch.tensor([0.0, float(y0)], device=device)
    if ref is None:
        ref = torch.zeros((scene.point_count,), dtype=torch.float32, device=device)
    # The ref is not replicated: each slab's backward already sums the
    # position gradients over the slabs, so every rank's norm is whole.
    params = replicate(scene_params(scene), mesh.groups[axis])
    return _tile_slab(params, ref, camera, w, h, mesh, axis, options, (w / 2.0, h / 2.0))


def _tile_sharded_graphed(scene, view, mesh, axis, options, ref):
    """The differentiable :func:`render_tile_sharded` through the graph
    pair of entry point ``"parallel.render_tile_sharded"``: the slab's
    render and the joins in the forward graph; the slabs' sum of the
    screen-position gradients (inside the rasterizer's backward) and the
    all-reduce of the replicated parameters' gradients in the backward
    graph. The slab's shift and the frame's half-size are constants held
    on the device (on a CPU device every replay eager)."""
    device = scene.device
    w, h = view.image_width, view.image_height
    y0 = mesh.coords[axis] * slab_rows(h, mesh.shape[axis])[0]
    graph = grad_graph("parallel.render_tile_sharded", device)
    shift = graph.constant(("pos2d_shift", y0), lambda: torch.tensor(
        [0.0, float(y0)], device=device))
    half = graph.constant(("grad_norm_half", w, h), lambda: torch.tensor(
        [w / 2.0, h / 2.0], dtype=torch.float32, device=device))

    def body(params, r, cams):
        return _tile_slab(replicate(params, mesh.groups[axis]), r, camera_at(cams, 0, shift),
                          w, h, mesh, axis, options, half)

    return RenderOutput(*graph.run(
        scene, scene_params(scene), ref, pack_cameras([view]),
        (*_mesh_key(mesh, axis), w, h, options), body,
        lambda: _tile_sharded_eager(scene, view, mesh, axis, options, ref),
        constants=(shift, half), any_miss=_any_miss(mesh, device)))
