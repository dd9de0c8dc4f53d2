"""Batched serving through ``render/views_graph.py`` on the CPU.

Under ``torch.no_grad()`` ``render_views`` runs the step that the card
captures as a CUDA graph, eagerly (its plain version): the cameras packed
on the host into one ``[V, 21]`` buffer, the views rendered into static
stacked outputs, the outputs copied out. Held here: the packed cameras bit
for bit ``stack_cameras`` of ``Camera.from_view``; both modes against the
JAX package's ``render_views`` (images atol 1e-4, integers exact) and bit
for bit against the eager loop; a later call leaves an earlier call's
outputs as they were and sees a scene changed in place; under grad the
call stays differentiable. The card's side (capture, replay, keys, pools)
is in ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu_torch.ops.projection import Camera
from gausplat_tpu_torch.parallel import stack_cameras
from gausplat_tpu_torch.parallel import render as parallel_render
from gausplat_tpu_torch.render.views_graph import (
    CAMERA_FLOATS, pack_cameras, rows_of, stacked_camera, views_graph,
)

from tests import torch_fixture
from tests.torch_helpers import SMALL, assert_outputs_match, scene_arrays, scenes, views

CPU = torch.device("cpu")


def _options(module, **extra):
    c = SMALL
    return module.RenderOptions(colors_sh_degree_max=3, tight_culling=True,
                                tile_entry_capacity=c["capacity"], block_size=c["block"],
                                **extra)


def _pairs(xs=(-0.4, 0.0, 0.5)):
    # The views of test_torch_render.py::test_render_views_matches_jax, so
    # the JAX compile is shared through the persistent cache.
    return [views(SMALL["width"], SMALL["height"], position=(x, 0.1, -4.0)) for x in xs]


def _fixture_views():
    out = []
    for case in sorted(torch_fixture.CASES):
        _, g = torch_fixture.case_inputs(case)
        fov_x, fov_y, height, width = g["view_shape"]
        out.append(T.View(field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
                          image_height=int(height), image_width=int(width),
                          view_position=g["view_position"], view_transform=g["view_transform"]))
    return out


@pytest.mark.parametrize("which", ["fixture", "bench"])
def test_packed_cameras_are_stacked_from_view(which):
    vs = _fixture_views() if which == "fixture" else chip_smoke.bench_views(T)
    rows = pack_cameras(vs)
    assert rows.shape == (len(vs), CAMERA_FLOATS) and rows.dtype == np.float32
    got, want = stacked_camera(torch.from_numpy(rows)), stack_cameras(vs, device=CPU)
    for f in dataclasses.fields(Camera):
        if f.name == "pos2d_shift":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and torch.equal(a, b), f.name
    assert torch.equal(rows_of(want), torch.from_numpy(rows))


@pytest.mark.parametrize("mode", ["vmap", "map"])
def test_no_grad_render_views_goes_through_the_step_and_matches_jax(mode):
    jscene, tscene = scenes(scene_arrays(SMALL["p"]))
    pairs = _pairs()
    tviews = [t for _, t in pairs]
    eager = T.render_views(tscene, tviews, _options(T), mode=mode)
    graph = views_graph("render_views", CPU)
    graph.release()
    with torch.no_grad():
        got = T.render_views(tscene, tviews, _options(T), mode=mode)
    # The step's static camera buffer holds this call's packed cameras.
    assert graph.rows is not None and torch.equal(graph.rows, torch.from_numpy(
        pack_cameras(tviews)))
    assert not any(t.requires_grad for t in got)
    for field, a, b in zip(got._fields, got, eager):
        assert torch.equal(a, b.detach()), field
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(got, graph.outputs))
    want = G.render_views(jscene, [j for j, _ in pairs], _options(G, backend="xla"), mode=mode)
    assert_outputs_match(want, got, atol=1e-4)


def test_a_later_call_leaves_earlier_outputs_and_sees_in_place_changes():
    _, tscene = scenes(scene_arrays(SMALL["p"]))
    first_views = [t for _, t in _pairs()]
    other_views = [t for _, t in _pairs((0.3, -0.1, 0.2))]
    opts = _options(T)
    with torch.no_grad():
        first = T.render_views(tscene, first_views, opts)
        kept = [t.clone() for t in first]
        other = T.render_views(tscene, other_views, opts)
        for field, a, b in zip(first._fields, first, kept):
            assert torch.equal(a, b), field
        assert not torch.equal(other.colors_rgb_2d, first.colors_rgb_2d)
        tscene.positions.add_(0.05)
        moved = T.render_views(tscene, first_views, opts)
    want = [T.render(tscene, v, opts) for v in first_views]
    for field, got in zip(moved._fields, moved):
        assert torch.equal(got, torch.stack([getattr(o, field).detach() for o in want])), field
    assert not torch.equal(moved.colors_rgb_2d, first.colors_rgb_2d)


def test_render_views_under_grad_stays_differentiable():
    _, tscene = scenes(scene_arrays(SMALL["p"]))
    graph = views_graph("render_views", CPU)
    graph.release()
    out = T.render_views(tscene, [t for _, t in _pairs()], _options(T), mode="map")
    assert graph.rows is None  # the eager loop, not the step
    torch.sum(out.colors_rgb_2d).backward()
    assert tscene.positions.grad is not None and bool(tscene.positions.grad.abs().sum() > 0)


def test_parallel_render_views_without_grad_matches_eager():
    _, tscene = scenes(scene_arrays(SMALL["p"]))
    cameras = stack_cameras([t for _, t in _pairs()], device=CPU)
    w, h, opts = SMALL["width"], SMALL["height"], _options(T)
    eager = parallel_render.render_views(tscene, cameras, w, h, opts)
    with torch.no_grad():
        got = parallel_render.render_views(tscene, cameras, w, h, opts)
    assert torch.equal(views_graph("parallel.render_views", CPU).rows, rows_of(cameras))
    for field, a, b in zip(got._fields, got, eager):
        assert torch.equal(a, b.detach()), field
