"""Multi-device render on ``torch.distributed``: the port's
``gausplat_tpu_torch.parallel`` on 4 gloo ranks of the CPU against the JAX
package's ``gausplat_tpu.parallel`` on its 8-device virtual CPU mesh, on
the scenes of tests/test_parallel.py.

The JAX package's sharded programs take minutes each to compile, so their
answers are stored by ``tests/torch_parallel_fixture.py`` in
``tests/data/torch_parallel_xcheck.npz``; the stored inputs are checked
against the JAX recipe here. Every port case runs inside one spawn of 4
ranks (``spawn_ranks``); the rank worker is
``gausplat_tpu_torch.testing.parallel_render_worker`` (a spawned child
imports its module afresh, and this module imports JAX). Each rank writes
its results to a file; every rank must hold the same results.

- ``make_mesh``: shape and row-major coordinates, and ``ValueError`` for
  too few ranks, as the JAX package's.
- ``render_data_parallel`` (4 views on 4 ranks) and ``render_tile_sharded``
  (a 64x48 frame in 4 slabs of 16 rows: the last all padding) against the
  JAX functions and against the port's single-device render: images
  within 1e-5, integers exactly (the tile-sharded entry total is the max
  over the slabs, so it is held to JAX's alone).
- Their gradients of ``mean(image ** 2)`` (five parameters and the
  densification ref) against ``jax.grad``, scaled by each field's largest
  magnitude, within 1e-4, and the tile-sharded ones against the port's
  single-device render's likewise.
- A slab render with ``Camera.pos2d_shift`` against the matching rows of
  the whole frame bit for bit, and against the JAX package's slab render
  (live) within 1e-5, without ranks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu import parallel as GP
from gausplat_tpu.ops.projection import Camera as GCamera
from gausplat_tpu_torch.ops.projection import Camera as TCamera
from gausplat_tpu_torch.render.pipeline import _render_core, scene_params
from gausplat_tpu_torch.testing import parallel_render_worker, spawn_ranks

from tests import torch_parallel_fixture as fx
from tests.torch_helpers import assert_scaled_close

STORED = dict(np.load(fx.PATH))
ARRAYS = {f: STORED[f"scene/render/{f}"] for f in fx.FIELDS}
W, H, TILE_H = fx.W, fx.RENDER_H, fx.TILE_H


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_ranks")
    spawn_ranks(parallel_render_worker, 4, str(out), ARRAYS, fx.render_views(T, 4, H),
                T.RenderOptions(**fx.RENDER), fx.render_views(T, 1, TILE_H)[0],
                T.RenderOptions(**fx.TILE_RENDER))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _stored(case):
    return {k.split("/", 1)[1]: v for k, v in STORED.items() if k.startswith(case + "/")}


def _assert_outputs(got, prefix, want, atol=1e-5):
    for field in T.RenderOutput._fields:
        w, g = want[field], got[f"{prefix}/{field}"]
        assert g.shape == w.shape, (field, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", sorted(fx.SCENES))
def test_stored_inputs_follow_the_jax_recipe(name):
    scene = fx.jax_scene(**fx.SCENES[name])
    for f in fx.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(scene, f)),
                                      STORED[f"scene/{name}/{f}"], err_msg=f)


def test_ranks_agree(ranks):
    for r in range(1, 4):
        for key, value in ranks[0].items():
            if not key.startswith("mesh/"):
                np.testing.assert_array_equal(ranks[r][key], value, err_msg=f"rank {r}: {key}")


def test_make_mesh(ranks):
    assert GP.make_mesh((4,), ("data",)).shape == {"data": 4}
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["mesh/data"], [4, r])
        # Row-major, as np.arange(4).reshape(2, 2).
        np.testing.assert_array_equal(ranks[r]["mesh/grid"], [2, 2, r // 2, r % 2])
        assert ranks[r]["mesh/too_few_raises"]
    with pytest.raises(ValueError):
        GP.make_mesh((4, 4), ("data", "tiles"))


def test_data_parallel_matches_jax_and_single(ranks):
    got = ranks[0]
    assert got["data_parallel/colors_rgb_2d"].shape == (4, H, W, 3)
    _assert_outputs(got, "data_parallel", _stored("data_parallel"))
    _assert_outputs(got, "data_parallel", {
        field: got[f"data_parallel_single/{field}"] for field in T.RenderOutput._fields})


def test_data_parallel_grads_match_jax(ranks):
    for key, want in _stored("data_parallel").items():
        if key.startswith("grad/"):
            assert_scaled_close(ranks[0][f"data_parallel/{key}"], want, err_msg=key)


def test_tile_sharded_matches_jax_and_single(ranks):
    got = ranks[0]
    assert got["tile_sharded/colors_rgb_2d"].shape == (TILE_H, W, 3)
    _assert_outputs(got, "tile_sharded", _stored("tile_sharded"))
    for field in ("colors_rgb_2d", "transmittances", "radii", "point_rendered_counts"):
        np.testing.assert_allclose(got[f"tile_sharded/{field}"],
                                   got[f"tile_sharded_single/{field}"], atol=1e-5, rtol=0,
                                   err_msg=field)
    assert 0 < got["tile_sharded/tile_point_total"] <= got["tile_sharded_single/tile_point_total"]


def test_tile_sharded_grads_match_jax_and_single(ranks):
    for key, want in _stored("tile_sharded").items():
        if key.startswith("grad/"):
            assert_scaled_close(ranks[0][f"tile_sharded/{key}"], want, err_msg=key)
            assert_scaled_close(ranks[0][f"tile_sharded/{key}"],
                                ranks[0][f"tile_sharded_single/{key}"], err_msg=key)


@functools.lru_cache(maxsize=1)
def _jax_slab_fn():
    from gausplat_tpu.render.pipeline import _build_render_fn

    return jax.jit(_build_render_fn(W, 16, ARRAYS["positions"].shape[0], 3, 4096, 64, "xla",
                                    False))


@pytest.mark.parametrize("y0", [0, 16, 32])
def test_slab_render_matches_full_frame_rows(y0):
    """A 16-row slab from ``pos2d_shift = (0, y0)`` on a 16-row tile grid
    against rows ``[y0, y0 + 16)`` of the whole 64x48 frame: the port
    against its own whole frame with the rendered counts equal and the
    floats within 1e-6, and against the JAX package's slab within 1e-5,
    integers exactly. (The plain rasterizer blends a tile's entries in
    windows aligned to the tile's start in the sorted list, which differs
    between the slab and the frame, so its products associate differently;
    the card's sequential kernel gives the frame's rows bit for bit, which
    ``chip_smoke.py``'s parallel phase checks.)"""
    view_t, view_g = fx.render_views(T, 1, TILE_H)[0], fx.render_views(G, 1, TILE_H)[0]
    opts = T.RenderOptions(**fx.TILE_RENDER)
    scene = T.GaussianScene.from_numpy(**ARRAYS, device="cpu")
    ref = torch.zeros(scene.point_count)
    with torch.no_grad():
        full = T.render(scene, view_t, opts)
        camera = TCamera.from_view(view_t, device="cpu")
        camera.pos2d_shift = torch.tensor([0.0, float(y0)])
        slab = _render_core(scene_params(scene), ref, camera, W, 16, 4096, opts, False)
    assert torch.equal(slab.point_rendered_counts, full.point_rendered_counts[y0:y0 + 16])
    for field in ("colors_rgb_2d", "transmittances"):
        np.testing.assert_allclose(getattr(slab, field).numpy(),
                                   getattr(full, field)[y0:y0 + 16].numpy(), atol=1e-6, rtol=0,
                                   err_msg=field)

    camera_g = dataclasses.replace(GCamera.from_view(view_g),
                                   pos2d_shift=jnp.asarray([0.0, float(y0)], jnp.float32))
    want = _jax_slab_fn()(*(jnp.asarray(ARRAYS[f]) for f in fx.FIELDS),
                          jnp.zeros(scene.point_count, jnp.float32), camera_g)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(slab, field).numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)
