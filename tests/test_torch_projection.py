"""Projection parity: gausplat_tpu_torch.ops.projection against the JAX
package's project_gaussians on the same inputs, every ProjectionOutput
field. Integer fields exactly; float fields to rtol=1e-5, atol=1e-6 (both
are float32 with the same evaluation order; the slack covers the
libraries' exp / rsqrt / division rounding).

The JAX function runs op by op, not under ``jax.jit``: XLA's CPU fusion
contracts multiply-adds, which moves pos2d by an ulp of its terms (~8e-6
at 128 px) where they cancel; op by op, pos2d agrees bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gausplat_tpu.ops import projection as jproj
from gausplat_tpu_torch.ops import projection as tproj

from tests.torch_helpers import MEDIUM, scene_arrays, views


def _arrays_with_culls():
    """The medium scene plus points that hit each cull: a zero quaternion,
    a point at the camera, one behind it, one beyond the depth window."""
    a = scene_arrays(MEDIUM["p"], seed=5)
    a["rotations"][0] = 0.0
    a["positions"][1] = [0.0, 0.0, -4.0]
    a["positions"][2] = [0.1, 0.0, -6.0]
    a["positions"][3] = [0.0, 0.0, 20000.0]
    return a


@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_projection_matches_jax(sh_degree, tight):
    a = _arrays_with_culls()
    w, h = MEDIUM["width"], MEDIUM["height"]
    jview, tview = views(w, h, rotation=np.array(
        [[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]]))
    tcx, tcy = -(-w // 16), -(-h // 16)
    kw = dict(sh_degree=sh_degree, tile_count_x=tcx, tile_count_y=tcy,
              tight_culling=tight)

    want = jproj.project_gaussians(
        *(jnp.asarray(a[k]) for k in
          ("colors_sh", "positions", "rotations", "scalings")),
        jproj.Camera.from_view(jview), opacities=jnp.asarray(a["opacities"]), **kw,
    )
    got = tproj.project_gaussians(
        *(torch.as_tensor(a[k]) for k in
          ("colors_sh", "positions", "rotations", "scalings")),
        tproj.Camera.from_view(tview, device="cpu"),
        opacities=torch.as_tensor(a["opacities"]), **kw,
    )
    assert not bool(got.visible[:4].any())  # every cull fired
    assert int(got.visible.sum()) > 500
    for field in want._fields:
        w_ = np.asarray(getattr(want, field))
        g_ = getattr(got, field).numpy()
        assert g_.dtype == w_.dtype, field
        if w_.dtype.kind == "f":
            np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-6, err_msg=field)
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=field)


def test_camera_matches_jax():
    jview, tview = views(96, 64, position=(1.2, 0.4, -1.8))
    want = jproj.Camera.from_view(jview)
    got = tproj.Camera.from_view(tview, device="cpu")
    for field in ("focal_length", "image_size_half", "view_bound", "view_position",
                  "view_rotation", "view_translation"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )


def test_quat_to_rotmat_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jproj.quat_to_rotmat_components(*(jnp.asarray(q[:, i]) for i in range(4)))
    got = tproj.quat_to_rotmat_components(*(torch.as_tensor(q[:, i]) for i in range(4)))
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0, atol=1e-7)


def test_quat_to_rotmat_matrix_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    want = np.asarray(jproj.quat_to_rotmat(jnp.asarray(q)))
    got = tproj.quat_to_rotmat(torch.as_tensor(q)).numpy()
    assert got.shape == want.shape == (2, 5, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _project_both(shift=None):
    """The medium scene projected by both packages (the JAX function op by
    op), with an optional screen-origin shift."""
    a = scene_arrays(MEDIUM["p"], seed=6)
    w, h = MEDIUM["width"], MEDIUM["height"]
    jview, tview = views(w, h, position=(0.2, -0.1, -4.0))
    jcam, tcam = jproj.Camera.from_view(jview), tproj.Camera.from_view(tview, device="cpu")
    if shift is not None:
        jcam.pos2d_shift = jnp.asarray(shift, jnp.float32)
        tcam.pos2d_shift = torch.tensor(shift, dtype=torch.float32)
    keys = ("colors_sh", "positions", "rotations", "scalings")
    kw = dict(sh_degree=3, tile_count_x=-(-w // 16), tile_count_y=-(-h // 16),
              tight_culling=True)
    want = jproj.project_gaussians(*(jnp.asarray(a[k]) for k in keys), jcam,
                                   opacities=jnp.asarray(a["opacities"]), **kw)
    got = tproj.project_gaussians(*(torch.as_tensor(a[k]) for k in keys), tcam,
                                  opacities=torch.as_tensor(a["opacities"]), **kw)
    return want, got


def test_projection_output_views_match_jax():
    want, got = _project_both()
    for name in ("colors_rgb_3d", "conics", "positions_2d", "tile_bounds"):
        w_, g_ = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g_.shape == w_.shape and g_.dtype == w_.dtype, name
        np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shift", [(0.0, 16.0), (0.0, 48.0), (32.0, 0.0)])
def test_pos2d_shift_matches_jax(shift):
    """``Camera.pos2d_shift`` subtracts from the full-frame position: the
    shifted projection against JAX's (integers exactly), and its position
    exactly the unshifted one minus the shift wherever that is exact."""
    want, got = _project_both(shift)
    for field in want._fields:
        w_, g_ = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        if w_.dtype.kind == "f":
            np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-6, err_msg=field)
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=field)
    _, plain = _project_both()
    on_screen = got.visible & (plain.pos2d_y >= shift[1]) & (plain.pos2d_x >= shift[0])
    assert int(on_screen.sum()) > 100
    assert torch.equal(got.pos2d_y[on_screen], plain.pos2d_y[on_screen] - shift[1])
    assert torch.equal(got.pos2d_x[on_screen], plain.pos2d_x[on_screen] - shift[0])


def test_float_to_int32_saturates_like_jax():
    """Tile bounds and radii go through float -> int32; out of range, JAX
    saturates (NaN -> 0), where a bare torch cast on the CPU gives INT_MIN."""
    x = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2.5, -2.5, 2147483520.0,
                  -0.7, 1e-30], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = tproj._trunc_i32(torch.as_tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
