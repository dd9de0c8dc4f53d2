"""Gradients of the port's render against ``jax.grad`` of the JAX package's.

- The five parameter gradients and the densification signal (the gradient
  of ``positions_2d_grad_norm_ref``) of ``loss = sum(image * G)``, G
  seeded, through ``gausplat_tpu_torch.render`` against
  ``gausplat_tpu.render(backend="xla")``, on the SMALL and MEDIUM scenes,
  with tight culling on and off, and under capacity truncation.
- Culled points get zero gradients and a zero norm.
- Under truncation the gradient equals central finite differences of the
  truncated render.
- Autograd through ``project_gaussians`` equals ``jax.vjp`` of the JAX
  projection for the colour, conic and 2-D position outputs, over culled
  points, clamped colours and the ``where``-guarded ``rsqrt`` s.

Tolerance: each field scaled by its largest magnitude, atol 1e-4 (measured
at most 4.1e-5, on MEDIUM's rotations with the reference AABB; 1.5e-6 or
less on SMALL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu.ops.projection import Camera as JCamera, project_gaussians as jax_project
from gausplat_tpu_torch.ops.projection import Camera, project_gaussians

from tests.torch_helpers import (
    MEDIUM, SMALL, assert_scaled_close, scene_arrays, scenes, views,
)

PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")

GRAD_CASES = {
    "small_tight": (SMALL, True, SMALL["capacity"]),
    "small_reference_aabb": (SMALL, False, SMALL["capacity"]),
    "small_truncated": (SMALL, True, 128),
    "medium_tight": (MEDIUM, True, None),
    "medium_reference_aabb": (MEDIUM, False, None),
}


def grads_of_both(arrays, c, tight, capacity, seed=5):
    """(JAX grads, port grads, port radii, port entry total); the grads are
    dicts of the five parameters and ``norm``, of sum(image * G)."""
    jscene, tscene = scenes(arrays)
    jview, tview = views(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    weight = np.random.default_rng(seed).standard_normal(
        (c["height"], c["width"], 3)).astype(np.float32)
    kw = dict(tile_entry_capacity=capacity, block_size=c["block"], tight_culling=tight)
    p = arrays["positions"].shape[0]

    def jloss(scene, ref):
        out = G.render(scene, jview, G.RenderOptions(backend="xla", **kw), ref)
        return jnp.sum(out.colors_rgb_2d * weight)

    jgrads, jnorm = jax.grad(jloss, argnums=(0, 1))(jscene, jnp.zeros((p,), jnp.float32))
    ref = torch.zeros(p, requires_grad=True)
    out = T.render(tscene, tview, T.RenderOptions(**kw), ref)
    torch.sum(out.colors_rgb_2d * torch.as_tensor(weight)).backward()
    want = {name: np.asarray(getattr(jgrads, name)) for name in PARAMS}
    got = {name: getattr(tscene, name).grad.numpy() for name in PARAMS}
    want["norm"], got["norm"] = np.asarray(jnorm), ref.grad.numpy()
    return want, got, out.radii.numpy(), int(out.tile_point_total)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_render_grads_match_jax(case):
    c, tight, capacity = GRAD_CASES[case]
    want, got, _, total = grads_of_both(scene_arrays(c["p"]), c, tight, capacity)
    if capacity is not None and case.endswith("truncated"):
        assert total > capacity
    for name in want:
        assert np.isfinite(got[name]).all(), name
        assert np.abs(want[name]).max() > 0, name
        assert_scaled_close(got[name], want[name], err_msg=name)


def test_culled_points_get_zero_grads():
    c = SMALL
    arrays = scene_arrays(c["p"])
    arrays["positions"][40:, 2] = -100.0  # behind the camera
    want, got, radii, _ = grads_of_both(arrays, c, True, c["capacity"])
    culled = radii == 0
    assert culled[40:].all() and not culled.all()
    for name in want:
        assert (got[name][culled] == 0).all(), name
        assert_scaled_close(got[name], want[name], err_msg=name)
    assert (got["norm"] >= 0).all() and got["norm"].max() > 0


def test_truncation_gradients_match_finite_differences():
    """tests/test_pipeline.py::test_overflow_truncation_gradients_exact on
    the port: perturbing colors_sh keeps the binning, so central
    differences of the truncated render are exact to f32 noise."""
    c = SMALL
    arrays = scene_arrays(c["p"])
    _, view = views(c["width"], c["height"])
    opts = T.RenderOptions(tile_entry_capacity=64, block_size=64)
    scene = T.GaussianScene.from_numpy(**arrays, device="cpu")
    out = T.render(scene, view, opts)
    assert int(out.tile_point_total) > 64

    def loss(csh):
        s = T.GaussianScene(torch.as_tensor(csh), scene.opacities.detach(),
                            scene.positions.detach(), scene.rotations.detach(),
                            scene.scalings.detach())
        return torch.mean(T.render(s, view, opts).colors_rgb_2d ** 2)

    torch.mean(T.render(scene, view, opts).colors_rgb_2d ** 2).backward()
    g = scene.colors_sh.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    rng = np.random.default_rng(11)
    base = arrays["colors_sh"]
    eps = 1e-2
    with torch.no_grad():
        for _ in range(6):
            i, j = int(rng.integers(0, base.shape[0])), int(rng.integers(0, 3))
            up, dn = base.copy(), base.copy()
            up[i, j] += eps
            dn[i, j] -= eps
            fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
            np.testing.assert_allclose(g[i, j], fd, rtol=2e-2, atol=2e-6)


def test_projection_vjp_matches_jax():
    """Autograd through the port's projection against jax.vjp of the JAX
    projection, as the JAX render's backward takes it."""
    p = 64
    rng = np.random.default_rng(21)
    a = scene_arrays(p, seed=21)
    a["positions"][:4, 2] = -100.0  # culled: behind the camera
    a["rotations"][4] = 0.0  # zero quaternion: culled by the rsqrt guard
    a["positions"][5] = (0.3, -0.2, -4.0)  # at the camera: the view-direction guard
    a["colors_sh"][6:12, 0:3] = -3.0  # colours clamped at zero
    jview, tview = views(64, 48, position=(0.3, -0.2, -4.0))
    kw = dict(sh_degree=3, tile_count_x=4, tile_count_y=3)
    outs = ("color_r", "color_g", "color_b", "conic_xx", "conic_xy", "conic_yy",
            "pos2d_x", "pos2d_y")
    cot = [rng.standard_normal(p).astype(np.float32) for _ in outs]
    inputs = ("colors_sh", "positions", "rotations", "scalings")

    def jproj(*xs):
        proj = jax_project(*xs, JCamera.from_view(jview), **kw)
        return tuple(getattr(proj, o) for o in outs)

    _, vjp = jax.vjp(jproj, *(jnp.asarray(a[k]) for k in inputs))
    want = vjp(tuple(jnp.asarray(c) for c in cot))

    xs = [torch.tensor(a[k], requires_grad=True) for k in inputs]
    proj = project_gaussians(*xs, Camera.from_view(tview, device="cpu"), **kw)
    got = torch.autograd.grad([getattr(proj, o) for o in outs], xs,
                              [torch.as_tensor(c) for c in cot])
    vis = proj.visible.numpy()
    assert not vis[:5].any() and vis[6:].any()
    for name, g, w in zip(inputs, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all(), name
        assert (g[~vis] == 0).all(), name
        assert_scaled_close(g, w, err_msg=name)


def test_no_grad_render_builds_no_graph():
    """Serving under torch.no_grad: the same image, no autograd graph."""
    c = SMALL
    _, scene = scenes(scene_arrays(c["p"]))
    _, view = views(c["width"], c["height"])
    opts = T.RenderOptions(tile_entry_capacity=c["capacity"], block_size=c["block"])
    with torch.no_grad():
        served = T.render(scene, view, opts)
    trained = T.render(scene, view, opts)
    assert served.colors_rgb_2d.grad_fn is None
    assert trained.colors_rgb_2d.grad_fn is not None
    assert torch.equal(served.colors_rgb_2d, trained.colors_rgb_2d.detach())
    assert torch.equal(served.point_rendered_counts, trained.point_rendered_counts)
