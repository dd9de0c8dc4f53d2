"""The plain reference against a render worked out by hand, and against the
port's plain path at a small size."""

import math

import numpy as np
import pytest
import torch

from benchmark import reference as R, scenes as S

SIZE = 32
FOCAL = 32.0  # tan(fov / 2) = 0.5


def two_points():
    """A far point listed first and a near one in front of it, both on the
    optical axis, isotropic, SH degree 0 only."""
    colors = torch.zeros((2, 48))
    colors[0, :3] = torch.tensor([0.9, -0.4, 0.1])
    colors[1, :3] = torch.tensor([-0.3, 0.8, 0.2])
    return dict(
        positions=torch.tensor([[0.5, -0.25, 8.0], [0.0, 0.0, 4.0]]),
        colors_sh=colors,
        opacities=torch.tensor([[2.0], [0.5]]),
        rotations=torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 2.0]]),
        scalings=torch.log(torch.tensor([[0.3] * 3, [0.1] * 3])),
    )


def camera():
    fov = 2 * math.atan(0.5)
    return R.Cam(rotation=np.eye(3), translation=np.zeros(3), position=np.zeros(3),
                 fov=(fov, fov), width=SIZE, height=SIZE)


def by_hand():
    """Each pixel blended front to back in float64 from the closed forms:
    centre (x / z) f + 15.5; for an isotropic point of scale s the 2-D
    covariance (f s / z)^2 [[1 + u^2, u v], [u v, 1 + v^2]] + 0.3 I with
    (u, v) = (x, y) / z; colour C0 dc + 0.5; opacity sigmoid(logit)."""
    near = dict(x=0.0, y=0.0, z=4.0, s=0.1, dc=[-0.3, 0.8, 0.2], logit=0.5)
    far = dict(x=0.5, y=-0.25, z=8.0, s=0.3, dc=[0.9, -0.4, 0.1], logit=2.0)
    py, px = np.mgrid[0:SIZE, 0:SIZE].astype(np.float64)
    image, trans, counts = np.zeros((SIZE, SIZE, 3)), np.ones((SIZE, SIZE)), np.zeros((SIZE, SIZE))
    for k, g in enumerate((near, far)):
        cx = g["x"] / g["z"] * FOCAL + SIZE / 2 - 0.5
        cy = g["y"] / g["z"] * FOCAL + SIZE / 2 - 0.5
        u, v, k2 = g["x"] / g["z"], g["y"] / g["z"], (FOCAL * g["s"] / g["z"]) ** 2
        cov = np.array([[k2 * (1 + u * u) + 0.3, k2 * u * v], [k2 * u * v, k2 * (1 + v * v) + 0.3]])
        con = np.linalg.inv(cov)
        dx, dy = px - cx, py - cy
        quad = con[0, 0] * dx * dx + 2 * con[0, 1] * dx * dy + con[1, 1] * dy * dy
        o = 1 / (1 + math.exp(-g["logit"]))
        alpha = np.minimum(o * np.exp(-0.5 * quad), 252 / 255)
        blend = alpha >= 1 / 255
        color = np.array(g["dc"]) * math.sqrt(1 / (4 * math.pi)) + 0.5
        image += np.where(blend, alpha * trans, 0)[..., None] * color
        trans = np.where(blend, trans * (1 - alpha), trans)
        counts = np.where(blend, k + 1, counts)
    return image, trans, counts


def test_two_points_by_hand():
    got = R.render(two_points(), camera())
    image, trans, counts = by_hand()
    np.testing.assert_allclose(got["image"].numpy(), image, atol=2e-6)
    np.testing.assert_allclose(got["trans"].numpy(), trans, atol=2e-6)
    np.testing.assert_array_equal(got["counts"].numpy(), counts)
    # The near point's covariance is (f s / z)^2 I + 0.3 I: radius 3 sigma.
    assert int(got["radii"][1]) == math.ceil(math.sqrt((FOCAL * 0.1 / 4) ** 2 + 0.3)
                                             * R.FACTOR_RADIUS)


def test_matches_the_port_plain_path():
    T = pytest.importorskip("gausplat_tpu_torch")
    cfg = dict(points=2000, width=48, height=32,
               scene=dict(position_std=1.0, sh_std=0.2, opacity_logit_std=1.0,
                          scale_min=0.02, scale_span=0.08),
               camera=dict(distance=4.0, fov_x=1.2, fov_y=0.8))
    params, _ = S.make_scene(cfg, 2 ** 40 + 3, "cpu")
    cam, other = S.orbit_pool(cfg, 2, 0.15, 9)
    scene = T.GaussianScene(**{k: v.clone() for k, v in params.items()})
    out = T.render(scene, S.to_view(T, cam))
    want = R.render(params, cam)
    assert float((out.colors_rgb_2d - want["image"]).abs().max()) < 1e-5
    assert torch.equal(out.point_rendered_counts, want["counts"])
    assert torch.equal(out.radii, want["radii"]) and int(out.tile_point_total) == want["total"]
    target = R.render(params, other)["image"]
    loss = T.train.photometric_loss(out.colors_rgb_2d, target, 0.2)
    loss.backward()
    ref_loss, grads, _ = R.gradients(params, cam, target)
    assert abs(float(loss) - float(ref_loss)) < 1e-6
    for f in R.FIELDS:
        g = getattr(scene, f).grad
        assert float((g - grads[f]).norm()) <= 1e-4 * float(grads[f].norm()), f


def test_adam_first_step_is_the_sign_times_the_rate():
    adam = R.Adam(extent=2.0)
    params = {f: torch.zeros((3, d)) for f, d in zip(R.FIELDS, (48, 1, 3, 4, 3))}
    grads = {f: torch.full_like(p, -0.5) for f, p in params.items()}
    adam.step(params, grads, {}, 30_000)
    assert torch.allclose(params["opacities"], torch.full((3, 1), 0.05))
    assert torch.allclose(params["positions"], torch.full((3, 3), 1.6e-6 * 2.0))
    assert torch.allclose(params["colors_sh"][:, 3:], torch.full((3, 45), 2.5e-3 / 20))


def test_entries_ordered_by_depth_key_then_point_id_past_two_to_the_21_points():
    """Entries of one tile come nearer depth key first, then in point order,
    whatever the point ids (a key that packed the id in 21 bits let ids
    from 2**21 on spill into the depth key)."""
    points = 2 ** 21 + 16
    counts = torch.zeros(points, dtype=torch.int64)
    near, far = torch.tensor(2.0), (torch.tensor(2.0).view(torch.int32) + 2048).view(torch.float32)
    assert int(R.depth_order(far)) == int(R.depth_order(near)) + 1
    depth = torch.full((points,), float(near))
    # Point 5 one key farther than points past 2**21, which tie with point 7.
    picked = [5, 7, 2 ** 21 + 9, 2 ** 21 + 12]
    counts[picked] = 1
    depth[5] = far
    proj = dict(counts=counts, tiles=(1, 1), depth=depth,
                box=torch.tensor([0, 0, 1]).expand(points, 3))
    bins = R.bin_entries(proj)
    assert bins["pid"].tolist() == [7, 2 ** 21 + 9, 2 ** 21 + 12, 5]
    assert bins["ranges"].tolist() == [[0, 4]]
