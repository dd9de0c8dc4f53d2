"""The port's user-facing tools against the JAX package's, on the CPU:
``render_ply`` against ``scripts/render_ply.py --cpu``, and the seeded
setups of ``fit_toy_scene`` and ``train_long`` against the same recipes
through the JAX package, with three steps of the toy fit against the JAX
``Trainer.fit``. (Profiling: ``test_torch_profiling.py``; the codec:
``test_torch_native.py``.)
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu_torch.scripts import render_ply as RP

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("colors_sh", "opacities", "positions", "rotations", "scalings")


@pytest.fixture
def one_thread():
    """One torch thread: a thread per core in each xdist worker slows the
    plain rasterizer many times over in the whole suite."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- render_ply -------------------------------------------------------------------


def test_png_codec_round_trip_and_against_pil(tmp_path):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    img[4:9] = img[3]  # runs that make PIL choose other row filters
    data = RP.encode_png(img)
    np.testing.assert_array_equal(RP.decode_png(data), img)
    (tmp_path / "a.png").write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    Image.fromarray(img).save(tmp_path / "b.png", optimize=True)
    with pytest.raises(ValueError, match="filters"):
        RP.decode_png((tmp_path / "b.png").read_bytes())
    with pytest.raises(ValueError, match="CRC"):
        RP.decode_png(data[:-5] + bytes([data[-5] ^ 1]) + data[-4:])


#: Runs the JAX CLI as ``python scripts/render_ply.py ...`` would, recording
#: the view it renders.
SPY = """
import runpy, sys
import numpy as np
import gausplat_tpu
real, out = gausplat_tpu.render, sys.argv[-1]
def spy(scene, view, options):
    np.savez(out, fov=[view.field_of_view_x, view.field_of_view_y],
             size=[view.image_width, view.image_height], position=view.view_position,
             transform=view.view_transform)
    return real(scene, view, options)
gausplat_tpu.render = spy
sys.argv = ["scripts/render_ply.py"] + sys.argv[1:-1]
runpy.run_path("scripts/render_ply.py", run_name="__main__")
"""


def test_render_ply_matches_the_jax_cli(tmp_path, one_thread):
    from PIL import Image

    import gausplat_tpu as G
    from golden_scenes import aabbedge_scene

    ply = tmp_path / "scene.3dgs.ply"
    ply.write_bytes(G.encode_polygon(aabbedge_scene()))
    flags = ["--width", "64", "--height", "48", "--azimuth", "0.7", "--elevation", "0.3"]
    done = subprocess.run(
        [sys.executable, "-c", SPY, str(ply), str(tmp_path / "jax.png"), *flags, "--cpu",
         str(tmp_path / "view.npz")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    want = np.load(tmp_path / "view.npz")

    RP.main([str(ply), str(tmp_path / "port.png"), *flags, "--device", "cpu"])
    scene = T.decode_polygon(ply.read_bytes(), device="cpu")
    view = RP.orbit_view(scene.positions.detach().numpy(), 64, 48, 1.0, 4.0, 0.7, 0.3)
    np.testing.assert_allclose([view.field_of_view_x, view.field_of_view_y], want["fov"],
                               atol=1e-6, rtol=0)
    assert [view.image_width, view.image_height] == list(want["size"])
    np.testing.assert_allclose(view.view_position, want["position"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(view.view_transform, want["transform"], atol=1e-6, rtol=0)

    got = RP.decode_png((tmp_path / "port.png").read_bytes()).astype(np.int32)
    ref = np.asarray(Image.open(tmp_path / "jax.png")).astype(np.int32)
    assert got.shape == ref.shape == (48, 64, 3)
    assert ref.std() > 5  # the view sees the scene
    diff = np.abs(got - ref).max(axis=-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, diff.max()


# --- the examples' setups -----------------------------------------------------------


def _jax_scene_arrays(scene):
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def _assert_same_scene(port, jax_arrays, what, set_fields=()):
    """Every array bit for bit, except ``set_fields``, which went through a
    setter's ``log`` in each package: XLA's ``log`` and torch's round about
    15% of float32 inputs one ulp apart, so those are held within one ulp."""
    for f in FIELDS:
        got = getattr(port, f).detach().numpy()
        if f in set_fields:
            np.testing.assert_array_max_ulp(got, jax_arrays[f], maxulp=1)
        else:
            np.testing.assert_array_equal(got, jax_arrays[f], err_msg=f"{what}: {f}")


def _assert_same_views(port_views, jax_views):
    assert len(port_views) == len(jax_views)
    for tv, jv in zip(port_views, jax_views):
        for key in ("field_of_view_x", "field_of_view_y", "image_height", "image_width",
                    "view_id"):
            assert getattr(tv, key) == getattr(jv, key), key
        np.testing.assert_array_equal(tv.view_position, jv.view_position)
        np.testing.assert_array_equal(tv.view_transform, jv.view_transform)


def _jax_toy_setup(iterations):
    """``examples/fit_toy_scene.py``'s recipe through the JAX package."""
    import dataclasses

    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu.train import TrainConfig
    from gausplat_tpu.train.densify import camera_extent

    rng = np.random.default_rng(0)
    opts = G.RenderOptions(tile_entry_capacity=1 << 15, block_size=128)
    p = 120
    truth = G.GaussianScene.from_points(
        G.Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.6))
    truth = truth.set_scalings(jnp.asarray(0.05 + 0.1 * rng.random((p, 3)), jnp.float32))
    truth = truth.set_opacities(jnp.asarray(0.3 + 0.6 * rng.random((p, 1)), jnp.float32))
    views = []
    for i in range(6):
        angle = 2 * np.pi * i / 6
        c, s = np.cos(angle), np.sin(angle)
        rotation = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        position = np.array([4 * s, 0.0, -4 * c])
        views.append(G.View(field_of_view_x=1.0, field_of_view_y=1.0, image_height=128,
                            image_width=128, view_id=i, view_position=position,
                            view_transform=G.View.transform(rotation.T, -rotation @ position)))
    q = 60
    start = G.GaussianScene.from_points(
        G.Points(rng.random((q, 3)).astype(np.float32), rng.standard_normal((q, 3)) * 0.6))
    config = TrainConfig(render=opts, densify_from=100,
                         densify_until=max(iterations - 100, 101), densify_interval=100,
                         sh_warmup_interval=100, opacity_reset_interval=10**9)
    extent = camera_extent(views)
    config = dataclasses.replace(
        config, densify=dataclasses.replace(config.densify, scene_extent=extent),
        optimizer=dataclasses.replace(config.optimizer, scene_extent=extent))
    return truth, views, start, config


def test_toy_fit_matches_jax(one_thread):
    import gausplat_tpu as G
    from gausplat_tpu.train import Trainer
    from gausplat_tpu_torch.examples.fit_toy_scene import fit_toy_scene, toy_setup

    truth, views, start, config = _jax_toy_setup(3)
    setup = toy_setup(3, device="cpu")
    _assert_same_scene(setup["truth"], _jax_scene_arrays(truth), "truth",
                       set_fields=("opacities", "scalings"))
    _assert_same_scene(setup["start"], _jax_scene_arrays(start), "start")
    _assert_same_views(setup["views"], views)
    assert setup["config"].optimizer.scene_extent == config.optimizer.scene_extent
    targets = [np.asarray(G.render(truth, v, config.render).colors_rgb_2d) for v in views]
    for got, want in zip(setup["targets"], targets):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    history = Trainer(start, 128, 128, config).fit(views, targets, 3)
    result = fit_toy_scene(3, device="cpu", log=lambda line: None)
    np.testing.assert_allclose(result["losses"], [h["loss"] for h in history], rtol=1e-5)
    assert result["points_start"] == result["points_end"] == 60
    assert result["round_trip_identical"]
    assert result["ply_bytes"] == len(T.encode_polygon(setup["start"]))


def test_long_fit_setup_matches_jax(one_thread):
    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu_torch.scripts.train_long import long_fit_setup

    # scripts/train_long.py's toy recipe (no --full, no --lego).
    rng = np.random.default_rng(0)
    opts = G.RenderOptions(tile_entry_capacity=1 << 17, block_size=256)
    p = 500
    truth = G.GaussianScene.from_points(
        G.Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.7))
    truth = truth.set_scalings(jnp.asarray(0.03 + 0.08 * rng.random((p, 3)), jnp.float32))
    truth = truth.set_opacities(jnp.asarray(0.3 + 0.6 * rng.random((p, 1)), jnp.float32))
    views = []
    for i in range(10):
        a = 2 * np.pi * i / 10
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([4 * s, 0.0, -4 * c])
        views.append(G.View(field_of_view_x=1.0, field_of_view_y=1.0, image_height=256,
                            image_width=256, view_id=i, view_position=pos,
                            view_transform=G.View.transform(rot.T, -rot @ pos)))
    start = G.GaussianScene.from_points(
        G.Points(rng.random((150, 3)).astype(np.float32),
                 rng.standard_normal((150, 3)) * 0.7))

    setup = long_fit_setup(lego=False, full=False, device="cpu", iterations=10_000)
    _assert_same_scene(setup["truth"], _jax_scene_arrays(truth), "truth",
                       set_fields=("opacities", "scalings"))
    _assert_same_scene(setup["start"], _jax_scene_arrays(start), "start")
    _assert_same_views(setup["views"], views)
    config = setup["config"]
    assert (config.densify_from, config.densify_until, config.densify_interval,
            config.sh_warmup_interval) == (500, 6000, 300, 500)
    for i in (0, 7):
        want = np.asarray(G.render(truth, views[i], opts).colors_rgb_2d)
        np.testing.assert_allclose(setup["targets"][i].numpy(), want, atol=1e-4, rtol=0)
