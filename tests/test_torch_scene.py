"""Scene, point cloud, PLY codec and view parity of gausplat_tpu_torch
against the JAX package, and the port's independence from JAX.

``GaussianScene.from_points`` is bit for bit JAX's for both
``seed_compat`` values, as is the port's copy of the reference RNG stream
(``utils/rand_compat.py``, also against the goldens of
tests/test_scene.py); ``default``, ``to_points`` and the outer setters
agree with JAX's (setters rtol 1e-6: ``log`` of two libraries)."""

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu_torch import errors

from tests.torch_helpers import scene_arrays, scenes

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_ply_decodes_jax_encoding_and_round_trips():
    jscene, _ = scenes(scene_arrays(37, seed=12))
    blob = G.encode_polygon(jscene)
    tscene = T.decode_polygon(blob, device="cpu")
    for name in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        np.testing.assert_array_equal(
            getattr(tscene, name).detach().numpy(), np.asarray(getattr(jscene, name)),
            err_msg=name,
        )
    assert T.encode_polygon(tscene) == blob
    again = T.decode_polygon(io.BytesIO(blob), device="cpu")
    out = io.BytesIO()
    assert T.encode_polygon(again, out) == blob and out.getvalue() == blob


def test_ply_header_mismatch_raises():
    with pytest.raises(errors.MismatchedPolygonHeaderError):
        T.decode_polygon(b"ply\nformat ascii 1.0\nelement vertex 0\nend_header\n", device="cpu")
    blob = T.encode_polygon(scenes(scene_arrays(3))[1])
    with pytest.raises(errors.MismatchedPolygonHeaderError):
        T.decode_polygon(blob[:-4], device="cpu")  # short payload


def test_scene_getters_match_jax():
    jscene, tscene = scenes(scene_arrays(50, seed=2))
    assert tscene.point_count == jscene.point_count == 50
    assert tscene.size_bytes == jscene.size_bytes
    for getter in ("get_colors_sh", "get_opacities", "get_positions",
                   "get_rotations", "get_scalings"):
        np.testing.assert_allclose(
            getattr(tscene, getter)().detach().numpy(),
            np.asarray(getattr(jscene, getter)()), rtol=1e-6, atol=1e-7, err_msg=getter,
        )
    assert isinstance(tscene, torch.nn.Module)
    assert sorted(n for n, _ in tscene.named_parameters()) == [
        "colors_sh", "opacities", "positions", "rotations", "scalings"]


def test_scene_shape_checks():
    a = {k: torch.as_tensor(v) for k, v in scene_arrays(6).items()}
    with pytest.raises(errors.MismatchedTensorShapeError):
        T.GaussianScene(**dict(a, rotations=a["rotations"][:, :3]))
    with pytest.raises(errors.MismatchedTensorShapeError):
        T.GaussianScene(**dict(a, opacities=a["opacities"][:, 0]))
    scene = T.GaussianScene(**dict(a, positions=a["positions"][:5]))
    with pytest.raises(errors.MismatchedTensorShapeError):
        scene.point_count


def test_from_numpy_copies_to_float32():
    a = scene_arrays(4)
    scene = T.GaussianScene.from_numpy(
        **{k: v.astype(np.float64) for k, v in a.items()}, device="cpu")
    assert scene.colors_sh.dtype == torch.float32
    a["positions"][:] = 0.0  # the scene owns its own copy
    assert bool((scene.positions != 0).any())


def test_view_matches_jax():
    kw = dict(field_of_view_x=1.1, field_of_view_y=0.7, image_height=720,
              image_width=1280, view_position=[1.0, 2.0, 3.0],
              view_transform=G.View.transform(np.eye(3) * 0.5, [1.0, -2.0, 3.0]))
    jv, tv = G.View(**kw), T.View(**kw)
    np.testing.assert_array_equal(tv.view_transform, jv.view_transform)
    np.testing.assert_array_equal(tv.view_rotation(), jv.view_rotation())
    np.testing.assert_array_equal(tv.view_translation(), jv.view_translation())
    assert tv.aspect_ratio == jv.aspect_ratio
    for to in (512, 333):
        a, b = G.View(**kw).resize_max(to), T.View(**kw).resize_max(to)
        assert (a.image_width, a.image_height) == (b.image_width, b.image_height)


def test_constants_match_jax():
    from gausplat_tpu import constants as jc
    from gausplat_tpu_torch import constants as tc

    for name in dir(jc):
        if name.isupper():
            want, got = getattr(jc, name), getattr(tc, name)
            if name == "SH_COEF":
                for w, g in zip(want, got):
                    np.testing.assert_array_equal(g, w)
            else:
                assert got == want, name


def _points(n, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return cols, rng.standard_normal((n, 3)) * 3.0


@pytest.mark.parametrize("seed_compat", ["reference", "numpy"])
def test_from_points_is_bit_identical_to_jax(seed_compat):
    cols, pos = _points(3000, 4)
    jscene = G.GaussianScene.from_points(G.Points.from_colmap(cols, pos), seed=77,
                                         seed_compat=seed_compat)
    tscene = T.GaussianScene.from_points(T.Points.from_colmap(cols, pos), device="cpu",
                                         seed=77, seed_compat=seed_compat)
    for name in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        want = np.asarray(getattr(jscene, name))
        got = getattr(tscene, name).detach().numpy()
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)


def test_rand_compat_stream_matches_jax_and_goldens():
    from gausplat_tpu.utils import rand_compat as jrc
    from gausplat_tpu_torch.utils import rand_compat as trc

    # ChaCha12 with an all-zero key: the published test vector.
    assert [int(x) for x in trc.ChaCha12U64Stream(bytes(32)).take(2)] == [
        0x53F955076A9AF49B, 0xD583265F12CE1F81]
    assert trc.seed_from_u64(0x3D65) == jrc.seed_from_u64(0x3D65)
    np.testing.assert_array_equal(trc.ZIG_NORM_X, jrc.ZIG_NORM_X)
    np.testing.assert_array_equal(trc.ZIG_NORM_F, jrc.ZIG_NORM_F)
    golden = np.array([1.03561187, 2.83414578, 1.71022177, 4.31253433, 41.1576691,
                       0.889902353, 0.431984365, 48.3707466], np.float32)
    np.testing.assert_array_equal(trc.reference_lognormal_e_f32(8), golden)
    # Long enough to take the ziggurat's rejections, its tail and a refill.
    for seed in (0x3D65, 5):
        np.testing.assert_array_equal(trc.reference_lognormal_e_f32(60_000, seed),
                                      jrc.reference_lognormal_e_f32(60_000, seed))


def test_default_and_to_points_match_jax():
    want, got = G.GaussianScene.default(), T.GaussianScene.default(device="cpu")
    assert got.point_count == want.point_count == 16
    for name in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    cols, pos = _points(50, 6)
    jpoints = G.GaussianScene.from_points(G.Points.from_colmap(cols, pos)).to_points()
    tpoints = T.GaussianScene.from_points(T.Points.from_colmap(cols, pos),
                                          device="cpu").to_points()
    np.testing.assert_array_equal(tpoints.colors_rgb, jpoints.colors_rgb)
    np.testing.assert_array_equal(tpoints.positions, jpoints.positions)
    assert tpoints.to_colmap()[0].tolist() == jpoints.to_colmap()[0].tolist()
    assert T.Points.default(3) == T.Points(np.zeros((3, 3)), np.zeros((3, 3)))
    with pytest.raises(ValueError):
        T.Points(np.zeros((3, 2)), np.zeros((3, 3)))


def test_setters_match_jax_and_copy():
    jscene, tscene = scenes(scene_arrays(20, seed=8))
    rng = np.random.default_rng(3)
    values = dict(colors_sh=rng.standard_normal((20, 48)), opacities=rng.uniform(0.05, 0.95,
                  (20, 1)), positions=rng.standard_normal((20, 3)),
                  rotations=rng.standard_normal((20, 4)), scalings=rng.uniform(0.01, 0.5,
                  (20, 3)))
    for name, value in values.items():
        value = value.astype(np.float32)
        want = getattr(jscene, f"set_{name}")(jnp.asarray(value))
        got = getattr(tscene, f"set_{name}")(value)
        for field in values:
            np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                       np.asarray(getattr(want, field)), rtol=1e-6, atol=1e-7,
                                       err_msg=f"set_{name}: {field}")
        # A new scene with its own parameters; the old one is unchanged.
        assert got is not tscene
        with torch.no_grad():
            getattr(got, name).add_(1.0)
        np.testing.assert_array_equal(getattr(tscene, name).detach().numpy(),
                                      np.asarray(getattr(jscene, name)))
    torch_value = tscene.set_scalings(torch.full((20, 3), 0.5, dtype=torch.float64))
    assert torch_value.scalings.dtype == torch.float32
    np.testing.assert_allclose(torch_value.get_scalings().detach().numpy(), 0.5, rtol=1e-6)


@pytest.mark.parametrize("name", ["colors_sh", "opacities", "positions", "rotations",
                                  "scalings"])
def test_make_transforms_match_jax(name):
    """The module-level inner <-> outer transforms (``make_*`` and
    ``make_inner_*``) against JAX's, and each pair round-trips."""
    from gausplat_tpu.scene import gaussian_3d as jg
    from gausplat_tpu_torch.scene import gaussian_3d as tg

    inner = scene_arrays(40, seed=4)[name]
    outer = np.array(getattr(jg, f"make_{name}")(jnp.asarray(inner)))
    got = getattr(tg, f"make_{name}")(torch.as_tensor(inner))
    np.testing.assert_allclose(got.numpy(), outer, rtol=1e-6, atol=1e-7)
    want_inner = np.asarray(getattr(jg, f"make_inner_{name}")(outer))
    for value in (outer, torch.as_tensor(outer)):  # an array-like, and a tensor
        back = getattr(tg, f"make_inner_{name}")(value)
        assert back.dtype == torch.float32
        np.testing.assert_allclose(back.numpy(), want_inner, rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys, gausplat_tpu_torch\n"
        "import gausplat_tpu_torch.scene.colmap, gausplat_tpu_torch.examples.train_from_colmap\n"
        "import gausplat_tpu_torch.parallel, gausplat_tpu_torch.parallel.train_step\n"
        "import gausplat_tpu_torch.testing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gausplat_tpu' or m.startswith('gausplat_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """chip_smoke.py must fail, and print no result, where torch sees no
    CUDA device (as on this CPU-only host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout
