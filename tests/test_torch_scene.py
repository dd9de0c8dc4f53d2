"""Scene, PLY codec and view parity of gausplat_tpu_torch against the JAX
package, and the port's independence from JAX."""

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


def test_port_imports_no_jax():
    code = (
        "import sys, gausplat_tpu_torch\n"
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
