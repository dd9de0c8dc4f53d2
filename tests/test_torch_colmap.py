"""The COLMAP loader and the COLMAP training example of gausplat_tpu_torch,
against the JAX package, on the CPU.

- The same synthetic sparse model (written as
  tests/test_example_colmap_e2e.py writes it) parsed by both packages
  gives equal views (every field) and equal points (bit for bit); a
  truncated file raises ``LoaderError`` and a missing one ``IoError``.
- ``gausplat_tpu_torch.examples.train_from_colmap`` on a 64x48 capture of
  3 views rendered by the port from a known scene, 100 iterations with
  bf16 entry rows on the CPU: it writes a loadable PLY, and its PSNR beats
  the untrained start by more than 3 dB.
"""

import math

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu.scene.colmap import load_sparse_model as jax_load_sparse_model
from gausplat_tpu_torch import errors
from gausplat_tpu_torch.examples.train_from_colmap import train_from_colmap
from gausplat_tpu_torch.scene.colmap import load_sparse_model

from tests.test_example_colmap_e2e import _write_sparse

VIEW_FIELDS = ("field_of_view_x", "field_of_view_y", "image_height", "image_width",
               "view_id", "view_position", "view_transform")


def test_sparse_model_matches_jax(tmp_path):
    _write_sparse(tmp_path, n_views=4)
    jnames, tnames = {}, {}
    jpoints, jviews = jax_load_sparse_model(str(tmp_path), jnames)
    tpoints, tviews = load_sparse_model(str(tmp_path), tnames)
    assert tnames == jnames and len(tnames) == 4
    assert sorted(tviews) == sorted(jviews)
    for vid, jv in jviews.items():
        for field in VIEW_FIELDS:
            np.testing.assert_array_equal(getattr(tviews[vid], field), getattr(jv, field),
                                          err_msg=f"view {vid}: {field}")
    assert len(tpoints) == len(jpoints) == 60
    np.testing.assert_array_equal(tpoints.colors_rgb, jpoints.colors_rgb)
    np.testing.assert_array_equal(tpoints.positions, jpoints.positions)
    colors, positions = tpoints.to_colmap()
    jcolors, jpositions = jpoints.to_colmap()
    np.testing.assert_array_equal(colors, jcolors)
    np.testing.assert_array_equal(positions, jpositions)


@pytest.mark.parametrize("name", ["cameras.bin", "images.bin", "points3D.bin"])
def test_truncated_and_missing_files_raise(tmp_path, name):
    _write_sparse(tmp_path)
    path = tmp_path / name
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) - 5])
    with pytest.raises(errors.LoaderError):
        load_sparse_model(str(tmp_path))
    path.unlink()
    with pytest.raises(errors.IoError):
        load_sparse_model(str(tmp_path))


def _ground_truth_scene(pts, cols):
    """tests/test_example_colmap_e2e.py's ground truth, through the port's
    setters."""
    rng = np.random.default_rng(9)
    scene = T.GaussianScene.from_points(
        T.Points.from_colmap(cols, pts.astype(np.float64)), device="cpu")
    scene = scene.set_scalings((0.06 + 0.1 * rng.random((len(pts), 3))).astype(np.float32))
    return scene.set_opacities((0.4 + 0.55 * rng.random((len(pts), 1))).astype(np.float32))


def _psnr(a, b):
    return -10.0 * math.log10(max(float(torch.mean((a - b) ** 2)), 1e-10))


def test_train_from_colmap_example_on_cpu(tmp_path):
    from PIL import Image

    sparse, images = tmp_path / "sparse", tmp_path / "images"
    images.mkdir()
    pts, cols = _write_sparse(sparse)
    names = {}
    _, views = load_sparse_model(str(sparse), names)
    gt = _ground_truth_scene(pts, cols)
    opts = T.RenderOptions(tile_entry_capacity=1 << 14)
    with torch.no_grad():
        for vid, view in views.items():
            img = T.render(gt, view, opts).colors_rgb_2d.numpy()
            png = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
            Image.fromarray(png).save(images / names[vid])

    out_ply = tmp_path / "fit.3dgs.ply"
    lines = []
    # One torch thread: the suite runs in parallel processes (pytest-xdist),
    # and a thread per core in each of them slows this loop of small ops
    # more than tenfold.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        history = train_from_colmap(str(sparse), str(images), str(out_ply), 100,
                                    device="cpu", log=lines.append)
    finally:
        torch.set_num_threads(threads)
    assert lines[0] == "60 SfM points, 3 registered views"
    assert len(history) == 100 and all(math.isfinite(h["loss"]) for h in history)
    fitted = T.decode_polygon(out_ply.read_bytes(), device="cpu")
    assert fitted.point_count >= 60

    # The last step saw view (99 % 3) + 1; the untrained start on that view.
    view = views[99 % 3 + 1]
    init = T.GaussianScene.from_points(T.Points.from_colmap(cols, pts.astype(np.float64)),
                                       device="cpu")
    target = torch.as_tensor(np.asarray(Image.open(images / names[99 % 3 + 1]),
                                        np.float32) / 255.0)
    with torch.no_grad():
        init_psnr = _psnr(T.render(init, view, opts).colors_rgb_2d, target)
    assert history[-1]["psnr"] > init_psnr + 3.0, (history[-1]["psnr"], init_psnr)
