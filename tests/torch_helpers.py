"""Shared inputs and fixtures for the PyTorch port's tests.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (tests/conftest.py) and the port on torch's CPU device.
JAX is imported only inside the helpers that build its side, so the card
tests (tests/test_torch_cuda.py) can use this module where JAX is absent.
"""

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T

#: The small scene of tests/test_rasterize.py: P=80 at 56x40 (partial tiles
#: on both axes), capacity 1024, blend windows of 64.
SMALL = dict(p=80, width=56, height=40, capacity=1024, block=64)
#: A wider scene with SH degree 3: P=2000 at 128x96.
MEDIUM = dict(p=2000, width=128, height=96, capacity=None, block=256)


def scene_arrays(p, seed=3):
    """The recipe of tests/test_rasterize.py::_scene_arrays at any P."""
    rng = np.random.default_rng(seed)
    csh = rng.standard_normal((p, 48)).astype(np.float32) * 0.4
    positions = (rng.standard_normal((p, 3)) * 0.8).astype(np.float32)
    rotations = rng.standard_normal((p, 4)).astype(np.float32)
    scalings = np.log(0.02 + 0.15 * rng.random((p, 3))).astype(np.float32)
    op_inner = (rng.standard_normal((p, 1)) * 2).astype(np.float32)
    return dict(colors_sh=csh, opacities=op_inner, positions=positions,
                rotations=rotations, scalings=scalings)


def expand_workload(p, seed, vis_frac=0.8, max_wh=6):
    """tests/test_expand.py::_workload: the expansion's per-point inputs."""
    rng = np.random.default_rng(seed)
    counts_w = rng.integers(1, max_wh, p).astype(np.int32)
    counts_h = rng.integers(1, max_wh, p).astype(np.int32)
    vis = rng.random(p) < vis_frac
    tx_min = rng.integers(0, 100, p).astype(np.int32)
    ty_min = rng.integers(0, 50, p).astype(np.int32)
    counts = np.where(vis, counts_w * counts_h, 0).astype(np.int32)
    depths = (0.3 + rng.random(p) * 1000).astype(np.float32)
    return depths, tx_min + counts_w, tx_min, ty_min, counts


def _overflow():
    args = expand_workload(2000, 7, 1.0, max_wh=8)
    return args, (int(args[4].sum()) // 2) // 128 * 128


def _all_invisible():
    rng = np.random.default_rng(9)
    z = np.zeros(300, np.int32)
    return ((rng.random(300) + 0.5).astype(np.float32), z, z, z, z), 1 << 12


def _giant_span():
    counts = np.zeros(10, np.int32)
    counts[4] = 1000
    return (np.full(10, 2.0, np.float32), np.full(10, 25, np.int32),
            np.full(10, 5, np.int32), np.full(10, 3, np.int32), counts), 1 << 11


#: The expansion workloads of tests/test_expand.py: name -> () -> (arrays, capacity).
EXPAND_WORKLOADS = {
    "p1000_vis0.8": lambda: (expand_workload(1000, 0, 0.8), 1 << 13),
    "p1000_vis0.05": lambda: (expand_workload(1000, 1, 0.05), 1 << 13),
    "p257_vis1": lambda: (expand_workload(257, 2, 1.0), 1 << 12),
    "p64_vis0.5": lambda: (expand_workload(64, 3, 0.5), 1 << 12),
    "overflow": _overflow,
    "all_invisible": _all_invisible,
    "one_giant_span": _giant_span,
}


def views(width, height, position=(0.0, 0.0, -4.0), rotation=None):
    """The same camera as a (JAX View, port View) pair. ``rotation`` is the
    world-to-view rotation (default identity), looking along its +z."""
    import gausplat_tpu as G

    rot = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    pos = np.asarray(position, np.float64)
    kw = dict(field_of_view_x=1.0, field_of_view_y=0.8, image_height=height,
              image_width=width, view_position=pos)
    transform = G.View.transform(rot.T, -rot @ pos)
    return G.View(view_transform=transform, **kw), T.View(view_transform=transform, **kw)


def port_view(width, height, position=(0.0, 0.0, -4.0)):
    """The port's side of :func:`views` (identity rotation), without JAX."""
    pos = np.asarray(position, np.float64)
    return T.View(field_of_view_x=1.0, field_of_view_y=0.8, image_height=height,
                  image_width=width, view_position=pos,
                  view_transform=T.View.transform(np.eye(3), -pos))


def scenes(arrays):
    """The same weights as a (JAX GaussianScene, port GaussianScene) pair."""
    import jax.numpy as jnp

    import gausplat_tpu as G

    jscene = G.GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jscene, T.GaussianScene.from_arrays(jscene, device="cpu")


#: Gradients against ``jax.grad``: each field scaled by its largest magnitude.
SCALED_ATOL = 1e-4


def assert_scaled_close(got, want, err_msg="", atol=SCALED_ATOL):
    """``got`` within ``atol`` of ``want``, both divided by ``want``'s
    largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0,
                               err_msg=err_msg)


def assert_outputs_match(jax_out, torch_out, atol):
    """Render outputs: floats within ``atol``, integers exactly."""
    for field in jax_out._fields:
        want = np.asarray(getattr(jax_out, field))
        got = getattr(torch_out, field).detach().numpy()
        assert got.shape == want.shape, (field, got.shape, want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)
