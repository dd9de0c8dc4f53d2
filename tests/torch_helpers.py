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
from gausplat_tpu_torch.testing import EXPAND_WORKLOADS  # noqa: F401  (re-exported)

# One torch thread a process. The suite runs six pytest-xdist workers on
# eight cores, and each worker imports every test file when it collects, so
# this caps every worker: with a thread per core in each, the workers'
# threads outnumbered the cores several times over and the port's tests and
# the JAX tests beside them ran several times slower than alone.
torch.set_num_threads(1)

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


def train_arrays(p, seed):
    """An anisotropic scene (isotropic scales would leave the rotation
    gradients at rounding noise, which Adam's 1e-15 eps turns into full
    steps of either sign)."""
    rng = np.random.default_rng(seed)
    return dict(
        colors_sh=(rng.standard_normal((p, 48)) * 0.3).astype(np.float32),
        opacities=np.full((p, 1), np.log(0.7 / 0.3), np.float32),
        positions=(rng.standard_normal((p, 3)) * 0.6).astype(np.float32),
        rotations=rng.standard_normal((p, 4)).astype(np.float32),
        scalings=np.log(0.08 + 0.15 * rng.random((p, 3))).astype(np.float32),
    )


#: tests/test_train.py::test_fit_scan_matches_fit's schedule, with an opacity
#: reset inside the densify window and a densify threshold that splits and
#: clones (the statistics keep at least 2% from it).
TRAIN_SCHEDULE = dict(densify_from=4, densify_until=11, densify_interval=5,
                      sh_warmup_interval=6, opacity_reset_interval=8,
                      overflow_check_interval=7)
DENSIFY = dict(grad_threshold=0.014, percent_dense=0.2)

#: A training step's stages (``gausplat_tpu_torch.utils.profiling``), each
#: with its parent, in the order they begin.
TRAIN_TREE = [
    ("train.step", None),
    ("render.project", "train.step"),
    ("render.bin", "train.step"),
    ("render.rasterize", "train.step"),
    ("train.loss", "train.step"),
    ("train.backward", "train.step"),
    ("render.rasterize_vjp", "train.backward"),
    ("render.rasterize_bwd", "render.rasterize_vjp"),
    ("render.reduce", "render.rasterize_vjp"),
    ("train.adam", "train.step"),
]
#: A render's stages, in order.
RENDER_STAGES = ["render.project", "render.bin", "render.rasterize"]


def stage_tree(spans):
    """Each span's name with its parent's (None at the top)."""
    return [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]


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


def jax_chunks(config, now, iterations, max_chunk) -> list:
    """The chunk lengths of a ``fit_scan`` of ``iterations`` steps from step
    ``now`` on the JAX package's ``next_host_event`` schedule (plain
    Python: nothing is compiled)."""
    from gausplat_tpu.train.trainer import next_host_event as jax_next

    end, lengths = now + iterations, []
    while now < end:
        k = min(jax_next(config, now, end) - now, max_chunk)
        lengths.append(k)
        now += k
    return lengths


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
