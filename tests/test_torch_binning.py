"""Binning parity: expansion, sort and tile ranges of gausplat_tpu_torch
against the JAX package, exactly. The expansion is compared with both JAX
formulations: the XLA ``make_point_orders`` and the Pallas
``fused_point_orders`` in interpret mode (as tests/test_expand.py runs it).
The expansion kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gausplat_tpu.ops import binning as jbin
from gausplat_tpu.ops import projection as jproj
from gausplat_tpu.ops.expand import fused_point_orders as jax_fused
from gausplat_tpu_torch.ops import binning as tbin
from gausplat_tpu_torch.ops import projection as tproj
from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders

from tests.torch_helpers import EXPAND_WORKLOADS, MEDIUM, scene_arrays, views


WORKLOADS = EXPAND_WORKLOADS


#: Workloads also run through the Pallas kernel in interpret mode (slow on
#: the CPU; tests/test_expand.py pins it to make_point_orders on all).
PALLAS_TOO = ("p64_vis0.5", "overflow")
STATIC = ("tile_count_x", "capacity")


def _torch_orders(fn, arrays, capacity):
    out = fn(*(torch.as_tensor(a) for a in arrays),
             tile_count_x=120, capacity=capacity)
    return [t.cpu().numpy() for t in out]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_make_point_orders_matches_jax(name):
    arrays, capacity = WORKLOADS[name]()
    got = _torch_orders(tbin.make_point_orders, arrays, capacity)
    jargs = [jnp.asarray(a) for a in arrays]
    wants = [jax.jit(jbin.make_point_orders, static_argnames=STATIC)(
        *jargs, tile_count_x=120, capacity=capacity)]
    if name in PALLAS_TOO:
        wants.append(jax_fused(*jargs, tile_count_x=120, capacity=capacity, interpret=True))
    for want in wants:
        keys, src, offsets, total = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(got[0], keys.astype(np.int64))
        np.testing.assert_array_equal(got[1], src)
        np.testing.assert_array_equal(got[2], offsets)
        assert int(got[3]) == int(total)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    n_valid = min(int(got[3]), capacity)
    assert (got[0][n_valid:] == 0xFFFFFFFF).all()
    assert (got[1][n_valid:] == len(arrays[0])).all()


def test_expand_wrapper_takes_plain_version_on_cpu():
    arrays, capacity = WORKLOADS["p1000_vis0.8"]()
    before = EXPAND.launches
    got = _torch_orders(fused_point_orders, arrays, capacity)
    want = _torch_orders(tbin.make_point_orders, arrays, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert EXPAND.launches == before


def test_depth_to_order_matches_jax():
    rng = np.random.default_rng(4)
    depths = np.concatenate([
        (0.25 + rng.random(500) * 16000).astype(np.float32),
        np.array([0.25, np.nextafter(np.float32(16384), 0), 0.0, -1.0, 1e30,
                  np.inf, 2.0, np.nextafter(np.float32(2.0), 3)], np.float32),
    ])
    want = np.asarray(jbin.depth_to_order(jnp.asarray(depths))).astype(np.int64)
    np.testing.assert_array_equal(tbin.depth_to_order(torch.as_tensor(depths)).numpy(), want)


@pytest.mark.parametrize("capacity", [1 << 14, 2048])  # 2048 truncates
def test_bin_gaussians_matches_jax(capacity):
    a = scene_arrays(MEDIUM["p"])
    w, h = MEDIUM["width"], MEDIUM["height"]
    jview, tview = views(w, h)
    tcx, tcy = -(-w // 16), -(-h // 16)
    kw = dict(sh_degree=3, tile_count_x=tcx, tile_count_y=tcy, tight_culling=True)
    names = ("colors_sh", "positions", "rotations", "scalings")
    jp = jproj.project_gaussians(
        *(jnp.asarray(a[k]) for k in names), jproj.Camera.from_view(jview),
        opacities=jnp.asarray(a["opacities"]), **kw,
    )
    tp = tproj.project_gaussians(
        *(torch.as_tensor(a[k]) for k in names), tproj.Camera.from_view(tview, device="cpu"),
        opacities=torch.as_tensor(a["opacities"]), **kw,
    )
    fields = ("depths", "tile_x_max", "tile_x_min", "tile_y_min", "tile_counts")
    want = jax.jit(jbin.bin_gaussians, static_argnames=STATIC + ("tile_count_y",))(
        *(getattr(jp, f) for f in fields),
        tile_count_x=tcx, tile_count_y=tcy, capacity=capacity)
    got = tbin.bin_gaussians(*(getattr(tp, f) for f in fields),
                             tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
                             expand=fused_point_orders)
    assert (int(got.total) > capacity) == (capacity == 2048)
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
