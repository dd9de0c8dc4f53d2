"""Binning parity: expansion, sort and tile ranges of gausplat_tpu_torch
against the JAX package, exactly. The expansion is compared with both JAX
formulations: the XLA ``make_point_orders`` and the Pallas
``fused_point_orders`` in interpret mode (as tests/test_expand.py runs it).
The port stores each u32 key as an int32 with its sign bit flipped; its
keys are compared with JAX's through ``keys_to_u32``. The expansion kernel
itself runs only on a card (tests/test_torch_cuda.py)."""

import pathlib
import re

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
from gausplat_tpu_torch.ops.expand import CHUNK_POINTS, EXPAND, fused_point_orders

from tests.torch_helpers import EXPAND_WORKLOADS, MEDIUM, scene_arrays, views


WORKLOADS = EXPAND_WORKLOADS
#: JAX's make_point_orders gathers from an empty table at P = 0 and fails;
#: that workload is held to the plain contract alone
#: (test_make_point_orders_without_points).
JAX_WORKLOADS = sorted(set(WORKLOADS) - {"p0"})


#: Workloads also run through the Pallas kernel in interpret mode (slow on
#: the CPU; tests/test_expand.py pins it to make_point_orders on all).
PALLAS_TOO = ("p64_vis0.5", "overflow")
STATIC = ("tile_count_x", "capacity")


def _torch_orders(fn, arrays, capacity, tile_count_x):
    out = fn(*(torch.as_tensor(a) for a in arrays),
             tile_count_x=tile_count_x, capacity=capacity)
    return [t.cpu().numpy() for t in out]


def _u32(keys):
    return tbin.keys_to_u32(torch.as_tensor(keys)).numpy()


@pytest.mark.parametrize("name", JAX_WORKLOADS)
def test_make_point_orders_matches_jax(name):
    arrays, capacity, tcx = WORKLOADS[name]()
    got = _torch_orders(tbin.make_point_orders, arrays, capacity, tcx)
    jargs = [jnp.asarray(a) for a in arrays]
    wants = [jax.jit(jbin.make_point_orders, static_argnames=STATIC)(
        *jargs, tile_count_x=tcx, capacity=capacity)]
    if name in PALLAS_TOO:
        wants.append(jax_fused(*jargs, tile_count_x=tcx, capacity=capacity, interpret=True))
    for want in wants:
        keys, src, offsets, total = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(_u32(got[0]), keys.astype(np.int64))
        np.testing.assert_array_equal(got[1], src)
        np.testing.assert_array_equal(got[2], offsets)
        assert int(got[3]) == int(total)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    n_valid = min(int(got[3]), capacity)
    assert (got[0][n_valid:] == 0x7FFFFFFF).all()
    assert (got[1][n_valid:] == len(arrays[0])).all()


def test_make_point_orders_without_points():
    arrays, capacity, tcx = WORKLOADS["p0"]()
    keys, src, offsets, total = _torch_orders(tbin.make_point_orders, arrays, capacity, tcx)
    assert keys.dtype == np.int32 and (keys == 0x7FFFFFFF).all() and keys.shape == (capacity,)
    assert (src == 0).all() and src.shape == (capacity,)
    assert offsets.shape == (0,) and int(total) == 0


def test_key_converter_round_trip():
    u32 = np.array([0, 1, 0x7FFF0000, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFF0000,
                    0xFFFFFFFE, 0xFFFFFFFF], np.int64)
    keys = tbin.keys_from_u32(torch.as_tensor(u32))
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(
        keys.numpy(), (u32.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32))
    np.testing.assert_array_equal(tbin.keys_to_u32(keys).numpy(), u32)
    assert int(keys[-1]) == tbin.PAD_KEY == 0x7FFFFFFF
    # Signed order of the stored keys is the u32 order.
    assert (np.diff(keys.numpy()) > 0).all()


def test_chunk_constants_match_the_source():
    source = (pathlib.Path(tbin.__file__).parent.parent / "csrc" / "expand.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", source).group(1)) == CHUNK_POINTS


@pytest.mark.parametrize("name", ["high_tiles", "high_tiles_cut"])
def test_high_tile_binning_matches_jax(name):
    """Tile indices past 32768, where the stored key's sign bit is clear:
    expansion, sort, ranges and the whole binning bit for bit."""
    arrays, capacity, tcx = WORKLOADS[name]()
    tcy = 256
    assert (int(arrays[4].sum()) > capacity) == name.endswith("cut")
    targs = [torch.as_tensor(a) for a in arrays]
    jargs = [jnp.asarray(a) for a in arrays]
    keys, src, _, total = tbin.make_point_orders(*targs, tile_count_x=tcx, capacity=capacity)
    jkeys, jsrc, _, jtotal = jbin.make_point_orders(*jargs, tile_count_x=tcx, capacity=capacity)
    assert (_u32(keys) >= 0x80000000).any() and (_u32(keys)[:int(total)] < 0x80000000).any()
    sorted_keys, sorted_src = tbin.sort_entries(keys, src)
    jsorted_keys, jsorted_src = jbin.sort_entries(jkeys, jsrc)
    np.testing.assert_array_equal(_u32(sorted_keys), np.asarray(jsorted_keys).astype(np.int64))
    np.testing.assert_array_equal(sorted_src.numpy(), np.asarray(jsorted_src))
    ranges = tbin.tile_ranges_from_keys(sorted_keys, total, num_tiles=tcx * tcy)
    jranges = jbin.tile_ranges_from_keys(jsorted_keys, jtotal, num_tiles=tcx * tcy)
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(jranges))
    want = jax.jit(jbin.bin_gaussians, static_argnames=STATIC + ("tile_count_y",))(
        *jargs, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity)
    got = tbin.bin_gaussians(*targs, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
                             expand=fused_point_orders)
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)


def test_expand_wrapper_takes_plain_version_on_cpu():
    arrays, capacity, tcx = WORKLOADS["p1000_vis0.8"]()
    before = EXPAND.launches
    got = _torch_orders(fused_point_orders, arrays, capacity, tcx)
    want = _torch_orders(tbin.make_point_orders, arrays, capacity, tcx)
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
