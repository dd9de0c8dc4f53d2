"""The rasterize kernels' footprint skip, on the CPU: its plain version
(``ops/rasterize.py::footprint_warp_masks`` / ``entry_warp_masks``, the
formula and margins of ``csrc/tile_batch.cuh``) against the blend test of
both packages.

A warp of a tile is the 16x2 strip of rows 2w and 2w + 1; the kernels skip
an (entry, warp) pair whose bit the mask clears. The skip is exact only if
every (entry, pixel) pair that blends lies in a warp whose bit is set: the
property checked here on random and adversarial rows (hypothesis and
seeded numpy), through ``gausplat_tpu.ops.blend.density_terms`` (JAX on the
CPU) and the port's ``density_terms``, and on the fixture cases' entries
against the stored rendered counts."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import gausplat_tpu_torch as T
from gausplat_tpu.ops import blend as jax_blend
from gausplat_tpu_torch.ops import blend
from gausplat_tpu_torch.ops import rasterize as R
from gausplat_tpu_torch.ops.binning import bin_gaussians
from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
from gausplat_tpu_torch.testing import adversarial_entries, grazing_position
from gausplat_tpu_torch.utils.kernels import CSRC_DIR

import oracle
from tests import torch_fixture

OMIN = np.float32(1.0 / 255.0)
LANE = np.arange(256)


def tile_pixels(x0, y0):
    """Pixel coordinates [1, 256] (f32) of the tile at (x0, y0)."""
    return ((x0 + LANE % 16).astype(np.float32)[None], (y0 + LANE // 16).astype(np.float32)[None])


def blended_port(rows, x0, y0):
    """[n, 256] pairs that the port's blend test lets through."""
    pix_x, pix_y = (torch.as_tensor(p)[None] for p in tile_pixels(x0, y0))
    entries = blend.EntryBlock.from_rows(torch.as_tensor(rows)[:, None, :])
    return blend.density_terms(entries, pix_x, pix_y)[4][0].numpy()


def blended_jax(rows, x0, y0):
    """[n, 256] pairs that the JAX package's blend test lets through."""
    pix_x, pix_y = tile_pixels(x0, y0)
    entries = jax_blend.EntryBlock.from_rows(jnp.asarray(rows.T))
    return np.asarray(jax_blend.density_terms(entries, jnp.asarray(pix_x), jnp.asarray(pix_y))[4])


def masks_of(rows, x0, y0):
    n = rows.shape[1]
    full = torch.full((n,), 1)
    return R.footprint_warp_masks(torch.as_tensor(rows), full * x0, full * y0).numpy()


def assert_blends_inside(rows, x0, y0, blended, what):
    """Every blended (entry, pixel) pair's warp bit is set in the mask."""
    masks = masks_of(rows, x0, y0)
    warps = blended.reshape(-1, 8, 32).any(-1)  # [n, 8]
    bits = (masks[:, None] >> np.arange(8)) & 1
    missed = np.argwhere(warps & (bits == 0))
    assert missed.size == 0, (
        f"{what}: blended (entry, warp) pairs outside the mask: {missed[:5].tolist()}, "
        f"rows {[rows[:, i].tolist() for i in missed[:3, 0]]}")


def full_mask_expected(rows):
    """Rows the kernels must walk in every warp: opacity at or above 1/255,
    and a conic that is not positive definite or a value not finite."""
    f = rows.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        det = f[3] * f[5] - f[4] * f[4]
        odd = ~np.isfinite(rows[3:9]).all(0) | ~((f[3] > 0) & (det > 0))
    return odd & ~(rows[6] < OMIN)


# --- hypothesis: random and adversarial rows -------------------------------------

THRESHOLD_OPACITIES = [
    OMIN * np.float32(1 - 1e-6), np.nextafter(OMIN, np.float32(0)), OMIN,
    np.nextafter(OMIN, np.float32(1)), OMIN * np.float32(1 + 1e-6),
    np.float32(252 / 255), np.float32(1.0), np.float32(0.5),
]
#: Offsets from a tile's corner: tile and strip edges, and just inside them.
EDGES = [0.0, -0.5, 0.5, 1.5, 2.0, 1.999, 7.5, 8.0, 15.0, 15.5, 16.0, 16.001, -1e-3]


@st.composite
def entry_row(draw, x0, y0):
    kind = draw(st.sampled_from(["pd", "near_singular", "huge", "tiny", "not_pd", "not_finite",
                                 "grazing", "grazing"]))
    theta = draw(st.floats(0.0, math.pi))
    big = 10.0 ** draw(st.floats(-3.0, 2.0))
    if kind == "grazing":  # a pixel of the tile just inside the ellipse's extreme
        l1, l2 = big, big * 10.0 ** draw(st.floats(-4.0, 0.0))
    elif kind == "pd":
        l1, l2 = big, big * 10.0 ** draw(st.floats(-3.0, 0.0))
    elif kind == "near_singular":
        l1, l2 = big, big * 10.0 ** -draw(st.floats(3.0, 9.0))
    elif kind == "huge":
        l1 = 10.0 ** draw(st.floats(-7.0, -4.0))
        l2 = l1 * 10.0 ** draw(st.floats(-1.0, 0.0))
    elif kind == "tiny":
        l1 = 10.0 ** draw(st.floats(2.0, 7.0))
        l2 = l1 * 10.0 ** draw(st.floats(-1.0, 0.0))
    else:
        l1, l2 = big, -big * draw(st.sampled_from([0.0, 1e-3, 0.5, 1.0]))
    c, s = math.cos(theta), math.sin(theta)
    conic = [l1 * c * c + l2 * s * s, (l1 - l2) * c * s, l1 * s * s + l2 * c * c]
    opacity = draw(st.one_of(st.sampled_from(THRESHOLD_OPACITIES), st.floats(0.0, 1.0)))
    px = x0 + draw(st.one_of(st.sampled_from(EDGES), st.floats(-24.0, 40.0)))
    py = y0 + draw(st.one_of(st.sampled_from(EDGES), st.floats(-24.0, 40.0)))
    if kind == "grazing":
        # The pixel alone in its strip (a y extreme on row 2w + 1 from below,
        # on row 2w from above) or in its tile (an x extreme on column 15 or 0).
        opacity = draw(st.floats(0.01, 1.0))
        axis, sign = draw(st.integers(0, 1)), draw(st.sampled_from([1, -1]))
        free = draw(st.integers(0, 15))
        if axis == 1:
            pixel = (x0 + free, y0 + 2 * draw(st.integers(0, 7)) + (sign < 0))
        else:
            pixel = (x0 + (15 if sign < 0 else 0), y0 + free)
        px, py = grazing_position(*conic, opacity, pixel, axis, sign,
                                    draw(st.floats(1e-4, 1e-2)))
    row = [*np.random.default_rng(draw(st.integers(0, 99))).random(3), *conic, opacity, px, py]
    if kind == "not_finite":
        row[draw(st.integers(3, 8))] = draw(st.sampled_from([math.nan, math.inf, -math.inf]))
    return row


@st.composite
def tile_entries(draw):
    x0, y0 = draw(st.sampled_from([(0, 0), (16, 32), (1904, 1072)]))
    rows = draw(st.lists(entry_row(x0, y0), min_size=16, max_size=16))
    return np.asarray(rows, np.float64).T.astype(np.float32), x0, y0


@settings(max_examples=60, deadline=None)
@given(tile_entries())
def test_blended_pairs_lie_in_the_mask(case):
    rows, x0, y0 = case
    with np.errstate(all="ignore"):
        assert_blends_inside(rows, x0, y0, blended_port(rows, x0, y0), "port")
        assert_blends_inside(rows, x0, y0, blended_jax(rows, x0, y0), "jax")
    masks = masks_of(rows, x0, y0)
    assert (masks[full_mask_expected(rows)] == R.FULL_WARP_MASK).all()
    assert (masks[rows[6] < OMIN] == 0).all()


def test_adversarial_rows_blend_inside_their_masks():
    rows, _, _, width, height, tcx = adversarial_entries()
    rows = rows[:, :-1]
    for tile in range(tcx * (height // 16)):
        x0, y0 = (tile % tcx) * 16, (tile // tcx) * 16
        with np.errstate(all="ignore"):
            assert_blends_inside(rows, x0, y0, blended_port(rows, x0, y0), f"port, tile {tile}")
            assert_blends_inside(rows, x0, y0, blended_jax(rows, x0, y0), f"jax, tile {tile}")
    masks = masks_of(rows, 0, 0)
    expected = full_mask_expected(rows)
    assert expected.sum() >= 6  # the near-singular, non-PD and non-finite rows
    assert (masks[expected] == R.FULL_WARP_MASK).all()


def test_adversarial_rows_sequential_order_matches_plain():
    """The sequential per-pixel order that kernel A follows (tests/oracle.py)
    gives the plain version's counts on the adversarial rows, so the card's
    exact-count check on them tests the kernel's skip."""
    rows, ids, ranges, width, height, tcx = adversarial_entries()
    args = [torch.as_tensor(a) for a in (rows, ids, ranges)]
    _, trans, counts = R.rasterize_forward_torch(*args, tile_count_x=tcx, block_size=64)
    with np.errstate(all="ignore"):
        _, _, want = oracle.rasterize_forward(rows.T[:-1], ids, ranges, width, height, tcx)
    got = R.untile_map(counts, tcx, height // 16, width, height).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(trans.min()) > 10 * blend._TRANSMITTANCE_MIN


# --- the masks as the kernels see them -------------------------------------------


def test_entry_warp_masks_layout():
    """Masks land at the sorted positions of each tile's range, computed
    against that tile, and are 0 outside every range."""
    rows, ids, ranges, width, height, tcx = adversarial_entries()
    ranges = ranges.copy()
    ranges[5] = ranges[5, 0]  # an empty tile; its slots are outside every range
    got = R.entry_warp_masks(*(torch.as_tensor(a) for a in (rows, ids, ranges)),
                             tile_count_x=tcx).numpy()
    assert got.shape == ids.shape and got.dtype == np.uint8
    inside = np.zeros(ids.shape, bool)
    for tile, (r0, r1) in enumerate(ranges):
        inside[r0:r1] = True
        want = masks_of(rows[:, ids[r0:r1]], (tile % tcx) * 16, (tile // tcx) * 16)
        np.testing.assert_array_equal(got[r0:r1], want, err_msg=f"tile {tile}")
    assert (got[~inside] == 0).all()


def test_margins_match_kernel_header():
    """The plain version's margins are the kernels' (one definition each
    side: Python here, ``tile_batch.cuh`` on the card)."""
    header = (CSRC_DIR / "tile_batch.cuh").read_text()
    for name, value in (("kMarginQAbs", R.FOOTPRINT_MARGIN_Q_ABS),
                        ("kMarginQScale", R.FOOTPRINT_MARGIN_Q_SCALE),
                        ("kMarginCond", R.FOOTPRINT_MARGIN_COND),
                        ("kMarginPixels", R.FOOTPRINT_MARGIN_PIXELS)):
        found = re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;", header)
        assert found and float(found[1]) == value, name
    for source in ("rasterize_forward.cu", "rasterize_backward.cu"):
        assert '#include "tile_batch.cuh"' in (CSRC_DIR / source).read_text()


def _fixture_entries(case):
    g = {k.split("/", 1)[1]: v for k, v in np.load(torch_fixture.PATH).items()
         if k.startswith(case + "/")}
    scene = T.GaussianScene.from_numpy(**{k: g[k] for k in torch_fixture.PARAMS}, device="cpu")
    fov_x, fov_y, height, width = g["view_shape"]
    view = T.View(field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
                  image_height=int(height), image_width=int(width),
                  view_position=g["view_position"], view_transform=g["view_transform"])
    sh_degree, tight, capacity, _, bf16 = (int(x) for x in g["options"])
    tcx, tcy = -(-view.image_width // 16), -(-view.image_height // 16)
    with torch.no_grad():
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
            Camera.from_view(view, device="cpu"), sh_degree=sh_degree,
            tile_count_x=tcx, tile_count_y=tcy, opacities=scene.opacities,
            tight_culling=bool(tight),
        )
        binning = bin_gaussians(
            proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
        )
        # The decoded rows of a bf16 case: what the kernels' footprint sees.
        rows = R.pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
        if bf16:
            rows = blend.unpack_rows(blend.pack_rows(rows))
    counts = torch.as_tensor(g["counts"])[..., None].expand(-1, -1, 3)
    count_tiles = R.tile_image(counts, tcx, tcy)[:, 0]  # [T, 256]
    return rows, binning.point_indices, binning.tile_ranges, tcx, count_tiles


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_masks_keep_every_blended_pair_of_the_fixture(case):
    """Every (entry, warp) pair that blends below the stored (JAX) rendered
    counts keeps its bit, and the masks skip a real share of the pairs."""
    rows, ids, ranges, tcx, count_tiles = _fixture_entries(case)
    masks = R.entry_warp_masks(rows, ids, ranges, tile_count_x=tcx).numpy()
    kept = needed = pairs = 0
    for tile, (r0, r1) in enumerate(ranges.tolist()):
        if r1 <= r0:
            continue
        x0, y0 = (tile % tcx) * 16, (tile // tcx) * 16
        entry_rows = rows[:, ids[r0:r1].long()].numpy()
        position = np.arange(r1 - r0)[:, None]
        blended = blended_port(entry_rows, x0, y0) & (position < count_tiles[tile].numpy())
        warps = blended.reshape(-1, 8, 32).any(-1)
        bits = ((masks[r0:r1, None] >> np.arange(8)) & 1).astype(bool)
        missed = np.argwhere(warps & ~bits)
        assert missed.size == 0, f"tile {tile}: blended pairs outside the mask {missed[:5]}"
        kept += int(bits.sum())
        needed += int(warps.sum())
        pairs += 8 * (r1 - r0)
    assert needed > 0 and kept < pairs, (case, kept, needed, pairs)
