"""Forward rasterizer parity. The plain version
(``rasterize_forward_torch``) against the JAX package's
``rasterize_forward_xla`` (pinned equal to the Pallas kernel by
tests/test_rasterize.py::test_pallas_interpret_matches_xla) and against
the sequential oracle, on the same entry data: image and transmittance
atol=5e-5, rendered counts exactly (the oracle tolerances of
tests/test_rasterize.py). The CUDA kernel runs only on a card
(tests/test_torch_cuda.py), where it is held against the plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gausplat_tpu.ops import rasterize as jras
from gausplat_tpu.ops.binning import bin_gaussians
from gausplat_tpu.ops.projection import Camera, project_gaussians
from gausplat_tpu_torch.ops import rasterize as tras

import oracle
from tests.torch_helpers import MEDIUM, SMALL, scene_arrays, views

CASES = {"small": SMALL, "medium": MEDIUM}


def _pieces(case):
    """JAX projection + binning of a case: the entry data both rasterizers take."""
    c = CASES[case]
    a = scene_arrays(c["p"])
    jview, _ = views(c["width"], c["height"])
    tcx, tcy = -(-c["width"] // 16), -(-c["height"] // 16)
    capacity = c["capacity"] or 1 << 14
    proj = project_gaussians(
        *(jnp.asarray(a[k]) for k in ("colors_sh", "positions", "rotations", "scalings")),
        Camera.from_view(jview), sh_degree=3, tile_count_x=tcx, tile_count_y=tcy,
        opacities=jnp.asarray(a["opacities"]), tight_culling=True,
    )
    binning = bin_gaussians(
        proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
        proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
    )
    rows = jras.pack_point_data(proj, jax.nn.sigmoid(jnp.asarray(a["opacities"][:, 0])))
    return c, rows, binning, tcx, tcy


def _plain(rows, binning, tcx, block):
    return tras.rasterize_forward_torch(
        torch.as_tensor(np.array(rows)),
        torch.as_tensor(np.array(binning.point_indices)),
        torch.as_tensor(np.array(binning.tile_ranges)),
        tile_count_x=tcx, block_size=block,
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_xla(case):
    c, rows, binning, tcx, tcy = _pieces(case)
    stream = jras.build_entry_stream(
        rows, binning.point_indices, binning.tile_ranges, block_size=c["block"]
    )
    want = jras.mask_empty_tiles(
        *jras.rasterize_forward_xla(stream, num_tiles=tcx * tcy, tile_count_x=tcx),
        binning.tile_ranges,
    )
    got = _plain(rows, binning, tcx, c["block"])
    assert int(binning.total) > 100
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_plain_forward_matches_sequential_oracle():
    """The CUDA kernel's own form (each pixel walks its entries in order)."""
    c, rows, binning, tcx, tcy = _pieces("small")
    image, trans, counts = _plain(rows, binning, tcx, c["block"])
    w, h = c["width"], c["height"]
    oimg, otrans, ocnt = oracle.rasterize_forward(
        np.asarray(rows).T[: c["p"]], np.asarray(binning.point_indices),
        np.asarray(binning.tile_ranges), w, h, tcx,
    )
    np.testing.assert_allclose(tras.untile_image(image, tcx, tcy, w, h).numpy(), oimg,
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(tras.untile_map(trans, tcx, tcy, w, h).numpy(), otrans,
                               atol=5e-5, rtol=0)
    np.testing.assert_array_equal(tras.untile_map(counts, tcx, tcy, w, h).numpy(), ocnt)


def test_forward_wrapper_takes_plain_version_on_cpu():
    c, rows, binning, tcx, _ = _pieces("small")
    before = tras.RASTERIZE_FORWARD.launches
    got = tras.rasterize_forward(
        torch.as_tensor(np.array(rows)),
        torch.as_tensor(np.array(binning.point_indices)),
        torch.as_tensor(np.array(binning.tile_ranges)),
        tile_count_x=tcx, block_size=c["block"],
    )
    want = _plain(rows, binning, tcx, c["block"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tras.RASTERIZE_FORWARD.launches == before


def test_pack_point_data_matches_jax():
    c, rows, _, _, _ = _pieces("small")
    from gausplat_tpu_torch.ops import projection as tproj

    a = scene_arrays(c["p"])
    _, tview = views(c["width"], c["height"])
    proj = tproj.project_gaussians(
        *(torch.as_tensor(a[k]) for k in ("colors_sh", "positions", "rotations", "scalings")),
        tproj.Camera.from_view(tview, device="cpu"), sh_degree=3, tile_count_x=4,
        tile_count_y=3, opacities=torch.as_tensor(a["opacities"]), tight_culling=True,
    )
    got = tras.pack_point_data(proj, torch.sigmoid(torch.as_tensor(a["opacities"][:, 0])))
    assert got.shape == (9, c["p"] + 1) and bool((got[:, -1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(rows), rtol=1e-5, atol=1e-5)


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(8)
    tcx, tcy, w, h = 4, 3, 56, 40
    image = rng.random((h, w, 3)).astype(np.float32)
    tiles = rng.random((tcx * tcy, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        tras.tile_image(torch.as_tensor(image), tcx, tcy).numpy(),
        np.asarray(jras.tile_image(jnp.asarray(image), tcx, tcy)),
    )
    image_tiles = tras.tile_image(torch.as_tensor(image), tcx, tcy)
    np.testing.assert_array_equal(
        tras.untile_image(image_tiles, tcx, tcy, w, h).numpy(), image
    )
    np.testing.assert_array_equal(
        tras.untile_map(torch.as_tensor(tiles), tcx, tcy, w, h).numpy(),
        np.asarray(jras.untile_map(jnp.asarray(tiles), tcx, tcy, w, h)),
    )
    ranges = np.array([[0, 3], [3, 3], [3, 9], [9, 2]] * 3, np.int32)
    counts = rng.integers(0, 9, (tcx * tcy, 256)).astype(np.int32)
    want = jras.mask_empty_tiles(
        jnp.asarray(image_tiles.numpy()), jnp.asarray(tiles), jnp.asarray(counts),
        jnp.asarray(ranges),
    )
    got = tras.mask_empty_tiles(
        image_tiles, torch.as_tensor(tiles), torch.as_tensor(counts), torch.as_tensor(ranges)
    )
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
