"""The backward half of the rasterizer against the JAX package, on the CPU.

- ``blend.backward_batch`` against JAX's on windows of random entries.
- ``rasterize_backward_torch`` (kernel C's plain version) against
  ``rasterize_backward_xla``, row by row at the sorted positions below the
  valid count, on the SMALL and MEDIUM scenes with tight culling on and
  off, and under capacity truncation.
- ``reduce_entry_grads`` against JAX's, with and without truncation; the
  port's gets NaN in every slot it must not read.

Gradient tolerance: each row or field is scaled by its largest magnitude
and held to atol 1e-4 (measured: at most 1.4e-6 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gausplat_tpu.ops import blend as jblend
from gausplat_tpu.ops import rasterize as jras
from gausplat_tpu.ops.binning import bin_gaussians as jax_bin
from gausplat_tpu.ops.projection import Camera as JCamera, project_gaussians as jax_project
from gausplat_tpu.render.pipeline import reduce_entry_grads as jax_reduce

from gausplat_tpu_torch.ops import blend as tblend
from gausplat_tpu_torch.ops import rasterize as tras
from gausplat_tpu_torch.ops.binning import bin_gaussians
from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
from gausplat_tpu_torch.render.pipeline import reduce_entry_grads

from tests.torch_helpers import MEDIUM, SMALL, assert_scaled_close, scene_arrays, views

def _window(rng, b, spread=12.0):
    """Random entries (positive definite conics) around one tile's pixels,
    and a pixel carry."""
    cxx, cyy = 0.05 + 0.3 * rng.random(b), 0.05 + 0.3 * rng.random(b)
    cxy = 0.9 * np.sqrt(cxx * cyy) * rng.uniform(-1, 1, b)
    rows = np.stack([
        rng.random(b), rng.random(b), rng.random(b), cxx, cxy, cyy,
        0.05 + 0.9 * rng.random(b),
        16 + spread * rng.standard_normal(b), 16 + spread * rng.standard_normal(b),
    ]).astype(np.float32)
    lane = np.arange(256)
    pix_x = (16 + lane % 16).astype(np.float32)[None]
    pix_y = (16 + lane // 16).astype(np.float32)[None]
    grad = rng.standard_normal((3, 256)).astype(np.float32)
    gdotc = rng.standard_normal((1, 256)).astype(np.float32)
    counts = rng.integers(0, b + 8, (1, 256)).astype(np.int32)
    trans = (0.2 + 0.8 * rng.random((1, 256))).astype(np.float32)
    prefix = (0.1 * rng.standard_normal((1, 256))).astype(np.float32)
    mask = np.ones((b, 1), bool)
    mask[: b // 8] = False
    return rows, pix_x, pix_y, grad, gdotc, counts, trans, prefix, mask


@pytest.mark.parametrize("b,seed", [(64, 0), (256, 1)])
def test_backward_batch_matches_jax(b, seed):
    rows, pix_x, pix_y, grad, gdotc, counts, trans, prefix, mask = _window(
        np.random.default_rng(seed), b
    )
    base = -(b // 8)
    jstate, jgrads = jblend.backward_batch(
        jblend.BackwardState(jnp.asarray(trans), jnp.asarray(prefix)),
        jblend.EntryBlock.from_rows(jnp.asarray(rows.T)),
        jnp.asarray(pix_x), jnp.asarray(pix_y), jnp.int32(base), jnp.asarray(grad),
        jnp.asarray(gdotc), jnp.asarray(counts), jnp.asarray(mask),
    )
    t = torch.as_tensor
    tstate, tgrads = tblend.backward_batch(
        tblend.BackwardState(t(trans)[None], t(prefix)[None]),
        tblend.EntryBlock.from_rows(t(rows)[:, None]),
        t(pix_x)[None], t(pix_y)[None], torch.tensor([[[base]]]), t(grad)[None],
        t(gdotc)[None], t(counts)[None], t(mask)[None],
    )
    for name, w, g in zip(jstate._fields, jstate, tstate):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    want_rows = np.asarray(jblend.grads_to_rows(jgrads, False))
    got_rows = tblend.grads_to_rows(tgrads)[:, 0].numpy()
    assert np.abs(want_rows).max() > 0
    for r in range(9):
        assert_scaled_close(got_rows[r], want_rows[r], err_msg=f"row {r}")
    comps = tblend.grad_rows_to_components(tblend.grads_to_rows(tgrads))
    assert len(comps) == 9 and comps[7].shape == (1, b)


def _both_pieces(c, tight, capacity):
    """The same scene binned by both packages (integers agree exactly), its
    forward through both plain rasterizers, and a seeded image cotangent."""
    a = scene_arrays(c["p"])
    jview, tview = views(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    tcx, tcy = -(-c["width"] // 16), -(-c["height"] // 16)
    kw = dict(sh_degree=3, tile_count_x=tcx, tile_count_y=tcy, tight_culling=tight)

    jproj = jax_project(*(jnp.asarray(a[k]) for k in ("colors_sh", "positions", "rotations",
                                                        "scalings")),
                        JCamera.from_view(jview), opacities=jnp.asarray(a["opacities"]), **kw)
    jbin = jax_bin(jproj.depths, jproj.tile_x_max, jproj.tile_x_min, jproj.tile_y_min,
                   jproj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity)
    jrows = jras.pack_point_data(jproj, jax.nn.sigmoid(jnp.asarray(a["opacities"])[:, 0]))
    stream = jras.build_entry_stream(jrows, jbin.point_indices, jbin.tile_ranges,
                                     block_size=c["block"])
    jimg, _, jcnt = jras.rasterize_forward_xla(stream, num_tiles=tcx * tcy, tile_count_x=tcx)

    t = {k: torch.as_tensor(v) for k, v in a.items()}
    proj = project_gaussians(t["colors_sh"], t["positions"], t["rotations"], t["scalings"],
                             Camera.from_view(tview, device="cpu"), opacities=t["opacities"],
                             **kw)
    binning = bin_gaussians(proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
                            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy,
                            capacity=capacity)
    rows = tras.pack_point_data(proj, torch.sigmoid(t["opacities"][:, 0]))
    np.testing.assert_array_equal(binning.point_indices.numpy(), np.asarray(jbin.point_indices))
    img, _, cnt = tras.rasterize_forward_torch(rows, binning.point_indices, binning.tile_ranges,
                                               tile_count_x=tcx, block_size=c["block"])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))

    gimg = np.random.default_rng(11).standard_normal((c["height"], c["width"], 3))
    gtiles = tras.tile_image(torch.as_tensor(gimg.astype(np.float32)), tcx, tcy)
    return dict(a=a, tcx=tcx, stream=stream, jimg=jimg, jcnt=jcnt, jbin=jbin,
                rows=rows, binning=binning, img=img, cnt=cnt, gtiles=gtiles)


BACKWARD_CASES = {
    "small_tight": (SMALL, True, SMALL["capacity"]),
    "small_reference_aabb": (SMALL, False, SMALL["capacity"]),
    "small_truncated": (SMALL, True, 128),
    "medium_tight": (MEDIUM, True, 1 << 14),
}


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_rasterize_backward_plain_matches_xla(case):
    c, tight, capacity = BACKWARD_CASES[case]
    x = _both_pieces(c, tight, capacity)
    valid = min(int(x["binning"].total), capacity)
    if case == "small_truncated":
        assert int(x["binning"].total) > capacity
    gtiles = x["gtiles"]
    jgt = jnp.asarray(gtiles.numpy())
    want = np.asarray(jras.rasterize_backward_xla(
        x["stream"], jgt, jnp.sum(jgt * x["jimg"], axis=1), x["jcnt"], tile_count_x=x["tcx"]))
    gdotc = torch.sum(gtiles * x["img"], dim=1)
    got = tras.rasterize_backward(
        x["rows"], x["binning"].point_indices, x["binning"].tile_ranges, gtiles, gdotc, x["cnt"],
        tile_count_x=x["tcx"], block_size=c["block"],
    ).numpy()
    assert got.shape == (9, capacity)
    assert np.abs(want[:, :valid]).max() > 0
    for r in range(9):
        assert_scaled_close(got[r, :valid], want[r, :valid], err_msg=f"row {r}")


@pytest.mark.parametrize("truncated", [False, True])
def test_reduce_entry_grads_matches_jax(truncated):
    c = SMALL
    capacity = 128 if truncated else c["capacity"]
    x = _both_pieces(c, True, capacity)
    total = x["binning"].total
    valid = min(int(total), capacity)
    assert (int(total) > capacity) == truncated
    grads = np.random.default_rng(4).standard_normal((9, capacity)).astype(np.float32)
    want = jax_reduce(jnp.asarray(grads), x["jbin"].point_indices, x["jbin"].point_offsets,
                      x["jbin"].total, capacity, False)
    dirty = grads.copy()
    dirty[:, valid:] = np.nan  # slots past the valid count must never be read
    got = reduce_entry_grads(torch.as_tensor(dirty), x["binning"].point_indices,
                             x["binning"].point_offsets, total, capacity)
    assert got.shape == (9, c["p"])
    assert np.isfinite(got.numpy()).all()
    for r in range(9):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want[r]), atol=2e-6, rtol=1e-5,
                                   err_msg=f"row {r}")
    # Points with no entry below the valid count sum to zero.
    offsets = x["binning"].point_offsets.numpy().astype(np.int64)
    spans = np.minimum(offsets, valid) - np.minimum(np.concatenate([[0], offsets[:-1]]), valid)
    assert (spans == 0).any()
    assert (got.numpy()[:, spans == 0] == 0).all()
