"""bf16 entry rows (``RenderOptions(entry_dtype="bf16")``) of
gausplat_tpu_torch against the JAX package, on the CPU.

- The bf16-pair codec (``pack_pair``, ``unpack_hi``, ``unpack_lo``) is bit
  for bit JAX's on random values, exact ties, carries into the exponent,
  +-FLT_MAX, +-inf, NaN payloads on both sides of 0x7FFF8000, subnormals
  and -0.0; so are the packed ``entries_from_rows``, ``grads_to_rows`` and
  ``grad_rows_to_components``.
- The plain packed rasterizers on the JAX package's own packed rows and
  binning: the forward against ``rasterize_forward_xla`` (image and
  transmittance atol 1e-4, counts exactly); the backward against
  ``rasterize_backward_xla``, decoded, position rows within 1e-4 scaled
  and bf16 rows within 1e-4 scaled plus one bf16 ulp of each element: an
  f32 difference of one ulp in a sum flips a bf16 rounding (measured: 0
  of 1,092 bf16 elements flip on SMALL, 796 of 56,861 on MEDIUM, each
  within one ulp plus 1e-6 scaled).
- ``reduce_entry_grads`` on packed integer-valued gradients is exact (as
  tests/test_scale.py's packed reduce).

The whole render, its gradients and the trainer with bf16 rows are in
tests/test_torch_bf16_render.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gausplat_tpu.ops import blend as jblend
from gausplat_tpu.ops import rasterize as jras
from gausplat_tpu.ops.binning import bin_gaussians as jax_bin
from gausplat_tpu.ops.projection import Camera as JCamera, project_gaussians as jax_project
from gausplat_tpu_torch.ops import blend as tblend
from gausplat_tpu_torch.ops import rasterize as tras
from gausplat_tpu_torch.render.pipeline import reduce_entry_grads
from gausplat_tpu_torch.testing import assert_packed_grads_close

from tests.test_scale import _make_reduce_case
from tests.torch_helpers import MEDIUM, SMALL, SCALED_ATOL, scene_arrays, views

CASES = {"small": SMALL, "medium": MEDIUM}


def _u32(*patterns):
    return np.array(patterns, np.uint32).view(np.float32)


#: f32 values at every edge of the half-up rounding on the bit pattern.
EDGES = _u32(
    0x3F808000, 0x3F818000, 0xBF808000, 0x40490000 | 0x8000,  # exact ties
    0x3F7FFFFF, 0x3F7F8000, 0x407FFFFF, 0x007FFFFF,  # carries into the exponent
    0x7F7FFFFF, 0xFF7FFFFF,  # +-FLT_MAX: round to +-inf
    0x7F800000, 0xFF800000,  # +-inf
    0x7F800001, 0x7FC00000, 0x7FFF7FFF, 0x7FFF8000, 0x7FFFFFFF,  # NaN payloads
    0xFFC00000, 0xFFFF7FFF, 0xFFFF8000, 0xFFFFFFFF,
    0x00000001, 0x00008000, 0x0000FFFF, 0x80000001, 0x807FFFFF,  # subnormals
    0x80000000, 0x00000000,  # -0.0, +0.0
)


def _values(n=4096, seed=0):
    """The edges and random f32 bit patterns of every magnitude."""
    rng = np.random.default_rng(seed)
    random = (rng.standard_normal(n) * 10.0 ** rng.uniform(-40, 38, n)).astype(np.float32)
    ties = (rng.integers(0, 1 << 16, n, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    return np.concatenate([EDGES, random, ties])


def _bits(x):
    return np.asarray(x).view(np.int32)


def test_pack_pair_matches_jax_bit_for_bit():
    a = _values()
    b = np.random.default_rng(1).permutation(a)
    want = np.asarray(jblend.pack_pair(jnp.asarray(a), jnp.asarray(b)))
    got = tblend.pack_pair(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # The wraps that the int32 add makes, pinned.
    hi = tblend.pack_pair(torch.as_tensor(EDGES), torch.zeros(len(EDGES))).numpy().view(np.uint32)
    table = dict(zip(EDGES.view(np.uint32).tolist(), hi.tolist()))
    assert table[0x7F7FFFFF] == 0x7F800000 and table[0xFF7FFFFF] == 0xFF800000
    assert table[0x7FFF7FFF] == 0x7FFF0000 and table[0x7FFF8000] == 0x80000000
    assert table[0xFFFF8000] == 0x00000000 and table[0x3F7FFFFF] == 0x3F800000
    assert table[0x3F808000] == 0x3F810000 and table[0x80000000] == 0x80000000


def test_unpack_matches_jax_bit_for_bit():
    words = np.concatenate([_bits(_values()), _bits(EDGES)[::-1]])
    for name in ("unpack_hi", "unpack_lo"):
        want = np.asarray(getattr(jblend, name)(jnp.asarray(words)))
        got = getattr(tblend, name)(torch.as_tensor(words)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def _random_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((9, n)) * 10.0 ** rng.uniform(-3, 3, (9, 1))).astype(np.float32)
    rows[:, :len(EDGES)] = EDGES[None, : min(n, len(EDGES))]
    return rows


def test_row_codecs_match_jax():
    rows = _random_rows(300, 2)
    # Entries: JAX's packed layout from its pack_pair, decoded by both.
    c = [jnp.asarray(r) for r in rows]
    jwords = jnp.stack([jblend.pack_pair(c[0], c[1]), jblend.pack_pair(c[2], c[6]),
                        jblend.pack_pair(c[3], c[4]),
                        jblend.pack_pair(c[5], jnp.zeros_like(c[5])),
                        jblend._bits(c[7]), jblend._bits(c[8])])
    words = tblend.pack_rows(torch.as_tensor(rows))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    want = jblend.entries_from_rows(jwords, True)
    got = tblend.entries_from_rows(words[:, None])
    for field in want._fields:
        np.testing.assert_array_equal(_bits(getattr(got, field)[0].numpy()),
                                      _bits(getattr(want, field)), err_msg=field)
    # Gradients: the same EntryGrads encoded by both, and decoded back.
    jgrads = jblend.EntryGrads(color=jnp.asarray(rows[0:3].T), conic=jnp.asarray(rows[3:6].T),
                               opacity=jnp.asarray(rows[6:7].T), pos_2d=jnp.asarray(rows[7:9].T))
    tgrads = tblend.EntryGrads(*(torch.as_tensor(np.array(f))[None] for f in jgrads))
    jrows = jblend.grads_to_rows(jgrads, True)
    trows = tblend.grads_to_rows(tgrads, packed=True)[:, 0]
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    for r, (g, w) in enumerate(zip(tblend.grad_rows_to_components(trows),
                                   jblend.grad_rows_to_components(jrows, True))):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"component {r}")
    # f32 rows pass through unchanged.
    f32 = tblend.grad_rows_to_components(torch.as_tensor(rows))
    np.testing.assert_array_equal(torch.stack(f32).numpy(), rows)


@functools.lru_cache(maxsize=None)
def _jax_rasterizers(block, num_tiles, tile_count_x):
    """``rasterize_forward_xla`` and ``rasterize_backward_xla`` on packed
    rows, jitted (their lax.scan runs op by op otherwise)."""

    def stream(rows, ids, ranges):
        return jras.build_entry_stream(rows, ids, ranges, block_size=block, packed=True)

    def forward(rows, ids, ranges):
        out = jras.rasterize_forward_xla(stream(rows, ids, ranges), num_tiles=num_tiles,
                                         tile_count_x=tile_count_x)
        return jras.mask_empty_tiles(*out, ranges)

    def backward(rows, ids, ranges, grad_tiles, gdotc, counts):
        return jras.rasterize_backward_xla(stream(rows, ids, ranges), grad_tiles, gdotc, counts,
                                           tile_count_x=tile_count_x)

    return jax.jit(forward), jax.jit(backward)


def _jax_pieces(case, position=(0.3, -0.2, -4.0)):
    """The JAX package's packed rows and binning of a case, its packed
    rasterizers, and the rows and binning as torch tensors."""
    c = CASES[case]
    a = scene_arrays(c["p"])
    jview, _ = views(c["width"], c["height"], position=position)
    tcx, tcy = -(-c["width"] // 16), -(-c["height"] // 16)
    capacity = c["capacity"] or 1 << 14
    proj = jax_project(
        *(jnp.asarray(a[k]) for k in ("colors_sh", "positions", "rotations", "scalings")),
        JCamera.from_view(jview), sh_degree=3, tile_count_x=tcx, tile_count_y=tcy,
        opacities=jnp.asarray(a["opacities"]), tight_culling=True,
    )
    binning = jax_bin(proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
                      proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity)
    rows = jras.pack_point_data(proj, jax.nn.sigmoid(jnp.asarray(a["opacities"][:, 0])), True)
    jargs = (rows, binning.point_indices, binning.tile_ranges)
    torch_args = [torch.as_tensor(np.array(x)) for x in jargs]
    return c, jargs, _jax_rasterizers(c["block"], tcx * tcy, tcx), binning, torch_args, tcx, tcy


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_packed_forward_matches_xla(case):
    c, jargs, (forward, _), binning, args, tcx, tcy = _jax_pieces(case)
    want = forward(*jargs)
    got = tras.rasterize_forward(*args, tile_count_x=tcx, block_size=c["block"])
    assert args[0].dtype == torch.int32 and args[0].shape[0] == 6
    assert int(binning.total) > 100
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # The packed rows blend as their decoded f32 rows do (the CPU's matmul
    # may round by alignment, so the floats within 1e-6).
    f32 = tras.rasterize_forward(tblend.unpack_rows(args[0]), *args[1:], tile_count_x=tcx,
                                 block_size=c["block"])
    torch.testing.assert_close(got[0], f32[0], atol=1e-6, rtol=0)
    assert torch.equal(got[2], f32[2])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_packed_backward_matches_xla(case):
    c, jargs, (_, backward), binning, args, tcx, tcy = _jax_pieces(case)
    image, _, counts = tras.rasterize_forward(*args, tile_count_x=tcx, block_size=c["block"])
    gimg = np.random.default_rng(11).standard_normal((c["height"], c["width"], 3))
    gtiles = tras.tile_image(torch.as_tensor(gimg.astype(np.float32)), tcx, tcy)
    gdotc = torch.sum(gtiles * image, dim=1)
    want = backward(*jargs, *(jnp.asarray(t.numpy()) for t in (gtiles, gdotc, counts)))
    got = tras.rasterize_backward(*args, gtiles, gdotc, counts, tile_count_x=tcx,
                                  block_size=c["block"])
    capacity = args[1].shape[0]
    assert got.dtype == torch.int32 and got.shape == (6, capacity)
    valid = min(int(binning.total), capacity)
    rec = assert_packed_grads_close(got[:, :valid], torch.as_tensor(np.asarray(want)[:, :valid]),
                                    SCALED_ATOL)
    assert rec["bf16_flips"] <= 0.05 * rec["bf16_elements"], rec
    assert (got[:, valid:] == 0).all()


def test_reduce_packed_grads_is_exact():
    rng = np.random.default_rng(17)
    point_count, capacity = 3_000, 1 << 15
    sorted_pids, offsets, comp, total = _make_reduce_case(rng, point_count, capacity, rows=9)
    comp = np.nan_to_num(comp, nan=0.0)
    words = tblend.pack_rows(torch.as_tensor(comp))
    # Slots past the total hold whatever the kernel left there.
    words[:, total:] = torch.as_tensor(
        rng.integers(-(2**31), 2**31 - 1, (6, capacity - total), np.int64).astype(np.int32))
    got = reduce_entry_grads(words, torch.as_tensor(sorted_pids), torch.as_tensor(offsets),
                             torch.tensor(total, dtype=torch.int32), capacity)
    assert got.shape == (9, point_count)
    valid = sorted_pids[:total]
    for r in range(9):
        want = np.zeros(point_count, np.float64)
        np.add.at(want, valid, comp[r, :total].astype(np.float64))
        np.testing.assert_array_equal(got[r].numpy(), want.astype(np.float32), err_msg=f"row {r}")
