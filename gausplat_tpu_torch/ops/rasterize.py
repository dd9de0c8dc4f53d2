"""Tile rasterization, forward and backward: the hand-written CUDA kernels,
their plain versions, and the tiled <-> image layout helpers.

Counterpart of ``gausplat_tpu/ops/rasterize.py``. Reference:
.../jit/kernel/rasterize/kernel.wgsl:60-221 (one workgroup per 16x16 tile,
shared-memory entry batches, per-pixel front-to-back blend, whole-tile
early exit) and .../jit/kernel/rasterize_backward/kernel.wgsl:71-274.

- :func:`rasterize_forward` is the kernel's wrapper
  (``csrc/rasterize_forward.cu``, one 256-thread CTA per tile). It takes
  the per-point rows and the sorted point ids and gathers each entry's
  data itself.
- :func:`rasterize_forward_torch` is its plain version: the JAX package's
  batched form, with each tile's range cut into windows aligned to
  ``block_size`` blocks of the sorted entries (the windows of the JAX
  step list), blended through :mod:`gausplat_tpu_torch.ops.blend`
  vectorized over tiles.
- :func:`rasterize_backward` is the backward kernel's wrapper
  (``csrc/rasterize_backward.cu``, one 256-thread CTA per tile, replaying
  the forward in order); :func:`rasterize_backward_torch` is its plain
  version, with the same windows, carrying
  :class:`~gausplat_tpu_torch.ops.blend.BackwardState` across them.
- Both kernels skip the (entry, warp) pairs outside the entry's footprint
  (``csrc/tile_batch.cuh``); :func:`footprint_warp_masks` and
  :func:`entry_warp_masks` are its plain version, for the tests and
  reports. The plain rasterizers evaluate every pair.
- Both take the per-point rows in either layout of
  :mod:`gausplat_tpu_torch.ops.blend`: f32 ``[9, P + 1]``, or packed int32
  ``[6, P + 1]`` (``RenderOptions(entry_dtype="bf16")``). Each kernel
  library has an entry point per layout (a template over it); the packed
  one decodes each staged entry into the same nine floats, and the
  backward encodes its gradient rows in the packed layout. The plain
  versions decode, blend in f32, and encode.

Outputs keep the JAX tiled layout: image ``[T, 3, 256]``, transmittance
``[T, 256]``, rendered count ``[T, 256]``; the backward gives per-entry
gradient rows ``[9, capacity]`` (f32) or ``[6, capacity]`` (packed) at the
sorted positions.
"""

from __future__ import annotations

import torch

from ..constants import (
    OPACITY_2D_MAX,
    OPACITY_2D_MIN,
    TILE_SIZE_X,
    TILE_SIZE_Y,
    TRANSMITTANCE_MIN,
)
from ..utils.kernels import F32, I32, I64, PTR, CudaKernel, require_cuda, stream_of
from .blend import (
    _OPACITY_MIN,
    ENTRY_ROWS_F32,
    ENTRY_ROWS_PACKED,
    BackwardState,
    EntryBlock,
    ForwardState,
    backward_batch,
    decode_rows,
    forward_batch,
    grads_to_rows,
    is_packed,
    pack_rows,
)

PIXELS_PER_TILE = TILE_SIZE_X * TILE_SIZE_Y  # 256

#: Default entries per window of the plain version (the kernel always
#: stages 256, one per thread).
DEFAULT_BLOCK_SIZE = 256

_FORWARD_ARGS = [PTR, I64, PTR, PTR, I32, I32, F32, F32, F32, PTR, PTR, PTR, PTR]
_BACKWARD_ARGS = [PTR, I64, PTR, PTR, I32, I32, PTR, PTR, PTR, F32, F32, I64, PTR, PTR]

#: The kernels and their launch counts: one entry point per row layout in
#: each library (f32 rows, packed rows).
RASTERIZE_FORWARD = CudaKernel(
    "rasterize_forward.cu", "gs_rasterize_forward", _FORWARD_ARGS)
RASTERIZE_FORWARD_PACKED = CudaKernel(
    "rasterize_forward.cu", "gs_rasterize_forward_packed", _FORWARD_ARGS,
    info_entry="gs_kernel_info_packed")
RASTERIZE_BACKWARD = CudaKernel(
    "rasterize_backward.cu", "gs_rasterize_backward", _BACKWARD_ARGS)
RASTERIZE_BACKWARD_PACKED = CudaKernel(
    "rasterize_backward.cu", "gs_rasterize_backward_packed", _BACKWARD_ARGS,
    info_entry="gs_kernel_info_packed")


def pack_point_data(proj, opacities_outer: torch.Tensor) -> torch.Tensor:
    """Per-point rasterization inputs as f32 rows ``[9, P + 1]``; the last
    column is the zero padding point (id P). ``blend.pack_rows`` of them
    gives the packed layout ``[6, P + 1]``."""
    rows = torch.stack(
        [
            proj.color_r, proj.color_g, proj.color_b,
            proj.conic_xx, proj.conic_xy, proj.conic_yy,
            opacities_outer,
            proj.pos2d_x, proj.pos2d_y,
        ]
    ).to(torch.float32)
    return torch.nn.functional.pad(rows, (0, 1))


def pixel_coords(tiles: torch.Tensor, tile_count_x: int):
    """Pixel coordinates ``[n, 1, 256]`` (float32) of tiles ``[n]``, lane
    order ``ly * 16 + lx``."""
    lane = torch.arange(PIXELS_PER_TILE, device=tiles.device)
    tx = (tiles % tile_count_x)[:, None]
    ty = (tiles // tile_count_x)[:, None]
    pix_x = (tx * TILE_SIZE_X + lane % TILE_SIZE_X).to(torch.float32)
    pix_y = (ty * TILE_SIZE_Y + lane // TILE_SIZE_X).to(torch.float32)
    return pix_x[:, None, :], pix_y[:, None, :]


#: Warps per tile; warp w holds the 16x2 strip of rows 2w and 2w + 1.
WARPS_PER_TILE = PIXELS_PER_TILE // 32
FULL_WARP_MASK = (1 << WARPS_PER_TILE) - 1

#: Margins of the footprint, derived in ``csrc/tile_batch.cuh``: absolute
#: on the exponent bound and a factor on it, per unit of the conic's
#: tr^2 / det, and in pixels on each half-extent (f32 values).
FOOTPRINT_MARGIN_Q_ABS = 1e-5
FOOTPRINT_MARGIN_Q_SCALE = 1.0001
FOOTPRINT_MARGIN_COND = 1e-6
FOOTPRINT_MARGIN_PIXELS = 1e-3


def footprint_warp_masks(rows: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' footprint
    (``csrc/tile_batch.cuh::entry_warp_mask``): the same f32 operations in
    the same order, the determinant from float64 products.

    ``rows`` [9, n] f32 are entries in the canonical row order, ``x0``,
    ``y0`` [n] the top-left pixels of their tiles. Returns [n] uint8: bit w
    set where warp w of the tile may blend the entry (the strips that the
    entry's alpha >= 1/255 ellipse, boxed and widened by the margins,
    reaches); 0 for an opacity below 1/255; every bit for a conic that is
    not positive definite or too near singular, or any value that is not
    finite.
    """
    cxx, cxy, cyy, opacity, px, py = rows[3], rows[4], rows[5], rows[6], rows[7], rows[8]
    wide = rows.to(torch.float64)
    det = (wide[3] * wide[5] - wide[4] * wide[4]).to(torch.float32)
    tr = cxx + cyy
    cond = FOOTPRINT_MARGIN_COND * (tr * tr / det)
    full = ~(torch.isfinite(rows[3:9]).all(dim=0) & (cxx > 0) & (det > 0)
             & torch.isfinite(det) & (cond < 0.5))
    q_max = 2.0 * torch.log(opacity / _OPACITY_MIN)
    q = (q_max + FOOTPRINT_MARGIN_Q_ABS) * FOOTPRINT_MARGIN_Q_SCALE / (1.0 - cond)
    half_x = torch.sqrt(q * cyy / det) + FOOTPRINT_MARGIN_PIXELS
    half_y = torch.sqrt(q * cxx / det) + FOOTPRINT_MARGIN_PIXELS
    cx = px - x0.to(torch.float32)
    cy = py - y0.to(torch.float32)
    col_lo = torch.clamp_min(torch.ceil(cx - half_x), 0.0)
    col_hi = torch.clamp_max(torch.floor(cx + half_x), TILE_SIZE_X - 1.0)
    row_lo = torch.clamp_min(torch.ceil(cy - half_y), 0.0)
    row_hi = torch.clamp_max(torch.floor(cy + half_y), TILE_SIZE_Y - 1.0)
    w = torch.arange(WARPS_PER_TILE, dtype=torch.float32, device=rows.device)[:, None]
    strips = (w >= torch.floor(row_lo / 2)) & (w <= torch.floor(row_hi / 2)) & (col_lo <= col_hi)
    weights = (1 << torch.arange(WARPS_PER_TILE, device=rows.device))[:, None]
    mask = torch.sum(strips * weights, dim=0)
    mask = torch.where(full, FULL_WARP_MASK, mask)
    mask = torch.where(opacity < _OPACITY_MIN, 0, mask)
    return mask.to(torch.uint8)


def entry_warp_masks(
    point_rows: torch.Tensor,
    sorted_ids: torch.Tensor,
    tile_ranges: torch.Tensor,
    *,
    tile_count_x: int,
) -> torch.Tensor:
    """The kernels' warp mask of every entry in its tile: ``[capacity]``
    uint8 at the sorted positions, 0 outside every tile's range. Used to
    test and report the skip; the kernels compute it themselves, from the
    decoded values where the rows are packed."""
    r0 = tile_ranges[:, 0].to(torch.int64)
    lengths = (tile_ranges[:, 1].to(torch.int64) - r0).clamp_min(0)
    device = point_rows.device
    tiles = torch.repeat_interleave(torch.arange(lengths.shape[0], device=device), lengths)
    starts = torch.cumsum(lengths, 0) - lengths
    slots = r0[tiles] + torch.arange(tiles.shape[0], device=device) - starts[tiles]
    masks = footprint_warp_masks(
        decode_rows(point_rows[:, sorted_ids[slots].long()]),
        (tiles % tile_count_x) * TILE_SIZE_X,
        (tiles // tile_count_x) * TILE_SIZE_Y,
    )
    out = torch.zeros(sorted_ids.shape[0], dtype=torch.uint8, device=device)
    out[slots] = masks
    return out


def _windows(tile_ranges: torch.Tensor, b: int):
    """Per tile: segment start and end, first block, and window count, for
    windows that are ``b``-aligned blocks of the sorted entries."""
    r0 = tile_ranges[:, 0].to(torch.int64)
    r1 = tile_ranges[:, 1].to(torch.int64)
    nonempty = r1 > r0
    first_blk = torch.div(r0, b, rounding_mode="floor")
    last_blk = torch.where(
        nonempty, torch.div(r1 - 1, b, rounding_mode="floor"), first_blk
    )
    steps = torch.where(nonempty, last_blk - first_blk + 1, torch.zeros_like(r0))
    return r0, r1, first_blk, steps


def rasterize_forward_torch(
    point_rows: torch.Tensor,
    sorted_ids: torch.Tensor,
    tile_ranges: torch.Tensor,
    *,
    tile_count_x: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    tile_chunk: int = 1024,
):
    """Plain version of the forward kernel.

    Window ``k`` of a tile is block ``r0 // block_size + k`` of the sorted
    entries, masked to ``[r0, r1)``; all tiles that have a window ``k``
    are blended together, ``tile_chunk`` tiles at a time to bound memory.
    Packed rows are decoded first; the blend is f32 either way.
    Returns ``(image [T, 3, 256], transmittance [T, 256], counts [T, 256])``.
    """
    b = block_size
    capacity = sorted_ids.shape[0]
    if capacity % b:
        raise ValueError(f"capacity {capacity} is not a multiple of block_size {b}")
    point_rows = decode_rows(point_rows)
    device = point_rows.device
    num_tiles = tile_ranges.shape[0]
    r0, r1, first_blk, steps = _windows(tile_ranges, b)

    state = ForwardState.initial(num_tiles, PIXELS_PER_TILE, device)
    lane = torch.arange(b, device=device)
    n_steps = int(steps.max()) if num_tiles else 0
    for k in range(n_steps):
        active = torch.nonzero(steps > k).flatten()
        for tiles in torch.split(active, tile_chunk):
            blk = first_blk[tiles] + k
            slots = blk[:, None] * b + lane  # [n, B]
            mask = (slots >= r0[tiles, None]) & (slots < r1[tiles, None])
            entries = EntryBlock.from_rows(point_rows[:, sorted_ids[slots].long()])
            pix_x, pix_y = pixel_coords(tiles, tile_count_x)
            new = forward_batch(
                ForwardState(*(field[tiles] for field in state)),
                entries,
                pix_x,
                pix_y,
                (blk * b - r0[tiles])[:, None, None],
                mask[..., None],
            )
            for field, value in zip(state, new):
                field[tiles] = value
    return state.color, state.transmittance[:, 0], state.rendered_count[:, 0]


def _check_entry_inputs(point_rows, sorted_ids, tile_ranges, **per_tile) -> int:
    """Check the kernels' shared arguments (the rows f32 ``[9, P + 1]`` or
    packed int32 ``[6, P + 1]``), and any ``[T, ...]`` per-tile tensors
    given as ``name=(tensor, dtype, shape)``; returns T."""
    num_tiles = tile_ranges.shape[0]
    packed = is_packed(point_rows)
    rows = ENTRY_ROWS_PACKED if packed else ENTRY_ROWS_F32
    require_cuda("point_rows", point_rows, torch.int32 if packed else torch.float32)
    if point_rows.dim() != 2 or point_rows.shape[0] != rows:
        raise ValueError(f"point_rows: expected [{rows}, P + 1] for {point_rows.dtype}, "
                         f"got {tuple(point_rows.shape)}")
    require_cuda("sorted_ids", sorted_ids, torch.int32, (sorted_ids.shape[0],))
    require_cuda("tile_ranges", tile_ranges, torch.int32, (num_tiles, 2))
    others = {"sorted_ids": sorted_ids, "tile_ranges": tile_ranges}
    for name, (t, dtype, shape) in per_tile.items():
        require_cuda(name, t, dtype, shape)
        others[name] = t
    for name, t in others.items():
        if t.device != point_rows.device:
            raise ValueError(f"{name} is on {t.device}, point_rows on {point_rows.device}")
    return num_tiles


def _kernel_for(point_rows, kernel, f32_kernel, packed_kernel) -> CudaKernel:
    """The entry point for the rows' layout: ``kernel`` if given (another
    build of it), which must be the one for that layout."""
    want = packed_kernel if is_packed(point_rows) else f32_kernel
    if kernel is None:
        return want
    if kernel.entry != want.entry:
        raise ValueError(f"{kernel.entry} does not take {point_rows.dtype} rows "
                         f"({want.entry} does)")
    return kernel


def rasterize_forward(
    point_rows: torch.Tensor,
    sorted_ids: torch.Tensor,
    tile_ranges: torch.Tensor,
    *,
    tile_count_x: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    kernel: CudaKernel | None = None,
):
    """Forward rasterization of every tile, from rows of either layout.

    CPU tensors go to :func:`rasterize_forward_torch` (``block_size`` sets
    its windows); CUDA tensors launch the entry point for the rows' layout
    (:data:`RASTERIZE_FORWARD` or :data:`RASTERIZE_FORWARD_PACKED`, or
    ``kernel``, another build of it that a caller measures), and anything
    the kernel does not take raises.
    """
    if point_rows.device.type == "cpu":
        return rasterize_forward_torch(
            point_rows, sorted_ids, tile_ranges,
            tile_count_x=tile_count_x, block_size=block_size,
        )
    num_tiles = _check_entry_inputs(point_rows, sorted_ids, tile_ranges)
    kernel = _kernel_for(point_rows, kernel, RASTERIZE_FORWARD, RASTERIZE_FORWARD_PACKED)
    device = point_rows.device
    image = torch.empty((num_tiles, 3, PIXELS_PER_TILE), dtype=torch.float32, device=device)
    trans = torch.empty((num_tiles, PIXELS_PER_TILE), dtype=torch.float32, device=device)
    counts = torch.empty((num_tiles, PIXELS_PER_TILE), dtype=torch.int32, device=device)
    kernel.launch(
        point_rows.data_ptr(), point_rows.shape[1], sorted_ids.data_ptr(),
        tile_ranges.data_ptr(), num_tiles, tile_count_x, OPACITY_2D_MAX,
        OPACITY_2D_MIN, TRANSMITTANCE_MIN, image.data_ptr(), trans.data_ptr(),
        counts.data_ptr(), stream_of(point_rows),
    )
    return image, trans, counts


def rasterize_backward_torch(
    point_rows: torch.Tensor,
    sorted_ids: torch.Tensor,
    tile_ranges: torch.Tensor,
    grad_tiles: torch.Tensor,
    gdotc_tiles: torch.Tensor,
    count_tiles: torch.Tensor,
    *,
    tile_count_x: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    tile_chunk: int = 512,
) -> torch.Tensor:
    """Plain version of the backward kernel, with the windows of
    :func:`rasterize_forward_torch`; ``BackwardState`` carries each tile's
    running transmittance and ``<g, prefix>`` from window to window.

    ``grad_tiles`` [T, 3, 256] is dL/d(image), ``gdotc_tiles`` [T, 256]
    ``<g, C_final>``, ``count_tiles`` [T, 256] the forward's counts.
    Returns per-entry gradient rows at the sorted positions in the layout
    of ``point_rows``: f32 ``[9, capacity]``, or packed int32 ``[6,
    capacity]`` (the f32 gradients encoded with ``grads_to_rows(...,
    packed=True)``); slots outside every tile's range stay zero.
    """
    b = block_size
    capacity = sorted_ids.shape[0]
    if capacity % b:
        raise ValueError(f"capacity {capacity} is not a multiple of block_size {b}")
    packed = is_packed(point_rows)
    point_rows = decode_rows(point_rows)
    device = point_rows.device
    num_tiles = tile_ranges.shape[0]
    r0, r1, first_blk, steps = _windows(tile_ranges, b)

    out = torch.zeros((ENTRY_ROWS_F32, capacity), dtype=torch.float32, device=device)
    state = BackwardState.initial(num_tiles, PIXELS_PER_TILE, device)
    lane = torch.arange(b, device=device)
    n_steps = int(steps.max()) if num_tiles else 0
    for k in range(n_steps):
        active = torch.nonzero(steps > k).flatten()
        for tiles in torch.split(active, tile_chunk):
            blk = first_blk[tiles] + k
            slots = blk[:, None] * b + lane  # [n, B]
            mask = (slots >= r0[tiles, None]) & (slots < r1[tiles, None])
            entries = EntryBlock.from_rows(point_rows[:, sorted_ids[slots].long()])
            pix_x, pix_y = pixel_coords(tiles, tile_count_x)
            new, grads = backward_batch(
                BackwardState(*(field[tiles] for field in state)),
                entries,
                pix_x,
                pix_y,
                (blk * b - r0[tiles])[:, None, None],
                grad_tiles[tiles],
                gdotc_tiles[tiles, None, :],
                count_tiles[tiles, None, :],
                mask[..., None],
            )
            for field, value in zip(state, new):
                field[tiles] = value
            out[:, slots[mask]] = grads_to_rows(grads)[:, mask]
    return pack_rows(out) if packed else out


def rasterize_backward(
    point_rows: torch.Tensor,
    sorted_ids: torch.Tensor,
    tile_ranges: torch.Tensor,
    grad_tiles: torch.Tensor,
    gdotc_tiles: torch.Tensor,
    count_tiles: torch.Tensor,
    *,
    tile_count_x: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    kernel: CudaKernel | None = None,
) -> torch.Tensor:
    """Backward rasterization of every tile: per-entry gradient rows at the
    sorted positions, in the layout of ``point_rows`` (f32 ``[9,
    capacity]`` or packed int32 ``[6, capacity]``).

    CPU tensors go to :func:`rasterize_backward_torch`; CUDA tensors launch
    the entry point for the rows' layout (:data:`RASTERIZE_BACKWARD` or
    :data:`RASTERIZE_BACKWARD_PACKED`, or ``kernel``, another build of it
    that a caller measures), and anything the kernel does not take raises.
    The kernel writes the slots of every tile's range and no other, so
    slots at or past ``min(total, capacity)`` hold whatever the allocator
    left there: callers read only the slots below it.
    """
    if point_rows.device.type == "cpu":
        return rasterize_backward_torch(
            point_rows, sorted_ids, tile_ranges, grad_tiles, gdotc_tiles, count_tiles,
            tile_count_x=tile_count_x, block_size=block_size,
        )
    t = tile_ranges.shape[0]
    _check_entry_inputs(
        point_rows, sorted_ids, tile_ranges,
        grad_tiles=(grad_tiles, torch.float32, (t, 3, PIXELS_PER_TILE)),
        gdotc_tiles=(gdotc_tiles, torch.float32, (t, PIXELS_PER_TILE)),
        count_tiles=(count_tiles, torch.int32, (t, PIXELS_PER_TILE)),
    )
    kernel = _kernel_for(point_rows, kernel, RASTERIZE_BACKWARD, RASTERIZE_BACKWARD_PACKED)
    capacity = sorted_ids.shape[0]
    out = torch.empty((point_rows.shape[0], capacity), dtype=point_rows.dtype,
                      device=point_rows.device)
    kernel.launch(
        point_rows.data_ptr(), point_rows.shape[1], sorted_ids.data_ptr(),
        tile_ranges.data_ptr(), t, tile_count_x, grad_tiles.data_ptr(),
        gdotc_tiles.data_ptr(), count_tiles.data_ptr(), OPACITY_2D_MAX,
        OPACITY_2D_MIN, capacity, out.data_ptr(), stream_of(point_rows),
    )
    return out


# --- tiled <-> image layout helpers --------------------------------------------


def mask_empty_tiles(image_tiles, trans_tiles, count_tiles, tile_ranges):
    """Force tiles with an empty range to the initial state (0, 1, 0).

    The JAX pipeline needs this because its Pallas kernel never visits an
    empty tile; both rasterizers here already write that state."""
    empty = tile_ranges[:, 0] >= tile_ranges[:, 1]
    return (
        torch.where(empty[:, None, None], torch.zeros_like(image_tiles), image_tiles),
        torch.where(empty[:, None], torch.ones_like(trans_tiles), trans_tiles),
        torch.where(empty[:, None], torch.zeros_like(count_tiles), count_tiles),
    )


def untile_image(image_tiles: torch.Tensor, tile_count_x: int, tile_count_y: int,
                 image_width: int, image_height: int) -> torch.Tensor:
    """[T, 3, 256] tiled layout -> [H, W, 3] image (cropped)."""
    img = image_tiles.reshape(tile_count_y, tile_count_x, 3, TILE_SIZE_Y, TILE_SIZE_X)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tile_count_y * TILE_SIZE_Y, tile_count_x * TILE_SIZE_X, 3
    )
    return img[:image_height, :image_width, :]


def untile_map(tiles: torch.Tensor, tile_count_x: int, tile_count_y: int,
               image_width: int, image_height: int) -> torch.Tensor:
    """[T, 256] tiled layout -> [H, W] map (cropped)."""
    m = tiles.reshape(tile_count_y, tile_count_x, TILE_SIZE_Y, TILE_SIZE_X)
    m = m.permute(0, 2, 1, 3).reshape(
        tile_count_y * TILE_SIZE_Y, tile_count_x * TILE_SIZE_X
    )
    return m[:image_height, :image_width]


def tile_image(image: torch.Tensor, tile_count_x: int, tile_count_y: int) -> torch.Tensor:
    """[H, W, 3] image -> [T, 3, 256] tiled layout (zero-padded)."""
    h, w = image.shape[0], image.shape[1]
    ph = tile_count_y * TILE_SIZE_Y
    pw = tile_count_x * TILE_SIZE_X
    padded = torch.nn.functional.pad(image, (0, 0, 0, pw - w, 0, ph - h))
    t = padded.reshape(tile_count_y, TILE_SIZE_Y, tile_count_x, TILE_SIZE_X, 3)
    return t.permute(0, 2, 4, 1, 3).reshape(
        tile_count_y * tile_count_x, 3, PIXELS_PER_TILE
    )
