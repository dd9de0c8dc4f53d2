"""Tile binning: expand, key, sort, segment.

Counterpart of ``gausplat_tpu/ops/binning.py``. Reference: rank
(tile-key expansion) .../jit/kernel/rank/kernel.wgsl:34-114, radix sort
.../jit/kernel/sort/radix/, segment .../jit/kernel/segment/kernel.2.wgsl.

- The (tile, point) entry buffers have a fixed ``capacity``; the true
  total stays on the device and is returned so callers can see overflow.
- Keys are the reference's u32 ``tile_index << 16 | depth16`` with the
  sign bit flipped, held in int32 tensors (``u32 ^ 0x80000000``): signed
  order is unsigned order, the transform the JAX package's
  ``sort_entries`` applies before its int32 sort. Pads are ``0x7FFFFFFF``
  (the u32 ``0xFFFFFFFF``) with point id P. :func:`keys_to_u32` and
  :func:`keys_from_u32` convert.
- Expansion on CUDA tensors is the hand-written kernel
  (:func:`gausplat_tpu_torch.ops.expand.fused_point_orders`);
  :func:`make_point_orders` here is its plain version.
- The sort is ``torch.sort(stable=True)`` on the int32 keys, and the tile
  ranges come from ``torch.searchsorted``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import DEPTH_ORDER_OFFSET

#: The sign bit a stored key flips.
SIGN_FLIP = 0x80000000
#: Key of a pad slot (sorts after every real key): the u32 ``0xFFFFFFFF``.
PAD_KEY = 0x7FFFFFFF


def keys_from_u32(u32: torch.Tensor) -> torch.Tensor:
    """Reference u32 keys (any integer tensor holding values in [0, 2^32))
    -> the stored int32 keys, ``u32 ^ 0x80000000`` as an int32."""
    return (u32.to(torch.int64) - SIGN_FLIP).to(torch.int32)


def keys_to_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stored int32 keys -> the reference's u32 keys, as int64 in [0, 2^32)
    (torch's uint32 arithmetic is patchy); compares with JAX's uint32 keys."""
    return keys.to(torch.int64) + SIGN_FLIP


class BinningOutput(NamedTuple):
    #: [capacity] int32 point ids sorted by (tile, depth); pads hold P.
    point_indices: torch.Tensor
    point_offsets: torch.Tensor  # [P] int32 inclusive cumsum of touched-tile counts
    tile_ranges: torch.Tensor  # [num_tiles, 2] int32 (start, end) into the above
    total: torch.Tensor  # [] int32 true number of entries (may exceed capacity)


def depth_to_order(depths: torch.Tensor) -> torch.Tensor:
    """Map depth in [2^-2, 2^14) to a monotone 16-bit integer (int64).

    The reference bit trick (rank/kernel.wgsl:112-114):
    ``(bits(depth) + ((3 << 23) + 0xc0000000)) >> 11`` with a wrapping u32
    add, done in int64 with ``& 0xFFFFFFFF``.
    """
    bits = depths.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    return ((bits + DEPTH_ORDER_OFFSET) & 0xFFFFFFFF) >> 11


def entry_total(offsets_inc: torch.Tensor) -> torch.Tensor:
    """The true entry count as a 0-d int32 tensor, without a host sync."""
    if offsets_inc.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=offsets_inc.device)
    return offsets_inc[-1]


def make_point_orders(
    depths: torch.Tensor,
    tile_x_max: torch.Tensor,
    tile_x_min: torch.Tensor,
    tile_y_min: torch.Tensor,
    tile_counts: torch.Tensor,
    *,
    tile_count_x: int,
    capacity: int,
):
    """Plain version of the expansion kernel: one (key, point) entry per
    touched tile of each point, at a fixed ``capacity``.

    Returns ``(keys [capacity] int32, src [capacity] int32, offsets_inc [P]
    int32, total [] int32)``, bit-identical to
    ``gausplat_tpu.ops.binning.make_point_orders`` with its uint32 keys
    stored as :func:`keys_from_u32` does.
    """
    p = depths.shape[0]
    device = depths.device
    offsets_inc = torch.cumsum(tile_counts.to(torch.int32), 0, dtype=torch.int32)
    total = entry_total(offsets_inc)
    if p == 0:
        keys = torch.full((capacity,), PAD_KEY, dtype=torch.int32, device=device)
        return keys, torch.zeros((capacity,), dtype=torch.int32, device=device), offsets_inc, total

    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    ends = offsets_inc.to(torch.int64)
    # The span holding each slot: the first point whose inclusive end
    # exceeds it (empty spans share their neighbour's end and are skipped).
    src = torch.searchsorted(ends, slots, right=True).clamp_max(p - 1)
    valid = slots < torch.clamp_max(total.to(torch.int64), capacity)

    width = torch.clamp_min(tile_x_max - tile_x_min, 1).to(torch.int64)[src]
    local = slots - (ends - tile_counts.to(torch.int64))[src]
    tile_x = tile_x_min.to(torch.int64)[src] + local % width
    tile_y = tile_y_min.to(torch.int64)[src] + local // width
    tile_index = tile_y * tile_count_x + tile_x
    keys = keys_from_u32(((tile_index << 16) & 0xFFFFFFFF) | (depth_to_order(depths)[src] & 0xFFFF))
    keys = torch.where(valid, keys, torch.full_like(keys, PAD_KEY))
    src = torch.where(valid, src, torch.full_like(src, p)).to(torch.int32)
    return keys, src, offsets_inc, total


def sort_entries(keys: torch.Tensor, point_indices: torch.Tensor):
    """Stable sort of (key, point-index) pairs by key; pads sort last.

    Stability keeps the point-id order among equal keys, as the reference's
    LSD radix sort does (sort/radix/mod.rs:43-155). On int32 keys a radix
    sort makes half the passes it makes on int64.
    """
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, point_indices[order]


def tile_ranges_from_keys(
    sorted_keys: torch.Tensor, total: torch.Tensor, *, num_tiles: int
) -> torch.Tensor:
    """Per-tile [start, end) ranges into the sorted entry list (int32).

    Empty tiles get an empty (s, s) range, equivalent to the reference's
    (0, 0) (segment/kernel.2.wgsl:40-51).
    """
    capacity = sorted_keys.shape[0]
    # The arithmetic shift keeps the flipped sign: (key >> 16) + 32768 is the
    # u32 key's top 16 bits, the tile id.
    tile_ids = (sorted_keys >> 16) + (SIGN_FLIP >> 16)
    queries = torch.arange(num_tiles, dtype=torch.int32, device=sorted_keys.device)
    ends = torch.searchsorted(tile_ids, queries, right=True)
    # Pads (key 0x7FFFFFFF, tile 0xFFFF) sort last; stability puts any real
    # tile-0xFFFF entries before them, so clamping by the true total is exact.
    ends = torch.minimum(ends, torch.clamp_max(total.to(torch.int64), capacity))
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return torch.stack([starts, ends], dim=-1).to(torch.int32)


def bin_gaussians(
    depths: torch.Tensor,
    tile_x_max: torch.Tensor,
    tile_x_min: torch.Tensor,
    tile_y_min: torch.Tensor,
    tile_counts: torch.Tensor,
    *,
    tile_count_x: int,
    tile_count_y: int,
    capacity: int,
    expand=make_point_orders,
) -> BinningOutput:
    """Expand -> sort -> segment.

    ``expand``: :func:`make_point_orders` or the kernel wrapper
    :func:`gausplat_tpu_torch.ops.expand.fused_point_orders` (same
    signature and outputs).
    """
    keys, src, offsets_inc, total = expand(
        depths, tile_x_max, tile_x_min, tile_y_min, tile_counts,
        tile_count_x=tile_count_x, capacity=capacity,
    )
    sorted_keys, sorted_points = sort_entries(keys, src)
    ranges = tile_ranges_from_keys(
        sorted_keys, total, num_tiles=tile_count_x * tile_count_y
    )
    return BinningOutput(
        point_indices=sorted_points,
        point_offsets=offsets_inc,
        tile_ranges=ranges,
        total=total,
    )
