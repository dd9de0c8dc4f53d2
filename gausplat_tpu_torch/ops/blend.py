"""Batched alpha-blend math: the plain version of both rasterizer kernels.

Counterpart of ``gausplat_tpu/ops/blend.py`` (``density_terms``,
``ForwardState``, ``forward_batch``, ``BackwardState``, ``EntryGrads``,
``backward_batch``, the bf16-pair codec and the row codecs
``entries_from_rows``, ``grads_to_rows``, ``grad_rows_to_components`` for
both row layouts). Reference loops:
.../jit/kernel/rasterize/kernel.wgsl:107-200 (forward) and
.../jit/kernel/rasterize_backward/kernel.wgsl:124-273 (backward).

A batch of ``B`` entries is blended at once against a tile's ``N`` = 256
pixels, for ``n`` tiles side by side:

- transmittance is an exclusive masked cumulative product of ``1 - alpha``
  along the entry axis, taken in log steps exactly as the JAX package
  does, so the two round alike;
- "stop before the transmittance drops below the floor" is the first
  crossing of the candidate transmittance below ``TRANSMITTANCE_MIN``,
  sticky across batches through ``done``;
- the backward runs in forward order: the colour behind entry n is
  ``<g, C_final> - <g, prefix_n>``, one cumulative sum, with ``C_final``
  the forward image. It replays the forward's rendered counts rather than
  deciding again where a pixel stopped.

The conic cotangent is the full one of (xx, xy, yy) as they enter
``cxx dx^2 + 2 cxy dx dy + cyy dy^2``: its xy component is twice the
reference's stored half-gradient (rasterize_backward/kernel.wgsl:249-251).

Layout: entry data ``[n, B, 1]`` columns, pixel data ``[n, 1, N]`` rows,
blend terms ``[n, B, N]``.

Row layouts (``RenderOptions.entry_dtype``): f32 rows ``[9, ...]`` in the
canonical order (r, g, b, cxx, cxy, cyy, opacity, px, py), or packed int32
rows ``[6, ...]``: ``[r|g, b|opacity, cxx|cxy, cyy|0, bits(px),
bits(py)]``, two bf16 values to a word (the high half of an f32 is its
bf16 truncation; packing rounds half up on the bit pattern) and the
positions as f32 bit patterns. The per-entry gradient rows use the same
layout, so one codec serves both. Packing is integer work and agrees with
the JAX package bit for bit, NaN and overflow included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import OPACITY_2D_MAX, OPACITY_2D_MIN, TRANSMITTANCE_MIN

# The thresholds as the float32 values the JAX package compares against.
_OPACITY_MAX = float(np.float32(OPACITY_2D_MAX))
_OPACITY_MIN = float(np.float32(OPACITY_2D_MIN))
_TRANSMITTANCE_MIN = float(np.float32(TRANSMITTANCE_MIN))

#: Rows of the two entry layouts.
ENTRY_ROWS_F32 = 9
ENTRY_ROWS_PACKED = 6


# --- bf16-pair packing ----------------------------------------------------------
#
# JAX adds 0x8000 to the int32 bit pattern and wraps; the arithmetic here
# runs in int64 and keeps the low 32 bits, which is the same wrap without
# relying on signed overflow: a NaN whose payload reaches 0x7FFF8000 becomes
# 0x80000000 (-0.0), and +-FLT_MAX rounds to +-inf, as in JAX.

_LOW32 = 0xFFFFFFFF
_HI16 = 0xFFFF0000


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its int32 bit pattern."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> f32."""
    return bits.to(torch.int32).contiguous().view(torch.float32)


def _round_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest-bf16 bit pattern in the high 16 bits (ties up), as
    int64 in [0, 2^32)."""
    return (_bits(x).to(torch.int64) + 0x8000) & _HI16


def pack_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one int32 word tensor (a in the high half, b in the
    low half)."""
    return _to_i32(_round_bf16_bits(a) | (_round_bf16_bits(b) >> 16))


def unpack_hi(word: torch.Tensor) -> torch.Tensor:
    return _f32(_to_i32(word.to(torch.int64) & _HI16))


def unpack_lo(word: torch.Tensor) -> torch.Tensor:
    return _f32(_to_i32((word.to(torch.int64) << 16) & _LOW32))


def pack_rows(rows: torch.Tensor) -> torch.Tensor:
    """f32 rows ``[9, ...]`` in the canonical order -> packed int32 rows
    ``[6, ...]`` (the entry layout and the gradient layout alike)."""
    return torch.stack([
        pack_pair(rows[0], rows[1]),
        pack_pair(rows[2], rows[6]),
        pack_pair(rows[3], rows[4]),
        pack_pair(rows[5], torch.zeros_like(rows[5])),
        _bits(rows[7]),
        _bits(rows[8]),
    ])


def unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """Packed int32 rows ``[6, ...]`` -> f32 rows ``[9, ...]``."""
    return torch.stack([
        unpack_hi(words[0]), unpack_lo(words[0]), unpack_hi(words[1]),
        unpack_hi(words[2]), unpack_lo(words[2]), unpack_hi(words[3]),
        unpack_lo(words[1]), _f32(words[4]), _f32(words[5]),
    ])


def is_packed(rows: torch.Tensor) -> bool:
    """Whether ``rows`` are in the packed layout (int32) or f32."""
    return rows.dtype == torch.int32


def decode_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows of either layout -> f32 rows ``[9, ...]``."""
    return unpack_rows(rows) if is_packed(rows) else rows


class EntryBlock(NamedTuple):
    """A batch of B entries for each of n tiles ([n, B, 1] columns)."""

    color: torch.Tensor  # [n, B, 3]
    conic_xx: torch.Tensor  # [n, B, 1]
    conic_xy: torch.Tensor
    conic_yy: torch.Tensor
    opacity: torch.Tensor  # outer (post-sigmoid) opacity
    pos_x: torch.Tensor
    pos_y: torch.Tensor

    @classmethod
    def from_rows(cls, rows: torch.Tensor) -> "EntryBlock":
        """From ``[9, n, B]`` rows in the canonical order
        (r, g, b, cxx, cxy, cyy, opacity, px, py)."""
        col = rows.unsqueeze(-1)
        return cls(
            color=rows[0:3].permute(1, 2, 0),
            conic_xx=col[3],
            conic_xy=col[4],
            conic_yy=col[5],
            opacity=col[6],
            pos_x=col[7],
            pos_y=col[8],
        )


def entries_from_rows(rows: torch.Tensor) -> EntryBlock:
    """An entry block from rows ``[R, n, B]`` of either layout (f32 ``[9, ...]``
    or packed int32 ``[6, ...]``, told apart by the dtype). The rasterizers
    decode whole rows with :func:`decode_rows`; this is the JAX package's
    per-block decoder, kept so the codec can be held against it."""
    return EntryBlock.from_rows(decode_rows(rows))


def _shift_down(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """Shift along the entry axis (-2) by ``s``, filling with ``fill``."""
    filler = torch.full(
        x.shape[:-2] + (s, x.shape[-1]), fill, dtype=x.dtype, device=x.device
    )
    return torch.cat([filler, x[..., :-s, :]], dim=-2)


def cumprod_points(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative product along the entry axis, in log steps
    (the JAX package's association order)."""
    n = x.shape[-2]
    s = 1
    while s < n:
        x = x * _shift_down(x, s, 1.0)
        s *= 2
    return x


def cumsum_points(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the entry axis, in log steps (the JAX
    package's association order)."""
    n = x.shape[-2]
    s = 1
    while s < n:
        x = x + _shift_down(x, s, 0.0)
        s *= 2
    return x


def density_terms(entries: EntryBlock, pix_x: torch.Tensor, pix_y: torch.Tensor):
    """Per-(entry, pixel) terms. ``pix_*``: [n, 1, N]. Returns [n, B, N]
    (dx, dy, density, alpha, blendable)."""
    dx = entries.pos_x - pix_x
    dy = entries.pos_y - pix_y
    quad = (
        entries.conic_xx * dx * dx
        + 2.0 * entries.conic_xy * dx * dy
        + entries.conic_yy * dy * dy
    )
    density = torch.exp(-0.5 * quad)
    in_range = density <= 1.0
    # torch.minimum propagates NaN, as jnp.minimum does.
    alpha = torch.minimum(entries.opacity * density, density.new_tensor(_OPACITY_MAX))
    blendable = in_range & (alpha >= _OPACITY_MIN)
    return dx, dy, density, alpha, blendable


class ForwardState(NamedTuple):
    """Per-pixel carry across batches ([n, ., N])."""

    color: torch.Tensor  # [n, 3, N] accumulated RGB
    transmittance: torch.Tensor  # [n, 1, N]
    done: torch.Tensor  # [n, 1, N] bool
    rendered_count: torch.Tensor  # [n, 1, N] int32

    @classmethod
    def initial(cls, n: int, pixels: int, device) -> "ForwardState":
        return cls(
            color=torch.zeros((n, 3, pixels), dtype=torch.float32, device=device),
            transmittance=torch.ones((n, 1, pixels), dtype=torch.float32, device=device),
            done=torch.zeros((n, 1, pixels), dtype=torch.bool, device=device),
            rendered_count=torch.zeros((n, 1, pixels), dtype=torch.int32, device=device),
        )


def forward_batch(
    state: ForwardState,
    entries: EntryBlock,
    pix_x: torch.Tensor,
    pix_y: torch.Tensor,
    base_position: torch.Tensor,
    entry_mask: torch.Tensor,
) -> ForwardState:
    """Blend one batch of B entries into N pixels (front to back).

    ``base_position``: [n, 1, 1] int, the segment position of the batch's
    lane 0 (negative when the segment starts mid-batch; such lanes are
    masked off by ``entry_mask`` [n, B, 1]).
    """
    b_pts = entries.opacity.shape[-2]

    _, _, _, alpha, blendable = density_terms(entries, pix_x, pix_y)
    blendable = blendable & entry_mask & ~state.done

    one_minus = torch.where(blendable, 1.0 - alpha, torch.ones_like(alpha))
    prod_incl = cumprod_points(one_minus)
    candidate_t = state.transmittance * prod_incl

    # The first crossing below the floor stops the pixel *before* blending
    # the crossing entry (rasterize/kernel.wgsl:178-185). candidate_t is
    # non-increasing along the entries, so "no crossing at or before n" is
    # one comparison.
    kept = candidate_t >= _TRANSMITTANCE_MIN
    blended = blendable & kept
    crossed = blendable & ~kept

    prod_excl = _shift_down(prod_incl, 1, 1.0) if b_pts > 1 else torch.ones_like(prod_incl)
    weight = torch.where(
        blended, alpha * state.transmittance * prod_excl, torch.zeros_like(alpha)
    )
    color = state.color + torch.matmul(entries.color.transpose(-1, -2), weight)
    # New transmittance: the candidate at the last kept entry (the minimum
    # over kept entries, by monotonicity), or unchanged.
    transmittance = torch.amin(
        torch.where(kept, candidate_t, state.transmittance), dim=-2, keepdim=True
    )
    done = state.done | torch.any(crossed, dim=-2, keepdim=True)

    positions = base_position + torch.arange(
        b_pts, dtype=base_position.dtype, device=base_position.device
    )[:, None]
    rendered = torch.amax(
        torch.where(blended, positions + 1, torch.zeros_like(positions)),
        dim=-2,
        keepdim=True,
    )
    rendered_count = torch.maximum(state.rendered_count, rendered.to(torch.int32))
    return ForwardState(
        color=color,
        transmittance=transmittance,
        done=done,
        rendered_count=rendered_count,
    )


class BackwardState(NamedTuple):
    """Per-pixel carry across batches of the backward ([n, 1, N])."""

    transmittance: torch.Tensor  # running t of the forward replay
    grad_prefix: torch.Tensor  # <g, prefix colour so far>

    @classmethod
    def initial(cls, n: int, pixels: int, device) -> "BackwardState":
        return cls(
            transmittance=torch.ones((n, 1, pixels), dtype=torch.float32, device=device),
            grad_prefix=torch.zeros((n, 1, pixels), dtype=torch.float32, device=device),
        )


class EntryGrads(NamedTuple):
    """Per-entry gradients of one batch ([n, B, .])."""

    color: torch.Tensor  # [n, B, 3]
    conic: torch.Tensor  # [n, B, 3] (xx, xy, yy), the full xy cotangent
    opacity: torch.Tensor  # [n, B, 1] with respect to the outer opacity
    pos_2d: torch.Tensor  # [n, B, 2]


def grads_to_rows(grads: EntryGrads, packed: bool = False) -> torch.Tensor:
    """Per-entry gradients as rows ``[R, n, B]``: f32 ``[9, ...]`` in the
    canonical order (r, g, b, cxx, cxy, cyy, opacity, px, py) or, with
    ``packed``, int32 ``[6, ...]`` in the packed layout."""
    cols = torch.cat([grads.color, grads.conic, grads.opacity, grads.pos_2d], dim=-1)
    rows = cols.permute(2, 0, 1)
    return pack_rows(rows) if packed else rows


def grad_rows_to_components(rows: torch.Tensor) -> tuple:
    """Gradient rows of either layout (told apart by the dtype) -> the 9 f32
    components in the canonical order."""
    rows = decode_rows(rows)
    return tuple(rows[c] for c in range(ENTRY_ROWS_F32))


def backward_batch(
    state: BackwardState,
    entries: EntryBlock,
    pix_x: torch.Tensor,
    pix_y: torch.Tensor,
    base_position: torch.Tensor,
    grad_color: torch.Tensor,
    grad_dot_final: torch.Tensor,
    rendered_count: torch.Tensor,
    entry_mask: torch.Tensor,
):
    """Backward of :func:`forward_batch`, in forward order.

    ``grad_color`` [n, 3, N] is dL/d(pixel colour); ``grad_dot_final``
    [n, 1, N] is ``<g, C_final>``; ``rendered_count`` [n, 1, N] the
    forward's counts. Returns ``(BackwardState, EntryGrads)``.
    """
    b_pts = entries.opacity.shape[-2]

    dx, dy, density, alpha, blendable = density_terms(entries, pix_x, pix_y)
    blendable = blendable & entry_mask
    positions = base_position + torch.arange(
        b_pts, dtype=base_position.dtype, device=base_position.device
    )[:, None]
    blended = blendable & (positions < rendered_count)

    one_minus = torch.where(blended, 1.0 - alpha, torch.ones_like(alpha))
    prod_incl = cumprod_points(one_minus)
    prod_excl = _shift_down(prod_incl, 1, 1.0) if b_pts > 1 else torch.ones_like(prod_incl)
    t_n = state.transmittance * prod_excl  # transmittance before entry n
    weight = torch.where(blended, alpha * t_n, torch.zeros_like(alpha))

    g_dot_c = torch.matmul(entries.color, grad_color)  # [n, B, N] <g, c_n>
    grad_prefix_n = state.grad_prefix + cumsum_points(weight * g_dot_c)
    g_dot_behind = grad_dot_final - grad_prefix_n  # <g, S_n>

    # dL/d alpha_n = t_n <g, c_n> - <g, S_n> / (1 - alpha_n)
    # (rasterize_backward/kernel.wgsl:197-221, in forward order).
    d_alpha = torch.where(
        blended, t_n * g_dot_c - g_dot_behind / one_minus, torch.zeros_like(alpha)
    )

    # k = -opacity * density * d_alpha; the conic is constant per entry, so
    # d_pos = C (sum_pix k d) is one [n, B, 1] combine after the sums.
    t0 = density * d_alpha
    d_opacity = torch.sum(t0, dim=-1, keepdim=True)
    k = t0 * (-entries.opacity)
    t1 = k * dx
    t2 = k * dy
    s_x = torch.sum(t1, dim=-1, keepdim=True)
    s_y = torch.sum(t2, dim=-1, keepdim=True)
    d_conic = torch.stack(
        [
            0.5 * torch.sum(t1 * dx, dim=-1),
            torch.sum(t1 * dy, dim=-1),  # the full xy cotangent
            0.5 * torch.sum(t2 * dy, dim=-1),
        ],
        dim=-1,
    )
    d_pos = torch.cat(
        [
            entries.conic_xx * s_x + entries.conic_xy * s_y,
            entries.conic_xy * s_x + entries.conic_yy * s_y,
        ],
        dim=-1,
    )
    d_color = torch.matmul(weight, grad_color.transpose(-1, -2))  # [n, B, 3]

    new_state = BackwardState(
        transmittance=state.transmittance * prod_incl[..., -1:, :],
        grad_prefix=state.grad_prefix + torch.sum(weight * g_dot_c, dim=-2, keepdim=True),
    )
    return new_state, EntryGrads(
        color=d_color, conic=d_conic, opacity=d_opacity, pos_2d=d_pos
    )
