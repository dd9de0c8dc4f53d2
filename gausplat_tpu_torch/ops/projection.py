"""Gaussian projection (the reference "transform" stage) in PyTorch.

Counterpart of ``gausplat_tpu/ops/projection.py``; reference math in
src/render/gaussian_3d/jit/kernel/transform/kernel.wgsl:117-418.

Layout: structure-of-arrays. Every per-point quantity is a 1-D ``[P]``
float32 tensor and every operation is elementwise; the 3x3 / 2x3 matrix
algebra is expanded into scalar component formulas in the same order as
the JAX package, so the two agree to float32 rounding. No kernel is hand
written here: the JAX package left this stage to XLA, and the port leaves
it to PyTorch's elementwise operators.

The forward render carries no autograd graph in this slice; the
projection is written in differentiable torch ops so the training slice
can take its VJP by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import (
    DEPTH_MAX,
    DEPTH_MIN,
    FACTOR_RADIUS,
    FILTER_LOW_PASS,
    SH_COEF,
    TILE_SIZE_X,
    TILE_SIZE_Y,
)

_SH_C0 = tuple(float(np.float32(c)) for c in SH_COEF[0])
_SH_C1 = tuple(float(np.float32(c)) for c in SH_COEF[1])
_SH_C2 = tuple(float(np.float32(c)) for c in SH_COEF[2])
_SH_C3 = tuple(float(np.float32(c)) for c in SH_COEF[3])


@dataclasses.dataclass
class Camera:
    """Per-view camera quantities, float32 tensors on one device.

    Derived on the host from a :class:`~gausplat_tpu_torch.render.view.View`
    exactly as the reference orchestrator does (jit/mod.rs:42-76).
    """

    focal_length: torch.Tensor  # [2]  I / (2 tan(fov/2))
    image_size_half: torch.Tensor  # [2]  I / 2
    view_bound: torch.Tensor  # [2]  tan(fov/2) * (C_f + 1)
    view_position: torch.Tensor  # [3]
    view_rotation: torch.Tensor  # [3, 3] row-major operator: p_v = R @ p + t
    view_translation: torch.Tensor  # [3]
    #: Optional [2] screen-space origin shift (tile sharding: the slab's
    #: pixel offset), subtracted from the full-frame ``pos2d``. An integer
    #: pixel offset subtracts exactly in f32, so a slab render is bitwise
    #: the matching rows of the full frame wherever the result is exact;
    #: shifting the principal point instead would re-associate the sum and
    #: move borderline Gaussians across tiles.
    pos2d_shift: Optional[torch.Tensor] = None

    @staticmethod
    def host_fields(view) -> dict:
        """The fields of :meth:`from_view` as float32 numpy arrays, computed
        on the host in float64 and rounded once."""
        tan_x = np.tan(view.field_of_view_x / 2.0)
        tan_y = np.tan(view.field_of_view_y / 2.0)
        fields = dict(
            focal_length=[view.image_width / tan_x / 2.0, view.image_height / tan_y / 2.0],
            image_size_half=[view.image_width / 2.0, view.image_height / 2.0],
            view_bound=[tan_x * (FILTER_LOW_PASS + 1.0), tan_y * (FILTER_LOW_PASS + 1.0)],
            view_position=view.view_position,
            view_rotation=view.view_rotation(),
            view_translation=view.view_translation(),
        )
        return {name: np.asarray(x, np.float32) for name, x in fields.items()}

    @classmethod
    def from_view(cls, view, *, device) -> "Camera":
        return cls(**{name: torch.as_tensor(x, dtype=torch.float32, device=device)
                      for name, x in cls.host_fields(view).items()})


class ProjectionOutput(NamedTuple):
    """Per-point projection results, structure-of-arrays ([P] components)."""

    color_r: torch.Tensor  # [P] clamped >= 0
    color_g: torch.Tensor
    color_b: torch.Tensor
    conic_xx: torch.Tensor  # [P] inverse 2D covariance
    conic_xy: torch.Tensor
    conic_yy: torch.Tensor
    pos2d_x: torch.Tensor  # [P] screen position
    pos2d_y: torch.Tensor
    depths: torch.Tensor  # [P] view depths
    radii: torch.Tensor  # [P] int32, 0 for culled points
    tile_x_max: torch.Tensor  # [P] int32 touched-tile AABB
    tile_x_min: torch.Tensor
    tile_y_max: torch.Tensor
    tile_y_min: torch.Tensor
    tile_counts: torch.Tensor  # [P] int32 touched-tile counts (0 if culled)
    visible: torch.Tensor  # [P] bool

    # Array-of-structures views ([P, k]), for tests and small scenes; the
    # pipeline reads the components.
    @property
    def colors_rgb_3d(self) -> torch.Tensor:
        return torch.stack([self.color_r, self.color_g, self.color_b], -1)

    @property
    def conics(self) -> torch.Tensor:
        return torch.stack([self.conic_xx, self.conic_xy, self.conic_yy], -1)

    @property
    def positions_2d(self) -> torch.Tensor:
        return torch.stack([self.pos2d_x, self.pos2d_y], -1)

    @property
    def tile_bounds(self) -> torch.Tensor:
        return torch.stack(
            [self.tile_x_max, self.tile_x_min, self.tile_y_max, self.tile_y_min], -1
        )


def quat_to_rotmat_components(qx, qy, qz, qw):
    """Normalized quaternion components -> the 9 rotation-matrix entries
    (row-major r[i][j]), all elementwise."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        2.0 * (0.5 - yy - zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 2.0 * (0.5 - xx - zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 2.0 * (0.5 - xx - yy),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion (x, y, z, w) [..., 4] -> rotation [..., 3, 3]."""
    r = quat_to_rotmat_components(q[..., 0], q[..., 1], q[..., 2], q[..., 3])
    return torch.stack(
        [torch.stack(r[0:3], -1), torch.stack(r[3:6], -1), torch.stack(r[6:9], -1)], dim=-2
    )


def eval_sh(colors_sh: torch.Tensor, vx, vy, vz, degree: int):
    """Evaluate real SH (degree 0..3) toward the unit view direction.

    ``colors_sh``: [P, 48] ([P, M, 3] flattened); ``vx/vy/vz``: [P].
    Returns (r, g, b) raw components (before the +0.5 offset).
    """

    def coef(m):  # [P, 3] slice of coefficient m
        return colors_sh[:, 3 * m : 3 * m + 3]

    def accum(out, m, basis):  # out: [P, 3]; basis: [P]
        return out + coef(m) * basis[:, None]

    out = coef(0) * _SH_C0[0]
    if degree >= 1:
        out = accum(out, 1, _SH_C1[0] * vy)
        out = accum(out, 2, _SH_C1[1] * vz)
        out = accum(out, 3, _SH_C1[2] * vx)
    if degree >= 2:
        xx, yy, zz = vx * vx, vy * vy, vz * vz
        out = accum(out, 4, _SH_C2[0] * (vx * vy))
        out = accum(out, 5, _SH_C2[1] * (vy * vz))
        out = accum(out, 6, _SH_C2[2] * (zz * 3.0 - 1.0))
        out = accum(out, 7, _SH_C2[3] * (vx * vz))
        out = accum(out, 8, _SH_C2[4] * (xx - yy))
    if degree >= 3:
        zz_5_1 = zz * 5.0 - 1.0
        out = accum(out, 9, _SH_C3[0] * (vy * (xx * 3.0 - yy)))
        out = accum(out, 10, _SH_C3[1] * (vz * vx * vy))
        out = accum(out, 11, _SH_C3[2] * (vy * zz_5_1))
        out = accum(out, 12, _SH_C3[3] * (vz * (zz_5_1 - 2.0)))
        out = accum(out, 13, _SH_C3[4] * (vx * zz_5_1))
        out = accum(out, 14, _SH_C3[5] * (vz * (xx - yy)))
        out = accum(out, 15, _SH_C3[6] * (vx * (xx - yy * 3.0)))
    return out[:, 0], out[:, 1], out[:, 2]


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 truncated toward zero, as JAX's ``astype(int32)``:
    saturating at the int32 range, NaN -> 0. (A plain ``.to(torch.int32)``
    gives INT_MIN for every out-of-range value on the CPU.)"""
    y = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2.0**31 - 128.0)
    return torch.where(x >= 2.0**31, 2**31 - 1, y.to(torch.int32))


def project_gaussians(
    colors_sh: torch.Tensor,
    positions: torch.Tensor,
    rotations: torch.Tensor,
    scalings: torch.Tensor,
    camera: Camera,
    *,
    sh_degree: int,
    tile_count_x: int,
    tile_count_y: int,
    opacities: Optional[torch.Tensor] = None,
    tight_culling: bool = False,
) -> ProjectionOutput:
    """Project all Gaussians into screen space (vectorized over P).

    Inputs are the inner parameterization: scalings are logs, rotations
    unnormalized quaternions. ``tight_culling`` shrinks each point's
    touched-tile AABB to the bounding box of its blendable
    (alpha >= 1/255) ellipse, intersected with the reference's eigenvalue
    AABB; ``radii`` / ``visible`` keep the reference semantics either way.
    The JAX function's docstring derives the bound.
    """
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    one = torch.ones((), dtype=torch.float32, device=positions.device)

    rv = camera.view_rotation
    tv = camera.view_translation
    fx, fy = camera.focal_length[0], camera.focal_length[1]
    bx, by = camera.view_bound[0], camera.view_bound[1]

    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]

    # World -> view (transform/kernel.wgsl:134-146).
    pv_x = rv[0, 0] * px + rv[0, 1] * py + rv[0, 2] * pz + tv[0]
    pv_y = rv[1, 0] * px + rv[1, 1] * py + rv[1, 2] * pz + tv[1]
    depth = rv[2, 0] * px + rv[2, 1] * py + rv[2, 2] * pz + tv[2]
    depth_ok = (depth >= DEPTH_MIN) & (depth < DEPTH_MAX)
    depth_safe = torch.where(depth_ok, depth, one)

    # Quaternion -> rotation matrix, with zero-quaternion cull (:148-169).
    qx, qy, qz, qw = (
        rotations[:, 0], rotations[:, 1], rotations[:, 2], rotations[:, 3]
    )
    quat_norm_sq = qx * qx + qy * qy + qz * qz + qw * qw
    quat_ok = quat_norm_sq > 0.0
    inv_norm = torch.rsqrt(torch.where(quat_ok, quat_norm_sq, one))
    qx, qy, qz = qx * inv_norm, qy * inv_norm, qz * inv_norm
    qw = torch.where(quat_ok, qw * inv_norm, one)
    r = quat_to_rotmat_components(qx, qy, qz, qw)  # 9 x [P], row-major

    # 3D covariance Sigma = R diag(s^2) R^T (:171-199); s = exp(inner).
    s0 = torch.exp(scalings[:, 0])
    s1 = torch.exp(scalings[:, 1])
    s2 = torch.exp(scalings[:, 2])
    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2

    def sigma(i, j):
        return (
            v0 * r[3 * i + 0] * r[3 * j + 0]
            + v1 * r[3 * i + 1] * r[3 * j + 1]
            + v2 * r[3 * i + 2] * r[3 * j + 2]
        )

    s_xx, s_yy, s_zz = sigma(0, 0), sigma(1, 1), sigma(2, 2)
    s_xy, s_xz, s_yz = sigma(0, 1), sigma(0, 2), sigma(1, 2)

    # Perspective projection with half-pixel center offset (:201-212).
    norm_x = pv_x / depth_safe
    norm_y = pv_y / depth_safe
    pos2d_x = norm_x * fx + camera.image_size_half[0] - 0.5
    pos2d_y = norm_y * fy + camera.image_size_half[1] - 0.5
    if camera.pos2d_shift is not None:
        # Slab-local coordinates (tile sharding); see Camera.pos2d_shift.
        pos2d_x = pos2d_x - camera.pos2d_shift[0]
        pos2d_y = pos2d_y - camera.pos2d_shift[1]

    # EWA: T = J @ Rv with clamped normalized coords (:214-241).
    fz_x = fx / depth_safe
    fz_y = fy / depth_safe
    cx = torch.where(norm_x < -bx, -bx, torch.where(norm_x > bx, bx, norm_x))
    cy = torch.where(norm_y < -by, -by, torch.where(norm_y > by, by, norm_y))
    t00 = fz_x * (rv[0, 0] - cx * rv[2, 0])
    t01 = fz_x * (rv[0, 1] - cx * rv[2, 1])
    t02 = fz_x * (rv[0, 2] - cx * rv[2, 2])
    t10 = fz_y * (rv[1, 0] - cy * rv[2, 0])
    t11 = fz_y * (rv[1, 1] - cy * rv[2, 1])
    t12 = fz_y * (rv[1, 2] - cy * rv[2, 2])

    # Sigma' = T Sigma T^T + C_f I, symmetric 3 components.
    def quad(a0, a1, a2, b0, b1, b2):
        return (
            a0 * b0 * s_xx + a1 * b1 * s_yy + a2 * b2 * s_zz
            + (a0 * b1 + a1 * b0) * s_xy
            + (a0 * b2 + a2 * b0) * s_xz
            + (a1 * b2 + a2 * b1) * s_yz
        )

    c_xx = quad(t00, t01, t02, t00, t01, t02) + FILTER_LOW_PASS
    c_yy = quad(t10, t11, t12, t10, t11, t12) + FILTER_LOW_PASS
    c_xy = quad(t00, t01, t02, t10, t11, t12)

    # Conic = inverse 2D covariance; det == 0 culls (:243-252).
    det = c_xx * c_yy - c_xy * c_xy
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, one)
    conic_xx = c_yy / det_safe
    conic_xy = -c_xy / det_safe
    conic_yy = c_xx / det_safe

    # Radius from the max eigenvalue (:254-284).
    mid = (c_xx + c_yy) * 0.5
    eig_diff = torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    eig_max = torch.maximum(mid + eig_diff, mid - eig_diff)
    radius = torch.ceil(torch.sqrt(torch.clamp_min(eig_max, 0.0)) * FACTOR_RADIUS)

    # Touched-tile AABB, truncated toward zero then clamped (:286-306).
    tsx, tsy = float(TILE_SIZE_X), float(TILE_SIZE_Y)
    x_max = _trunc_i32((pos2d_x + radius + (tsx - 1.0)) / tsx).clamp(0, tile_count_x)
    x_min = _trunc_i32((pos2d_x - radius) / tsx).clamp(0, tile_count_x)
    y_max = _trunc_i32((pos2d_y + radius + (tsy - 1.0)) / tsy).clamp(0, tile_count_y)
    y_min = _trunc_i32((pos2d_y - radius) / tsy).clamp(0, tile_count_y)
    # `visible` / `radii` always use the reference AABB (densify parity).
    tiles_ok = (x_max - x_min) * (y_max - y_min) > 0

    if tight_culling and opacities is not None:
        op = torch.sigmoid(opacities[:, 0].detach())
        # 2L = 2 ln(255 * opacity); <= 0 means alpha < 1/255 everywhere.
        ll2 = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * 255.0)
        alive = ll2 > 0.0
        ll2 = torch.clamp_min(ll2, 0.0)
        # Half-extents of the blendable ellipse's AABB plus a rounding
        # margin; floor bounds, intersected with the reference box.
        margin = 0.01
        ex = torch.sqrt(ll2 * torch.clamp_min(c_xx.detach(), 0.0)) + margin
        ey = torch.sqrt(ll2 * torch.clamp_min(c_yy.detach(), 0.0)) + margin

        def tight_lo(pos, e, ts, hi_clip):
            return _trunc_i32(torch.floor((pos.detach() - e) / ts)).clamp(0, hi_clip)

        def tight_hi(pos, e, ts, hi_clip):
            return (_trunc_i32(torch.floor((pos.detach() + e) / ts)) + 1).clamp(
                0, hi_clip
            )

        x_min = torch.maximum(x_min, tight_lo(pos2d_x, ex, tsx, tile_count_x))
        x_max = torch.minimum(x_max, tight_hi(pos2d_x, ex, tsx, tile_count_x))
        y_min = torch.maximum(y_min, tight_lo(pos2d_y, ey, tsy, tile_count_y))
        y_max = torch.minimum(y_max, tight_hi(pos2d_y, ey, tsy, tile_count_y))
        empty = ~alive | (x_max < x_min) | (y_max < y_min)
        x_max = torch.where(empty, x_min, x_max)
        y_max = torch.where(empty, y_min, y_max)

    tile_count = (x_max - x_min) * (y_max - y_min)

    # View direction for SH (:314-323); zero-offset cull.
    ox = px - camera.view_position[0]
    oy = py - camera.view_position[1]
    oz = pz - camera.view_position[2]
    offset_norm_sq = ox * ox + oy * oy + oz * oz
    offset_ok = offset_norm_sq > 0.0
    inv_off = torch.rsqrt(torch.where(offset_ok, offset_norm_sq, one))
    vx = torch.where(offset_ok, ox * inv_off, zero)
    vy = torch.where(offset_ok, oy * inv_off, zero)
    vz = torch.where(offset_ok, oz * inv_off, one)

    # SH -> RGB, +0.5 offset, clamp at zero (:336-392).
    raw_r, raw_g, raw_b = eval_sh(colors_sh, vx, vy, vz, sh_degree)
    visible = depth_ok & quat_ok & det_ok & tiles_ok & offset_ok
    vis_f = visible.to(torch.float32)
    zero_i = torch.zeros((), dtype=torch.int32, device=positions.device)

    def clamp_color(c):
        c = c + 0.5
        return torch.where(c >= 0.0, c, zero) * vis_f

    return ProjectionOutput(
        color_r=clamp_color(raw_r),
        color_g=clamp_color(raw_g),
        color_b=clamp_color(raw_b),
        conic_xx=conic_xx * vis_f,
        conic_xy=conic_xy * vis_f,
        conic_yy=conic_yy * vis_f,
        pos2d_x=pos2d_x * vis_f,
        pos2d_y=pos2d_y * vis_f,
        depths=torch.where(visible, depth, zero),
        radii=torch.where(visible, _trunc_i32(radius), zero_i),
        tile_x_max=torch.where(visible, x_max, zero_i),
        tile_x_min=torch.where(visible, x_min, zero_i),
        tile_y_max=torch.where(visible, y_max, zero_i),
        tile_y_min=torch.where(visible, y_min, zero_i),
        tile_counts=torch.where(visible, tile_count, zero_i),
        visible=visible,
    )
