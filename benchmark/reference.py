"""The plain reference: 3D Gaussian Splatting in plain PyTorch.

Kerbl et al. 2023 (arXiv:2308.04079), with the conventions the system
under test states for itself: EWA projection with a 0.3 low-pass filter
and clamped Jacobian, real SH up to degree 3 with a +0.5 offset, 16 x 16
tiles, each point touching the tiles of its 3-sigma box (``FACTOR_RADIUS``)
cut to the box of its alpha >= 1/255 ellipse, entries ordered per tile by a
16-bit depth key and then by point id, alpha clamped to 252/255 and
skipped under 1/255, a pixel stopped before the entry that would take its
transmittance under (3/255)^2; the loss L1 + 0.2 D-SSIM (11 x 11 Gaussian
window, sigma 1.5, zero padding, variances clamped at 0); per-field Adam
with the 3DGS learning rates and the log-linear position schedule.

It imports torch and numpy only: nothing of the program under test and no
JAX. It works every derived quantity out again from the scene's five
parameters and the cameras. The blend runs over blocks of tiles with
padded [tiles, entries, 256] tensors, so it fits on the card at 1080p;
its gradient is the autograd of the same blocks, replayed one block at
a time against the loss's image gradient.

``dtype`` selects the precision the blend and the projection run in
(float32 for the reference; bfloat16 for the serving cells' control);
``tf32`` rounds every operand of its matrix products and convolutions to
TF32's 10-bit mantissa first, as the card's TF32 mode does (the training
cell's control). The reference itself leaves TF32 off.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
PIXELS = TILE * TILE
DEPTH_MIN = 0.25
DEPTH_MAX = 16384.0
FACTOR_RADIUS = 2.9999771
LOW_PASS = 0.3
ALPHA_MIN = float(np.float32(1.0 / 255.0))
ALPHA_MAX = float(np.float32(252.0 / 255.0))
T_MIN = float(np.float32((1.0 - 252.0 / 255.0) ** 2))
DEPTH_ORDER_OFFSET = ((3 << 23) + 0xC0000000) & 0xFFFFFFFF
#: Blended pairs a block of tiles may hold at once (forward; half under grad).
BLOCK_PAIRS = 1 << 26


def _sh_constants():
    pi = math.pi
    c1 = math.sqrt(3.0 / (4.0 * pi))
    return (
        math.sqrt(1.0 / (4.0 * pi)),
        (-c1, c1, -c1),
        (math.sqrt(15.0 / (4.0 * pi)), -math.sqrt(15.0 / (4.0 * pi)),
         math.sqrt(5.0 / (16.0 * pi)), -math.sqrt(15.0 / (4.0 * pi)),
         math.sqrt(15.0 / (16.0 * pi))),
        (-math.sqrt(35.0 / (32.0 * pi)), math.sqrt(105.0 / (4.0 * pi)),
         -math.sqrt(21.0 / (32.0 * pi)), math.sqrt(7.0 / (16.0 * pi)),
         -math.sqrt(21.0 / (32.0 * pi)), math.sqrt(105.0 / (16.0 * pi)),
         -math.sqrt(35.0 / (32.0 * pi))),
    )


SH_C0, SH_C1, SH_C2, SH_C3 = _sh_constants()


@dataclasses.dataclass
class Cam:
    """A pinhole camera: ``p_view = rotation @ p + translation``; ``fov``
    the full angles (x, y) in radians."""

    rotation: np.ndarray
    translation: np.ndarray
    position: np.ndarray
    fov: tuple
    width: int
    height: int

    def tensors(self, device, dtype):
        tan = np.tan(np.asarray(self.fov, np.float64) / 2.0)
        size = np.array([self.width, self.height], np.float64)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                                      device=device).to(dtype)
        return dict(rotation=f(self.rotation), translation=f(self.translation),
                    position=f(self.position), focal=f(size / tan / 2.0), half=f(size / 2.0),
                    bound=f(tan * (LOW_PASS + 1.0)))


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """[P, 16] real SH basis of degree 3 toward unit directions ``d`` [P, 3]."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, SH_C0),
        SH_C1[0] * y, SH_C1[1] * z, SH_C1[2] * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (3.0 * zz - 1.0),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * x * y * z, SH_C3[2] * y * (5.0 * zz - 1.0),
        SH_C3[3] * z * (5.0 * zz - 3.0), SH_C3[4] * x * (5.0 * zz - 1.0),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy),
    ], -1)


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [P, 3, 3] of unit quaternions (x, y, z, w) [P, 4]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).view(-1, 3, 3)


def to_tf32(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 explicit mantissa bits,
    ties to even), the gradient passed straight through; ``x`` where not
    ``on``."""
    if not on:
        return x
    bits = x.detach().float().contiguous().view(torch.int32)
    rounded = ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32).to(x.dtype)
    return x + (rounded - x).detach()


def _trunc_tiles(x: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.nan_to_num(torch.trunc(x), nan=0.0).clamp(0, hi).to(torch.int64)


def _floor_tiles(x: torch.Tensor, hi: int, add: int = 0) -> torch.Tensor:
    return (torch.nan_to_num(torch.floor(x), nan=0.0) + add).clamp(0, hi).to(torch.int64)


def project(params: dict, cam: Cam, *, dtype=torch.float32, tf32: bool = False) -> dict:
    """Screen-space Gaussians of one camera, differentiable in ``params``
    (inner parameters: log scales, unnormalised quaternions, logit
    opacities)."""
    device = params["positions"].device
    c = cam.tensors(device, dtype)
    tcx, tcy = -(-cam.width // TILE), -(-cam.height // TILE)
    p = params["positions"].to(dtype)
    pv = to_tf32(p, tf32) @ to_tf32(c["rotation"].T, tf32) + c["translation"]
    depth = pv[:, 2]
    depth_ok = (depth >= DEPTH_MIN) & (depth < DEPTH_MAX)
    z = torch.where(depth_ok, depth, torch.ones_like(depth))
    q = params["rotations"].to(dtype)
    qn = (q * q).sum(-1, keepdim=True)
    quat_ok = qn[:, 0] > 0
    q = torch.where(quat_ok[:, None], q * torch.rsqrt(torch.where(qn > 0, qn, torch.ones_like(qn))),
                    torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device))
    m = quat_matrix(q) * torch.exp(params["scalings"].to(dtype))[:, None, :]
    sigma = to_tf32(m, tf32) @ to_tf32(m.transpose(1, 2), tf32)
    norm = pv[:, :2] / z[:, None]
    screen = norm * c["focal"] + c["half"] - 0.5
    clamped = torch.maximum(torch.minimum(norm, c["bound"]), -c["bound"])
    fz = c["focal"] / z[:, None]
    rv = c["rotation"]
    jac = fz[:, :, None] * (rv[None, :2, :] - clamped[:, :, None] * rv[None, 2:3, :])
    cov = to_tf32(to_tf32(jac, tf32) @ to_tf32(sigma, tf32), tf32) @ to_tf32(
        jac.transpose(1, 2), tf32)
    a = cov[:, 0, 0] + LOW_PASS
    b = cov[:, 0, 1]
    cc = cov[:, 1, 1] + LOW_PASS
    det = a * cc - b * b
    det_ok = det != 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cc / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + cc)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(torch.sqrt(torch.clamp_min(lam, 0.0)) * FACTOR_RADIUS)
    sx, sy = screen[:, 0].detach().float(), screen[:, 1].detach().float()
    rad = radius.detach().float()
    x_min = _trunc_tiles((sx - rad) / TILE, tcx)
    x_max = _trunc_tiles((sx + rad + (TILE - 1)) / TILE, tcx)
    y_min = _trunc_tiles((sy - rad) / TILE, tcy)
    y_max = _trunc_tiles((sy + rad + (TILE - 1)) / TILE, tcy)
    tiles_ok = (x_max - x_min) * (y_max - y_min) > 0
    # The blendable ellipse's box: alpha = o exp(-q/2) >= 1/255 needs
    # q <= 2 ln(255 o), whose x extent is sqrt(2 ln(255 o) cov_xx).
    opacity = torch.sigmoid(params["opacities"][:, 0].to(dtype))
    ll2 = 2.0 * torch.log(torch.clamp_min(opacity.detach().float(), 1e-12) * 255.0)
    alive = ll2 > 0
    ll2 = torch.clamp_min(ll2, 0.0)
    ex = torch.sqrt(ll2 * torch.clamp_min(a.detach().float(), 0.0)) + 0.01
    ey = torch.sqrt(ll2 * torch.clamp_min(cc.detach().float(), 0.0)) + 0.01
    x_min = torch.maximum(x_min, _floor_tiles((sx - ex) / TILE, tcx))
    x_max = torch.minimum(x_max, _floor_tiles((sx + ex) / TILE, tcx, 1))
    y_min = torch.maximum(y_min, _floor_tiles((sy - ey) / TILE, tcy))
    y_max = torch.minimum(y_max, _floor_tiles((sy + ey) / TILE, tcy, 1))
    empty = ~alive | (x_max < x_min) | (y_max < y_min)
    x_max = torch.where(empty, x_min, x_max)
    y_max = torch.where(empty, y_min, y_max)
    offset = p - c["position"]
    on = (offset * offset).sum(-1, keepdim=True)
    offset_ok = on[:, 0] > 0
    direction = torch.where(offset_ok[:, None],
                            offset * torch.rsqrt(torch.where(on > 0, on, torch.ones_like(on))),
                            torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device))
    sh = params["colors_sh"].to(dtype).view(-1, 16, 3)
    color = torch.clamp_min((sh * sh_basis(direction)[:, :, None]).sum(1) + 0.5, 0.0)
    visible = depth_ok & quat_ok & det_ok & tiles_ok & offset_ok
    counts = torch.where(visible, (x_max - x_min) * (y_max - y_min), 0)
    return dict(color=color, conic=conic, opacity=opacity, screen=screen, depth=depth.detach(),
                radii=torch.where(visible, radius.detach().float(), 0.0).to(torch.int32),
                box=torch.stack([x_min, y_min, x_max], -1), counts=counts, visible=visible,
                tiles=(tcx, tcy), size=(cam.width, cam.height))


def depth_order(depth: torch.Tensor) -> torch.Tensor:
    """The 16-bit depth key: the top bits of the f32 depth's pattern after a
    bias that maps [2^-2, 2^14) onto [0, 2^16)."""
    bits = depth.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (((bits + DEPTH_ORDER_OFFSET) & 0xFFFFFFFF) >> 11) & 0xFFFF


def bin_entries(proj: dict) -> dict:
    """Every (tile, point) entry, ordered by tile, then depth key, then point
    id; ``ranges`` [tiles, 2] each tile's span of them."""
    counts = proj["counts"]
    device = counts.device
    tcx, tcy = proj["tiles"]
    pid = torch.repeat_interleave(torch.arange(counts.shape[0], device=device), counts)
    start = torch.cumsum(counts, 0) - counts
    local = torch.arange(pid.shape[0], device=device) - start[pid]
    box = proj["box"][pid]
    width = (box[:, 2] - box[:, 0]).clamp_min(1)
    tile = (box[:, 1] + local // width) * tcx + box[:, 0] + local % width
    # ``pid`` ascends, so a stable sort on (tile, depth key) breaks ties by
    # point id for any number of points.
    key = (tile << 16) | depth_order(proj["depth"])[pid]
    order = torch.sort(key, stable=True).indices
    tile, pid = tile[order], pid[order]
    ends = torch.cumsum(torch.bincount(tile, minlength=tcx * tcy), 0)
    return dict(pid=pid, ranges=torch.stack([ends - torch.bincount(tile, minlength=tcx * tcy),
                                             ends], -1), total=int(pid.shape[0]))


def _tile_blocks(ranges: torch.Tensor, pairs: int):
    """Tiles in blocks of about ``pairs`` padded (entry, pixel) pairs, tiles
    of alike entry counts together: (tiles [n], longest list)."""
    n = (ranges[:, 1] - ranges[:, 0]).cpu()
    order = torch.argsort(n, descending=True)
    n_sorted = n[order].tolist()
    i = 0
    while i < len(n_sorted) and n_sorted[i] > 0:
        longest = n_sorted[i]
        take = max(1, pairs // (PIXELS * longest))
        yield order[i:i + take], longest
        i += take


def blend_block(point: dict, pid: torch.Tensor, ranges: torch.Tensor, tiles: torch.Tensor,
                longest: int, tcx: int, dtype=torch.float32, tf32: bool = False):
    """Front-to-back blend of a block of tiles: (image [n, 256, 3],
    transmittance [n, 256], rendered count [n, 256], blended pairs)."""
    device = pid.device
    at = torch.arange(longest, device=device)
    start, end = ranges[tiles, 0], ranges[tiles, 1]
    inside = at[None, :] < (end - start)[:, None]  # [n, E]
    ids = pid[torch.where(inside, start[:, None] + at[None, :], 0)]
    lane = torch.arange(PIXELS, device=device)
    px = ((tiles % tcx)[:, None] * TILE + lane % TILE).to(dtype)[:, None, :]  # [n, 1, 256]
    py = ((tiles // tcx)[:, None] * TILE + lane // TILE).to(dtype)[:, None, :]
    pos, conic = point["screen"][ids], point["conic"][ids]  # [n, E, 2], [n, E, 3]
    dx = pos[..., 0:1] - px
    dy = pos[..., 1:2] - py
    quad = conic[..., 0:1] * dx * dx + 2.0 * conic[..., 1:2] * dx * dy + conic[..., 2:3] * dy * dy
    density = torch.exp(-0.5 * quad)
    # Clamped at ALPHA_MAX, its gradient taken as if unclamped (the 3DGS
    # backward's, which the system states).
    raw = point["opacity"][ids][..., None] * density
    alpha = raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()
    blend = (density <= 1.0) & (alpha >= ALPHA_MIN) & inside[..., None]  # [n, E, 256]
    keep = torch.where(blend, 1.0 - alpha, torch.ones_like(alpha))
    t_after = torch.cumprod(keep, dim=1)
    kept = t_after.detach() >= T_MIN
    blended = blend & kept
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
    weight = torch.where(blended, alpha * t_before, torch.zeros_like(alpha))
    image = to_tf32(weight.transpose(1, 2), tf32) @ to_tf32(point["color"][ids], tf32)
    trans = torch.where(kept, t_after, torch.ones_like(t_after)).amin(1)
    count = torch.where(blended, at[None, :, None] + 1, 0).amax(1)
    return image, trans, count.to(torch.int32), int(blended.sum())


def _untile(x: torch.Tensor, tcx: int, tcy: int, w: int, h: int) -> torch.Tensor:
    rest = x.shape[2:]
    x = x.view(tcy, tcx, TILE, TILE, *rest).transpose(1, 2).reshape(tcy * TILE, tcx * TILE, *rest)
    return x[:h, :w]


def render(params: dict, cam: Cam, *, dtype=torch.float32, block_pairs: int = BLOCK_PAIRS,
           tf32: bool = False) -> dict:
    """A frame: ``image`` [H, W, 3], ``trans`` [H, W], ``counts`` [H, W],
    ``radii`` [P], ``total`` entries, ``blended`` pairs, ``entry_points``
    (points that have an entry)."""
    with torch.no_grad():
        proj = project(params, cam, dtype=dtype, tf32=tf32)
        bins = bin_entries(proj)
        tcx, tcy = proj["tiles"]
        n_tiles = tcx * tcy
        device = bins["pid"].device
        image = torch.zeros((n_tiles, PIXELS, 3), dtype=torch.float32, device=device)
        trans = torch.ones((n_tiles, PIXELS), dtype=torch.float32, device=device)
        counts = torch.zeros((n_tiles, PIXELS), dtype=torch.int32, device=device)
        blended = 0
        for tiles, longest in _tile_blocks(bins["ranges"], block_pairs):
            tiles = tiles.to(device)
            im, tr, ct, nb = blend_block(proj, bins["pid"], bins["ranges"], tiles, longest, tcx,
                                         dtype, tf32)
            image[tiles], trans[tiles], counts[tiles] = im.float(), tr.float(), ct
            blended += nb
        w, h = proj["size"]
        return dict(image=_untile(image, tcx, tcy, w, h), trans=_untile(trans, tcx, tcy, w, h),
                    counts=_untile(counts, tcx, tcy, w, h), radii=proj["radii"],
                    total=bins["total"], blended=blended,
                    entry_points=int(torch.unique(bins["pid"]).numel()))


# --- the loss ---------------------------------------------------------------------

SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2


def _window(device) -> torch.Tensor:
    x = np.arange(11) - 5
    g = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    return torch.as_tensor(g / g.sum(), dtype=torch.float32, device=device)


def _blur(img: torch.Tensor, w: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    x = img.permute(2, 0, 1)[:, None]
    w = to_tf32(w, tf32)
    x = F.conv2d(to_tf32(x, tf32), w.view(1, 1, 11, 1), padding=(5, 0))
    x = F.conv2d(to_tf32(x, tf32), w.view(1, 1, 1, 11), padding=(0, 5))
    return x[:, 0].permute(1, 2, 0)


def photometric_loss(image: torch.Tensor, target: torch.Tensor, weight: float = 0.2,
                     rows: slice | None = None, tf32: bool = False) -> torch.Tensor:
    """(1 - weight) L1 + weight (1 - mean SSIM) of [H, W, 3] images; ``rows``
    keeps only those rows (a fault that drops half of the pixels)."""
    if rows is not None:
        image, target = image[rows], target[rows]
    w = _window(image.device)
    mu_a, mu_b = _blur(image, w, tf32), _blur(target, w, tf32)
    var_a = torch.clamp_min(_blur(image * image, w, tf32) - mu_a * mu_a, 0.0)
    var_b = torch.clamp_min(_blur(target * target, w, tf32) - mu_b * mu_b, 0.0)
    cov = _blur(image * target, w, tf32) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + SSIM_C1) * (2 * cov + SSIM_C2)
            / ((mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (var_a + var_b + SSIM_C2)))
    return (1 - weight) * (image - target).abs().mean() + weight * (1 - ssim.mean())


# --- the training step ----------------------------------------------------------------

FIELDS = ("colors_sh", "opacities", "positions", "rotations", "scalings")


def gradients(params: dict, cam: Cam, target: torch.Tensor, weight: float = 0.2,
              dtype=torch.float32, block_pairs: int = BLOCK_PAIRS // 2,
              loss_rows: slice | None = None, tf32: bool = False) -> tuple:
    """The loss of one view, its gradient by field and the frame (as
    :func:`render` gives it): the frame rendered
    without grad, the loss's image gradient, then each block of tiles
    replayed under autograd against its slice of that gradient, and the
    per-point gradients taken back through the projection."""
    leaves = {f: params[f].detach().requires_grad_() for f in FIELDS}
    proj = project(leaves, cam, dtype=dtype, tf32=tf32)
    point = {k: proj[k].detach().requires_grad_() for k in ("color", "conic", "opacity", "screen")}
    frame = render(params, cam, dtype=dtype, tf32=tf32)
    image = frame["image"].requires_grad_()
    loss = photometric_loss(image, target, weight, loss_rows, tf32)
    (g_image,) = torch.autograd.grad(loss, image)
    bins = bin_entries(proj)
    tcx, tcy = proj["tiles"]
    w, h = proj["size"]
    g_tiles = F.pad(g_image, (0, 0, 0, tcx * TILE - w, 0, tcy * TILE - h))
    g_tiles = g_tiles.view(tcy, TILE, tcx, TILE, 3).transpose(1, 2).reshape(-1, PIXELS, 3)
    for tiles, longest in _tile_blocks(bins["ranges"], block_pairs):
        tiles = tiles.to(g_tiles.device)
        im = blend_block({**proj, **point}, bins["pid"], bins["ranges"], tiles, longest, tcx,
                         dtype, tf32)[0]
        torch.autograd.backward(im, g_tiles[tiles].to(im.dtype))
    torch.autograd.backward([proj[k] for k in point], [point[k].grad for k in point])
    return loss.detach(), {f: leaves[f].grad.float() for f in FIELDS}, frame


@dataclasses.dataclass(frozen=True)
class Adam:
    """The 3DGS per-field Adam: ``lr`` per field, the SH rest columns at the
    DC rate over ``sh_rest_div``, positions on a log-linear schedule from
    ``position_lr[0]`` to ``position_lr[1]`` (times the scene extent) over
    ``position_steps``; bias corrections restart with a fresh state."""

    extent: float
    position_lr: tuple = (1.6e-4, 1.6e-6)
    position_steps: int = 30_000
    sh_lr: float = 2.5e-3
    sh_rest_div: float = 20.0
    opacity_lr: float = 5e-2
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15

    def rates(self, step: int, device) -> dict:
        t = min(max(step / self.position_steps, 0.0), 1.0)
        lo, hi = (math.log(x * self.extent) for x in self.position_lr)
        sh = torch.full((1, 48), self.sh_lr / self.sh_rest_div, dtype=torch.float32, device=device)
        sh[:, :3] = self.sh_lr
        return dict(colors_sh=sh, opacities=self.opacity_lr,
                    positions=math.exp((1 - t) * lo + t * hi), rotations=self.rotation_lr,
                    scalings=self.scaling_lr)

    def step(self, params: dict, grads: dict, state: dict, global_step: int) -> None:
        """One update in place. ``global_step``: the schedule's step count
        after this update; ``state``: ``{field: (m, v)}`` and ``"t"``."""
        t = state["t"] = state.get("t", 0) + 1
        rates = self.rates(global_step, grads["positions"].device)
        for f in FIELDS:
            g = grads[f]
            m, v = state.setdefault(f, (torch.zeros_like(g), torch.zeros_like(g)))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = m / (1 - self.b1 ** t)
            v_hat = v / (1 - self.b2 ** t)
            params[f].sub_(rates[f] * m_hat / (torch.sqrt(v_hat) + self.eps))


def camera_extent(cams) -> float:
    """1.1 times the radius of the camera centres' bounding sphere."""
    centers = np.stack([np.asarray(c.position, np.float64) for c in cams])
    return max(float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1, 1e-6)
