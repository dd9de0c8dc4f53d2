"""The least work of each stage, from shapes and from the reference's data.

Frozen with the benchmark: a later change to the program that fuses,
removes or adds a kernel leaves these counts as they are. Each stage's
least time is the larger of its bytes over the card's memory rate and its
f32 operations over its f32 rate; the bytes count each input read once and
each output written once. The counts take the points ``P``, the pixels, the
tiles, the valid entries, the points that have an entry and the blended
(entry, pixel) pairs of a view, as the reference finds them; never what
the program launched.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s in f32 outside
the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
#: Floats of a point's five parameters (SH degree 3: 48, opacity 1,
#: position 3, quaternion 4, log scales 3).
PARAM_FLOATS = 59
#: Floats of a point's rasterizer row (colour 3, conic 3, opacity 1,
#: screen position 2).
ROW_FLOATS = 9
#: f32 operations of one point's projection: world to view (15), quaternion
#: to rotation (40), the 3-D covariance (30), the Jacobian and the 2-D
#: covariance (50), the conic, the eigenvalue and the radius (25), the SH
#: basis (30) and its 48 products and sums (96), the tile box (20).
PROJECTION_FLOPS = 306
#: f32 operations that every blended (entry, pixel) pair costs at least,
#: in the forward and again in the backward's replay: dx, dy (2), the
#: quadratic form (9), the -0.5 scale and exp (2), the opacity product and
#: its clamp (2), the two blend tests (2).
PAIR_FLOPS = 17
#: f32 operations a pixel of the L1 + D-SSIM loss costs, forward and
#: gradient: five blurred maps of 3 channels, each two 11-tap passes of a
#: multiply and an add (660), the same again in the gradient (660), and the
#: SSIM and L1 terms (80).
LOSS_FLOPS_PER_PIXEL = 1_400
#: f32 operations of one Adam update of one parameter.
ADAM_FLOPS = 12


def bound_ms(bytes_moved: float, flops: float) -> float:
    """The least time (ms) of work that moves ``bytes_moved`` and computes
    ``flops``."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3


def entry_bytes(tiles: int, entries: int, entry_points: int) -> int:
    """A rasterizer's entry inputs: the tile ranges, the sorted ids of the
    valid entries, the rows of the points they name."""
    return tiles * 2 * F32 + entries * F32 + entry_points * ROW_FLOATS * F32


def stages(view: dict) -> dict:
    """Bytes and operations of each stage of one view's step: ``view`` has
    ``points``, ``pixels``, ``tiles``, ``entries``, ``entry_points`` and
    ``blended``."""
    p, px, t = view["points"], view["pixels"], view["tiles"]
    e, ep, pairs = view["entries"], view["entry_points"], view["blended"]
    return {
        "projection": (p * (PARAM_FLOATS + ROW_FLOATS + 3) * F32, p * PROJECTION_FLOPS),
        "binning": (p * 5 * F32 + e * 6 * F32 + t * 2 * F32, 0),
        "rasterize_forward": (entry_bytes(t, e, ep) + px * 5 * F32, pairs * PAIR_FLOPS),
        "rasterize_backward": (entry_bytes(t, e, ep) + px * 5 * F32 + e * ROW_FLOATS * F32,
                               pairs * PAIR_FLOPS),
        "reduce": (e * (ROW_FLOATS + 1) * F32 + p * ROW_FLOATS * F32, e * ROW_FLOATS),
        "projection_vjp": (p * (2 * PARAM_FLOATS + ROW_FLOATS) * F32, 2 * p * PROJECTION_FLOPS),
        "loss": (px * 9 * F32, px * LOSS_FLOPS_PER_PIXEL),
        "adam": (p * PARAM_FLOATS * 7 * F32, p * PARAM_FLOATS * ADAM_FLOPS),
    }


SERVE_STAGES = ("projection", "binning", "rasterize_forward")


def least_ms(view: dict, names=None) -> float:
    """The sum of the stages' least times (ms); ``names``: those stages
    (default: every stage of a training step)."""
    work = stages(view)
    return sum(bound_ms(*work[n]) for n in (names or work))


def view_counts(config: dict, frame: dict) -> dict:
    """A view's counts: the configuration's points and frame, the
    reference's entries, points with an entry and blended pairs."""
    w, h = config["width"], config["height"]
    return dict(points=config["points"], pixels=w * h, tiles=-(-w // 16) * -(-h // 16),
                entries=frame["total"], entry_points=frame["entry_points"],
                blended=frame["blended"])


def mean_view(views: list) -> dict:
    """The mean of the views' counts."""
    return {k: sum(v[k] for v in views) / len(views) for k in views[0]}
