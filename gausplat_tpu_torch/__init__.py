"""gausplat_tpu_torch: gausplat_tpu's differentiable render and its trainer
in PyTorch, with the TPU kernels rewritten by hand in CUDA C++ for the
NVIDIA H100.

The JAX package ``gausplat_tpu`` beside it is the reference this port is
held against; this package imports ``torch`` and numpy, and never JAX.
The module layout mirrors the JAX package's, so each module's counterpart
is found under the same name. Ported so far: projection, binning, the
rasterizer forward and backward, the differentiable render with its
densification signal in both entry layouts (f32 and packed bf16 pairs),
training (losses, Adam, densify, trainer, checkpoints), the point cloud
with ``GaussianScene.from_points``, the COLMAP loader, and multi-device
render and training on ``torch.distributed`` (:mod:`.parallel`).
"""

from . import constants, errors, ops, parallel, scene, train, utils
from .constants import SH_COUNT_MAX, SH_DEGREE_MAX
from .render.pipeline import (
    calibrate_options,
    count_tile_entries,
    render,
    render_views,
    RenderOptions,
    RenderOutput,
)
from .render.view import View, Views
from .scene.gaussian_3d import GaussianScene
from .scene.point import Points
from .scene.ply import decode_polygon, encode_polygon

__version__ = "0.1.0"

__all__ = [
    "GaussianScene",
    "Points",
    "RenderOptions",
    "RenderOutput",
    "SH_COUNT_MAX",
    "SH_DEGREE_MAX",
    "View",
    "Views",
    "calibrate_options",
    "constants",
    "count_tile_entries",
    "decode_polygon",
    "encode_polygon",
    "errors",
    "ops",
    "parallel",
    "render",
    "render_views",
    "scene",
    "train",
    "utils",
]
