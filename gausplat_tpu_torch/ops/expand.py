"""Tile-key expansion: the hand-written CUDA kernel and its wrapper.

Counterpart of ``gausplat_tpu/ops/expand.py::fused_point_orders`` (a
Pallas kernel on the TPU). Here it is ``csrc/expand.cu``: one thread per
point scatters its tile run at its exclusive-scan offset, and a
grid-stride pass writes the pads. The plain version is
:func:`gausplat_tpu_torch.ops.binning.make_point_orders`; the outputs of
the two are bit-identical.
"""

from __future__ import annotations

import torch

from ..constants import DEPTH_ORDER_OFFSET
from ..utils.kernels import I32, I64, PTR, U32, CudaKernel, require_cuda, stream_of
from .binning import entry_total, make_point_orders

#: The kernel library and its launch count.
EXPAND = CudaKernel(
    "expand.cu",
    "gs_expand_point_orders",
    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I64, U32, PTR, PTR, PTR],
)


def fused_point_orders(
    depths: torch.Tensor,
    tile_x_max: torch.Tensor,
    tile_x_min: torch.Tensor,
    tile_y_min: torch.Tensor,
    tile_counts: torch.Tensor,
    *,
    tile_count_x: int,
    capacity: int,
):
    """Expand each visible point into one (key, point id) entry per
    touched tile: ``(keys [capacity] int64, src [capacity] int32,
    offsets_inc [P] int32, total [] int32)``.

    CPU tensors go to the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises.
    """
    if depths.device.type == "cpu":
        return make_point_orders(
            depths, tile_x_max, tile_x_min, tile_y_min, tile_counts,
            tile_count_x=tile_count_x, capacity=capacity,
        )
    p = depths.shape[0]
    require_cuda("depths", depths, torch.float32, (p,))
    for name, t in (
        ("tile_x_max", tile_x_max), ("tile_x_min", tile_x_min),
        ("tile_y_min", tile_y_min), ("tile_counts", tile_counts),
    ):
        require_cuda(name, t, torch.int32, (p,))
        if t.device != depths.device:
            raise ValueError(f"{name} is on {t.device}, depths on {depths.device}")

    offsets_inc = torch.cumsum(tile_counts, 0, dtype=torch.int32)
    total = entry_total(offsets_inc)
    keys = torch.empty((capacity,), dtype=torch.int64, device=depths.device)
    src = torch.empty((capacity,), dtype=torch.int32, device=depths.device)
    EXPAND.launch(
        depths.data_ptr(), tile_x_max.data_ptr(), tile_x_min.data_ptr(),
        tile_y_min.data_ptr(), tile_counts.data_ptr(), offsets_inc.data_ptr(),
        total.data_ptr(), p, tile_count_x, capacity, DEPTH_ORDER_OFFSET,
        keys.data_ptr(), src.data_ptr(), stream_of(depths),
    )
    return keys, src, offsets_inc, total
