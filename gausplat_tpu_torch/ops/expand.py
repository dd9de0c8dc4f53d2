"""Tile-key expansion: the hand-written CUDA kernel and its wrapper.

Counterpart of ``gausplat_tpu/ops/expand.py::fused_point_orders`` (a
Pallas kernel on the TPU). Here it is ``csrc/expand.cu``, one library call
that scans the counts and writes every output: chunk sums scanned by the
last CTA to finish, then one CTA per chunk of points that walks the
chunk's slots slot-major (a binary search over the chunk's staged ends per
slot), and pad CTAs that read the total on the device. The plain version
is :func:`gausplat_tpu_torch.ops.binning.make_point_orders`; the outputs
of the two are bit-identical.
"""

from __future__ import annotations

import torch

from ..constants import DEPTH_ORDER_OFFSET
from ..utils.kernels import I32, I64, PTR, U32, CudaKernel, require_cuda, stream_of
from .binning import make_point_orders

#: The kernel library and its launch count.
EXPAND = CudaKernel(
    "expand.cu",
    "gs_expand_point_orders",
    [PTR, PTR, PTR, PTR, PTR, I32, I32, I64, U32, PTR, PTR, PTR, PTR, PTR, PTR],
)
#: Points per chunk, ``kChunk`` in ``csrc/expand.cu`` (a test compares the
#: two). The scratch holds a ticket and a word per chunk. The card tests'
#: workloads straddle it.
CHUNK_POINTS = 1024


def fused_point_orders(
    depths: torch.Tensor,
    tile_x_max: torch.Tensor,
    tile_x_min: torch.Tensor,
    tile_y_min: torch.Tensor,
    tile_counts: torch.Tensor,
    *,
    tile_count_x: int,
    capacity: int,
    kernel: CudaKernel = EXPAND,
):
    """Expand each visible point into one (key, point id) entry per
    touched tile: ``(keys [capacity] int32, src [capacity] int32,
    offsets_inc [P] int32, total [] int32)``, keys as
    :func:`gausplat_tpu_torch.ops.binning.keys_from_u32` stores them.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    (``kernel``: :data:`EXPAND` or another build of it) in one library
    call, and anything the kernel does not take raises.
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

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=depths.device)

    keys, src, offsets_inc, total = empty(capacity), empty(capacity), empty(p), empty()
    scratch = empty(1 + -(-p // CHUNK_POINTS))
    kernel.launch(
        depths.data_ptr(), tile_x_max.data_ptr(), tile_x_min.data_ptr(),
        tile_y_min.data_ptr(), tile_counts.data_ptr(), p, tile_count_x, capacity,
        DEPTH_ORDER_OFFSET, keys.data_ptr(), src.data_ptr(), offsets_inc.data_ptr(),
        total.data_ptr(), scratch.data_ptr(), stream_of(depths),
    )
    return keys, src, offsets_inc, total
