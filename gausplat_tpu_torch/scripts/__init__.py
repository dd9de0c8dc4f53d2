"""Command-line entry points (run with ``python -m gausplat_tpu_torch.scripts.<name>``)."""


def path_kernels() -> tuple:
    """Kernels A, B and C (their f32 entry points): every script's path."""
    from ..ops.expand import EXPAND
    from ..ops.rasterize import RASTERIZE_BACKWARD, RASTERIZE_FORWARD

    return (RASTERIZE_FORWARD, EXPAND, RASTERIZE_BACKWARD)


def build_path_kernels() -> None:
    """Build and load :func:`path_kernels` in this process, one ``nvcc``
    each, so that ranks spawned afterwards load the built libraries instead
    of racing into the first-use build (its lock is per process)."""
    from ..utils.kernels import build_all

    build_all(path_kernels())


def path_launches() -> dict:
    """This process's launch counts of :func:`path_kernels` by entry point."""
    return {k.entry: k.launches for k in path_kernels()}


def zero_launches() -> None:
    for k in path_kernels():
        k.launches = 0


def ring_views(count: int, width: int, height: int, *, fov_y: float = 1.0,
               angle_step: float | None = None) -> list:
    """``count`` cameras on a ring of radius 4 about the y axis, looking at
    the origin: view i at the angle ``2 pi i / count`` (or ``angle_step * i``),
    world->cam rotation ``[[c, 0, s], [0, 1, 0], [-s, 0, c]]``, field of view
    1.0 across and ``fov_y`` down."""
    import numpy as np

    from ..render.view import View

    views = []
    for i in range(count):
        a = 2 * np.pi * i / count if angle_step is None else angle_step * i
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([4 * s, 0.0, -4 * c])
        views.append(View(field_of_view_x=1.0, field_of_view_y=fov_y, image_height=height,
                          image_width=width, view_id=i, view_position=pos,
                          view_transform=View.transform(rot.T, -rot @ pos)))
    return views


def rank_device(device, rank: int = 0, backend: str = "gloo", card_count=None):
    """The ``torch.device`` that rank ``rank`` of a run over ``backend``
    runs on. ``"cuda"`` with no index: under NCCL each rank has a card of
    its own, rank ``r`` on ``cuda:r`` (``ValueError`` where the host has
    fewer cards; ``card_count`` defaults to ``torch.cuda.device_count()``),
    and under gloo every rank shares card 0, as on a one-card machine. A
    device with an index, and the CPU, are kept."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if backend != "nccl":
        return torch.device("cuda", 0)
    count = torch.cuda.device_count() if card_count is None else card_count
    if rank >= count:
        raise ValueError(f"NCCL rank {rank} needs a card of its own; the host has {count}")
    return torch.device("cuda", rank)
