"""The device mesh over an initialised ``torch.distributed`` process group.

Counterpart of ``gausplat_tpu/parallel/mesh.py``. The JAX package drives
every device from one process; the port runs one process per rank (SPMD),
so a mesh here is this rank's view of the grid: its coordinate on each
axis, and one process group per axis that joins the ranks which differ on
that axis alone.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a grid of ranks.

    ``shape[axis]`` is the axis' size, ``coords[axis]`` this rank's
    coordinate on it, ``groups[axis]`` the process group of the ranks that
    share every other coordinate with this one, ``group`` the group of all
    the mesh's ranks, and ``backend`` the default group's backend (``"nccl"``
    or ``"gloo"``).
    """

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    group: object
    backend: str


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the first ``prod(axis_sizes)`` ranks of the default
    process group, laid out row-major as ``np.arange(n).reshape(axis_sizes)``.

    Example: ``make_mesh((2, 2), ("data", "tiles"))`` for 2-way view
    batching by 2-way tile sharding on 4 ranks. Every rank of the default
    group calls it, in the same order as its other group creations
    (``torch.distributed.new_group`` is collective); a rank past the mesh's
    ranks gets ``ValueError`` once the groups exist. Raises ``ValueError``
    when the world is smaller than the mesh, as the JAX package's does for
    too few devices.
    """
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} names")
    n = int(np.prod(axis_sizes))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"Mesh of {axis_sizes} needs {n} devices, have {world}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(axis_sizes)
    groups = {}
    for a, name in enumerate(axis_names):
        # Every line of the grid along axis a, created in one order on every
        # rank (a rank outside a line takes part in its creation all the same).
        for line in np.moveaxis(grid, a, -1).reshape(-1, axis_sizes[a]):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    whole = dist.new_group(list(range(n))) if n < world else dist.group.WORLD
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of {axis_sizes}")
    coords = dict(zip(axis_names, (int(c) for c in np.argwhere(grid == rank)[0])))
    return Mesh(axis_names, dict(zip(axis_names, axis_sizes)), coords, groups, whole,
                dist.get_backend())
