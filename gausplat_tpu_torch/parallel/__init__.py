"""Multi-device render and training on ``torch.distributed``.

Counterpart of ``gausplat_tpu/parallel/``. The JAX package drives every
device from one process through ``shard_map``; here every rank runs the
same call (SPMD) and collectives stand in for the rest:

- :func:`render_views` / :func:`render_data_parallel`: batched multi-view
  rendering, the views split over a mesh axis;
- :func:`render_tile_sharded`: one large frame split across the mesh by
  tile rows;
- :func:`make_mesh`: the mesh over the initialised default process group;
- :mod:`.train_step`: the data x tiles training step and its trainer.

Each rank gets the whole result, and a loss's gradient reaches every
rank's scene summed over the ranks, as ``jax.grad`` through the JAX
function gives it.
"""

from .mesh import Mesh, make_mesh
from .render import render_data_parallel, render_tile_sharded, render_views, stack_cameras

__all__ = [
    "Mesh",
    "make_mesh",
    "render_data_parallel",
    "render_tile_sharded",
    "render_views",
    "stack_cameras",
]
