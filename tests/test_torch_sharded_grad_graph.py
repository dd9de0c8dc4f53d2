"""The differentiable sharded renders through their graph pairs
(``render/grad_graph.py``) on 4 gloo ranks of the CPU.

On the card over NCCL, ``render_data_parallel`` and ``render_tile_sharded``
under grad are each one forward graph replay (the renders and the gathers)
and one backward graph replay (the all-reduce of the replicated inputs'
gradients, and for the slabs the sum of the screen-position gradients
before the densification norm). gloo cannot be captured, so there the
public path is the eager form; the graphed forms (``_data_parallel_graphed``,
``_tile_sharded_graphed``) still run on a CPU device, every replay eager,
with the same static tensors, ownership and moves, the collectives run
by each replay, and the ranks' miss decided together. One spawn of 4
ranks (``gausplat_tpu_torch.testing.sharded_grad_graph_worker``) runs each
form through a sequence of calls; held here, on every rank:

- bit for bit against the eager forms and their backward, every output,
  the five parameter gradients and the ref's, over the warm-up, the
  capture, a replay, new cameras, two calls before one backward,
  backwards in the reverse order, a dropped call, and a miss (no ref);
- the pair's captures, replays and moved states;
- the replay's outputs and gradients of ``mean(image ** 2)`` against the
  JAX package's stored in ``tests/data/torch_parallel_xcheck.npz``,
  within ``tests/test_torch_parallel.py``'s tolerances (images 1e-5,
  integers exactly, gradients 1e-4 scaled).
"""

import numpy as np
import pytest

import gausplat_tpu_torch as T
from gausplat_tpu_torch.testing import sharded_grad_graph_worker, spawn_ranks

from tests import torch_parallel_fixture as fx
from tests.torch_helpers import assert_scaled_close

STORED = dict(np.load(fx.PATH))
ARRAYS = {f: STORED[f"scene/render/{f}"] for f in fx.FIELDS}
CASES = ("data_parallel", "tile_sharded")
PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
#: Each sequence's pair counts on the graphed side: captures, forward and
#: backward replays, moved states (two calls before one backward and the
#: reverse-order backwards each move one call's state out).
COUNTS = [2, 11, 10, 2]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_grad_ranks")
    spawn_ranks(sharded_grad_graph_worker, 4, str(out), ARRAYS, fx.render_views(T, 4, fx.RENDER_H),
                T.RenderOptions(**fx.RENDER), fx.render_views(T, 2, fx.TILE_H),
                T.RenderOptions(**fx.TILE_RENDER))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _records(rank, case, side):
    n = sum(1 for k in rank if k.startswith(f"{case}/{side}/") and k.split("/")[-1].isdigit())
    return [rank[f"{case}/{side}/{i}"] for i in range(n)]


@pytest.mark.parametrize("case", CASES)
def test_graphed_form_matches_the_eager_form_bit_for_bit(ranks, case):
    for r, rank in enumerate(ranks):
        got, want = _records(rank, case, "graph"), _records(rank, case, "eager")
        assert len(got) == len(want) > 100, (r, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.dtype == b.dtype, (r, i)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}, record {i}")
        np.testing.assert_array_equal(rank[f"{case}/counts"], COUNTS, err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_graphed_replay_matches_jax(ranks, case):
    stored = {k.split("/", 1)[1]: v for k, v in STORED.items() if k.startswith(case + "/")}
    for r, rank in enumerate(ranks):
        got = _records(rank, case, "graph")
        at = int(rank[f"{case}/graph/replay_at"])
        outputs = dict(zip(T.RenderOutput._fields, got[at:at + 5]))
        grads = dict(zip(PARAMS + ("norm",), got[at + 5:at + 11]))
        for field, value in outputs.items():
            want = stored[field]
            assert value.shape == want.shape, (r, field)
            if want.dtype.kind == "f":
                np.testing.assert_allclose(value, want, atol=1e-5, rtol=0, err_msg=field)
            else:
                np.testing.assert_array_equal(value, want, err_msg=field)
        for name, value in grads.items():
            want = stored[f"grad/{name}"]
            assert np.abs(want).max() > 0, name
            assert_scaled_close(value, want, err_msg=f"rank {r}: {name}")
