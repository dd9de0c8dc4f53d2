"""The per-call entry points that replay a CUDA graph on the card, on the
CPU: ``Trainer.train_step`` and ``train_step_batch`` (and so ``fit``),
``ShardedTrainer.train_step``, the no-grad ``render`` and
``count_tile_entries``.

On a CPU device each graph's step runs eagerly, so these tests run the
restructured step bodies themselves (static camera rows and targets,
static metric outputs cloned out):

- ``train_step`` over 6 steps across a densify (after step 5) and an
  opacity reset (after step 6) against the JAX ``Trainer.train_step`` on
  the same inputs, with ``tests/test_torch_train.py``'s tolerances (point
  counts and entry totals exactly, losses rtol 1e-4, positions atol 5e-4,
  the other parameters 1e-3), and bit for bit against the step launched
  op by op (``_train_step_eager``): the parameters, the Adam state, the
  densify accumulators, the watermark and every metric. The same for
  ``train_step_batch`` (3 views a step, no host event, as in the JAX
  package);
- successive ``train_step`` metrics are tensors of their own;
- the no-grad render's step, with a caller's non-zero ref, bit for bit the
  eager render in all five fields;
- ``count_tile_entries`` exactly the JAX package's total;
- ``ShardedTrainer.train_step`` on a gloo (1, 1) mesh bit for bit its eager
  step across a densify.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu import train as GT
from gausplat_tpu.render.pipeline import count_tile_entries as jax_count_tile_entries
from gausplat_tpu_torch import train as TT
from gausplat_tpu_torch.render.pipeline import (
    _count_tile_entries_eager, _render_eager, serve_views,
)
from gausplat_tpu_torch.render.views_graph import pack_cameras

from tests.torch_helpers import DENSIFY, TRAIN_SCHEDULE, scene_arrays, train_arrays, views

PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
W = H = 48
#: TRAIN_SCHEDULE's first 6 steps (its densify after step 5), with the
#: opacity reset after step 6 and the SH degree held at 0 (as it is there
#: until step 6), so the JAX trainer compiles two steps.
SCHEDULE = dict(TRAIN_SCHEDULE, opacity_reset_interval=6, sh_warmup_interval=100)
STEPS = 6
JAX_OPTIONS = dict(backend="xla", tile_entry_capacity=2048, block_size=64)
PORT_OPTIONS = dict(tile_entry_capacity=2048, block_size=64)


@pytest.fixture(scope="module")
def inputs():
    """Two view pairs and their targets (the port's no-grad render of a
    seeded scene, as numpy)."""
    pairs = [views(W, H), views(W, H, position=(0.3, 0.1, -4.0))]
    truth = T.GaussianScene.from_numpy(**train_arrays(25, 5), device="cpu")
    with torch.no_grad():
        targets = [_render_eager(truth, t, T.RenderOptions(**PORT_OPTIONS)).colors_rgb_2d.numpy()
                   for _, t in pairs]
    return pairs, targets


def _jax_trainer():
    return GT.Trainer(G.GaussianScene(**{k: jnp.asarray(v) for k, v in
                                         train_arrays(25, 9).items()}), W, H,
                      GT.TrainConfig(render=G.RenderOptions(**JAX_OPTIONS),
                                     densify=GT.DensifyConfig(**DENSIFY), **SCHEDULE))


def _port_trainer():
    return TT.Trainer(T.GaussianScene.from_numpy(**train_arrays(25, 9), device="cpu"), W, H,
                      TT.TrainConfig(render=T.RenderOptions(**PORT_OPTIONS),
                                     densify=TT.DensifyConfig(**DENSIFY), **SCHEDULE))


def _assert_same_state(got, want):
    """Two port trainers bit for bit: the scene, the Adam state, the densify
    accumulators, the watermark and the capacity."""
    assert got.step_count == want.step_count
    for f in PARAMS:
        assert torch.equal(getattr(got.scene, f), getattr(want.scene, f)), f
        for a, b in zip(got._opt_state["adam"][f], want._opt_state["adam"][f]):
            assert torch.equal(a, b), f
    assert torch.equal(got._opt_state["count"], want._opt_state["count"])
    for k, v in want._densify_acc.items():
        assert torch.equal(got._densify_acc[k], v) and got._densify_acc[k].dtype == v.dtype, k
    assert torch.equal(got._entry_watermark, want._entry_watermark)
    assert got._entry_capacity == want._entry_capacity


def _assert_close_to_jax(ttr, jtr, th, jh):
    assert ttr.step_count == jtr.step_count
    assert ttr.scene.point_count == jtr.scene.point_count
    np.testing.assert_allclose([float(h["loss"]) for h in th], [float(h["loss"]) for h in jh],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal([int(h["tile_point_total"]) for h in th],
                                  [int(h["tile_point_total"]) for h in jh])
    for f in PARAMS:
        atol = 5e-4 if f == "positions" else 1e-3
        np.testing.assert_allclose(getattr(ttr.scene, f).detach().numpy(),
                                   np.asarray(getattr(jtr.scene, f)), atol=atol, err_msg=f)


def _as_floats(history):
    return [{k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in h.items()}
            for h in history]


def test_train_step_matches_jax_and_the_eager_step(inputs):
    pairs, targets = inputs
    jtr, ttr, eager = _jax_trainer(), _port_trainer(), _port_trainer()
    jh, th, eh = [], [], []
    for i in range(STEPS):
        (jview, tview), target = pairs[i % 2], targets[i % 2]
        jh.append(jtr.train_step(jview, jnp.asarray(target)))
        th.append(ttr.train_step(tview, torch.as_tensor(target)))
        eh.append(eager._train_step_eager(tview, torch.as_tensor(target)))
    events = [h.get("point_count") for h in th]
    assert events == [h.get("point_count") for h in jh] == [None] * 4 + [ttr.scene.point_count,
                                                                          None]
    assert ttr.scene.point_count > 25
    assert float(ttr.scene.get_opacities().detach().max()) <= 0.01 + 1e-6
    _assert_close_to_jax(ttr, jtr, th, jh)
    assert _as_floats(th) == _as_floats(eh)
    _assert_same_state(ttr, eager)


def test_train_step_batch_matches_jax_and_the_eager_step(inputs):
    pairs, targets = inputs
    batch = [0, 1, 0]
    jtr, ttr, eager = _jax_trainer(), _port_trainer(), _port_trainer()
    jh, th, eh = [], [], []
    for _ in range(2):
        jh.append(jtr.train_step_batch([pairs[i][0] for i in batch],
                                       [targets[i] for i in batch]))
        th.append(ttr.train_step_batch([pairs[i][1] for i in batch],
                                       [torch.as_tensor(targets[i]) for i in batch]))
        eh.append(eager._train_step_batch_eager([pairs[i][1] for i in batch],
                                                [torch.as_tensor(targets[i]) for i in batch]))
    _assert_close_to_jax(ttr, jtr, th, jh)
    np.testing.assert_allclose([float(h["psnr"]) for h in th], [float(h["psnr"]) for h in jh],
                               rtol=1e-4)
    # The densification signal, scaled by its largest magnitude as the
    # gradients are (1e-4); the visibility statistics exactly.
    norm, want_norm = ttr._densify_acc["grad_norm_sum"].numpy(), np.asarray(
        jtr._densify_acc["grad_norm_sum"])
    np.testing.assert_allclose(norm / np.abs(want_norm).max(), want_norm / np.abs(want_norm).max(),
                               atol=1e-4, rtol=0)
    for f in ("visible_count", "max_radii"):
        np.testing.assert_array_equal(ttr._densify_acc[f].numpy(), np.asarray(jtr._densify_acc[f]),
                                      err_msg=f)
    assert _as_floats(th) == _as_floats(eh)
    _assert_same_state(ttr, eager)


def test_train_step_metrics_do_not_alias(inputs):
    pairs, targets = inputs
    trainer = _port_trainer()
    first = trainer.train_step(pairs[0][1], torch.as_tensor(targets[0]))
    kept = {k: v.clone() for k, v in first.items()}
    second = trainer.train_step(pairs[1][1], torch.as_tensor(targets[1]))
    for k, v in first.items():
        assert v.data_ptr() != second[k].data_ptr(), k
        assert torch.equal(v, kept[k]), k
    assert float(first["loss"]) != float(second["loss"])
    one = trainer._one
    assert all(v.data_ptr() not in {t.data_ptr() for t in one.tensors()}
               for v in second.values())


def test_no_grad_render_step_matches_the_eager_render():
    scene = T.GaussianScene.from_numpy(**scene_arrays(80, 3), device="cpu")
    options = T.RenderOptions(**PORT_OPTIONS)
    ref = torch.linspace(0.5, 2.0, 80)  # a caller's non-zero ref: read by no output
    for _, view in (views(W, H), views(56, 40, position=(0.3, 0.1, -4.0))):
        with torch.no_grad():
            want = _render_eager(scene, view, options, ref)
            got = serve_views(scene, pack_cameras([view]), view.image_width, view.image_height,
                              options, "map", "render", torch.device("cpu"), batched=False)
            public = T.render(scene, view, options, ref)
        for field, a, b, c in zip(want._fields, got, want, public):
            assert a.shape == b.shape and a.dtype == b.dtype, field
            assert torch.equal(a, b) and torch.equal(c, b), field
    assert int(want.tile_point_total) > 0


@pytest.mark.parametrize("tight,sh_degree", [(True, 3), (False, 1)])
def test_count_tile_entries_matches_jax(tight, sh_degree):
    arrays = scene_arrays(80, 3)
    jview, tview = views(56, 40, position=(0.3, 0.1, -4.0))
    got = T.count_tile_entries(
        T.GaussianScene.from_numpy(**arrays, device="cpu"), tview,
        T.RenderOptions(tight_culling=tight, colors_sh_degree_max=sh_degree))
    want = jax_count_tile_entries(
        G.GaussianScene(**{k: jnp.asarray(v) for k, v in arrays.items()}), jview,
        G.RenderOptions(tight_culling=tight, colors_sh_degree_max=sh_degree))
    eager = _count_tile_entries_eager(T.GaussianScene.from_numpy(**arrays, device="cpu"), tview,
                                      T.RenderOptions(tight_culling=tight,
                                                      colors_sh_degree_max=sh_degree))
    assert got == want == eager > 0


def test_sharded_train_step_on_gloo_matches_the_eager_step(inputs):
    import torch.distributed as dist

    from gausplat_tpu_torch.parallel import make_mesh, stack_cameras
    from gausplat_tpu_torch.parallel.train_step import ShardedTrainer
    from gausplat_tpu_torch.testing import free_port

    pairs, targets = inputs
    cameras = stack_cameras([t for _, t in pairs], device="cpu")
    stacked = torch.as_tensor(np.stack(targets))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "tiles"))

        def make():
            t = _port_trainer()
            return ShardedTrainer(t.scene, mesh, W, H, t.config)

        graphed, eager = make(), make()
        padded = graphed.pad_targets(stacked)
        got = [graphed.train_step(cameras, padded) for _ in range(STEPS)]
        want = [eager._train_step_eager(cameras, padded) for _ in range(STEPS)]
        assert mesh.backend == "gloo" and graphed._step_graph.captures == 0
    finally:
        dist.destroy_process_group()
    assert graphed.scene.point_count == eager.scene.point_count > 25
    assert _as_floats(got) == _as_floats(want)
    _assert_same_state(graphed, eager)
