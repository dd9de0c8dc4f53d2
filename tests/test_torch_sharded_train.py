"""The sharded training step on ``torch.distributed``: the port's
``make_sharded_train_step`` and ``ShardedTrainer`` on a (2, 2) mesh of 4
gloo ranks of the CPU against the JAX package's on its virtual CPU mesh,
with the scenes, views and targets of tests/test_sharded_train.py, as
``tests/torch_parallel_fixture.py`` stored them.

Every case runs inside one spawn of 4 ranks; the rank worker is
``gausplat_tpu_torch.testing.sharded_train_worker``. Every rank must end
with the same results, bit for bit (they take the same host decisions on
the same statistics).

- One step from the same scene and a fresh Adam state, for L1 alone, for
  L1 + D-SSIM (the 5-row halo across the slab boundary) and for a height
  of 48 rows in two slabs of 32 (the padded rows poisoned with 7.7, which
  the step must mask): the loss within rtol 2e-4, the entry total exactly,
  the updated parameters within 2e-5, the densification signal
  (``grad_norm_sum``) within 5e-5 scaled by its largest value, and the
  visibility counts and max radii exactly.
- ``ShardedTrainer.fit`` over 4 steps with densify events after steps 2
  and 4: the same point counts, losses within 1e-5 relative, and the final
  parameters within 1e-4.
- ``ShardedTrainer.fit_scan`` from the same start (``max_chunk=3``): on
  gloo it steps eagerly, so its history, point counts and parameters are
  ``fit``'s bit for bit; it is held to the JAX ``fit`` within the bounds
  above; its chunks break where the JAX package's ``next_host_event``
  puts the host events (the schedule alone, no JAX compile), on the fit's
  schedule and on the default 3DGS schedule from step 2,990.
- The stored answers are current: the JAX step of the ``l1`` case, run
  again here on the virtual mesh (its program compiles in about 15 s),
  gives the stored loss within rtol 1e-6, the stored parameters within
  1e-6 and the integers exactly.
"""

import numpy as np
import pytest

import gausplat_tpu_torch as T
from gausplat_tpu_torch import train as TT
from gausplat_tpu_torch.testing import sharded_train_worker, spawn_ranks

from gausplat_tpu.train import TrainConfig as JaxTrainConfig
from tests import torch_parallel_fixture as fx
from tests.torch_helpers import assert_scaled_close, jax_chunks

STORED = dict(np.load(fx.PATH))
CASE_IDS = [c[0] for c in fx.STEP_CASES]
FIT_SCAN_MAX_CHUNK = 3


def _arrays(name):
    return {f: STORED[f"scene/{name}/{f}"] for f in fx.FIELDS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train_ranks")
    config = TT.TrainConfig(render=T.RenderOptions(**fx.TRAIN_RENDER),
                            densify=TT.DensifyConfig(**fx.FIT_DENSIFY), **fx.FIT_CONFIG)
    views = {h: fx.train_views(T, 2, h) for h in fx.TRAIN_HEIGHTS}
    targets = {h: STORED[f"targets/{h}"] for h in fx.TRAIN_HEIGHTS}
    spawn_ranks(sharded_train_worker, 4, str(out), _arrays("train"), views, targets,
                T.RenderOptions(**fx.TRAIN_RENDER), fx.STEP_CASES,
                (_arrays("fit"), 64, config, fx.FIT_STEPS, FIT_SCAN_MAX_CHUNK))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_ranks_agree_bit_for_bit(ranks):
    for r in range(1, 4):
        for key, value in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][key], value, err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("name", CASE_IDS)
def test_sharded_step_matches_jax(ranks, name):
    got = {k.split("/", 1)[1]: v for k, v in ranks[0].items() if k.startswith(name + "/")}
    want = {k.split("/", 1)[1]: v for k, v in STORED.items() if k.startswith(name + "/")}
    assert int(got["h_pad"]) == int(want["h_pad"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-4)
    assert int(got["tile_point_total"]) == int(want["tile_point_total"]) > 0
    for f in fx.FIELDS:
        np.testing.assert_allclose(got[f], want[f], atol=2e-5, rtol=0, err_msg=f)
    assert_scaled_close(got["grad_norm_sum"], want["grad_norm_sum"], atol=5e-5)
    for key in ("visible_count", "max_radii"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sharded_fit_with_densify_event_matches_jax(ranks):
    got = ranks[0]
    counts = STORED["fit/point_count"]
    assert (counts > 0).any(), "no densify event ran"
    np.testing.assert_array_equal(got["fit/point_count"], counts)
    assert got["fit/positions"].shape[0] == STORED["fit/positions"].shape[0] != 24
    np.testing.assert_allclose(got["fit/loss"], STORED["fit/loss"], rtol=1e-5)
    for f in fx.FIELDS:
        np.testing.assert_allclose(got[f"fit/{f}"], STORED[f"fit/{f}"], atol=1e-4, rtol=0,
                                   err_msg=f)


def _counts_before_each_step(point_count, start: int) -> np.ndarray:
    """The point count each step of a fit starts with, from its history's
    ``point_count`` (the count after a densify event, -1 elsewhere)."""
    counts, now = [], start
    for c in point_count:
        counts.append(now)
        now = int(c) if c >= 0 else now
    return np.array(counts + [now])


def test_sharded_fit_scan_matches_fit_bit_for_bit(ranks):
    got = ranks[0]
    for key in ("loss", "tile_point_total", "points", *fx.FIELDS):
        np.testing.assert_array_equal(got[f"fit_scan/{key}"], got[f"fit/{key}"], err_msg=key)
    chunks = got["fit_scan/chunks"]
    before = _counts_before_each_step(got["fit/point_count"], _arrays("fit")["positions"].shape[0])
    np.testing.assert_array_equal(chunks[:, 2], before[chunks[:, 0]])
    assert len(chunks) > 1 and chunks[:, 1].sum() == fx.FIT_STEPS


def test_sharded_fit_scan_matches_jax(ranks):
    got = ranks[0]
    counts = STORED["fit/point_count"]
    chunks = got["fit_scan/chunks"]
    before = _counts_before_each_step(counts, _arrays("fit")["positions"].shape[0])
    np.testing.assert_array_equal(chunks[:, 2], before[chunks[:, 0]])
    assert int(got["fit_scan/points"]) == before[-1] == STORED["fit/positions"].shape[0]
    np.testing.assert_allclose(got["fit_scan/loss"], STORED["fit/loss"], rtol=1e-5)
    for f in fx.FIELDS:
        np.testing.assert_allclose(got[f"fit_scan/{f}"], STORED[f"fit/{f}"], atol=1e-4, rtol=0,
                                   err_msg=f)


def test_sharded_fit_scan_chunks_follow_jax_schedule(ranks):
    got = ranks[0]
    fit_config = JaxTrainConfig(**fx.FIT_CONFIG)
    assert list(got["fit_scan/chunks"][:, 1]) == jax_chunks(fit_config, 0, fx.FIT_STEPS,
                                                            FIT_SCAN_MAX_CHUNK)
    assert list(got["fit_scan/default_chunks"]) == jax_chunks(JaxTrainConfig(), 2_990,
                                                              1_210, 100)


def test_stored_step_answers_are_current():
    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu.parallel import make_mesh
    from gausplat_tpu.parallel.render import stack_cameras
    from gausplat_tpu.parallel.train_step import make_sharded_train_step
    from gausplat_tpu.train.densify import zero_densify_acc

    name, h, ssim_weight = fx.STEP_CASES[0]
    scene = fx.jax_scene(**fx.SCENES["train"])
    step, optimizer, h_pad, _ = make_sharded_train_step(
        make_mesh((2, 2), ("data", "tiles")), fx.W, h, scene.point_count,
        G.RenderOptions(backend="xla", **fx.TRAIN_RENDER), ssim_weight=ssim_weight)
    targets = jnp.asarray(np.pad(STORED[f"targets/{h}"], ((0, 0), (0, h_pad - h), (0, 0), (0, 0)),
                                 constant_values=7.7))
    new_scene, _, acc, metrics = step(scene, optimizer.init(scene),
                                      zero_densify_acc(scene.point_count),
                                      stack_cameras(fx.train_views(G, 2, h)), targets)
    np.testing.assert_allclose(float(metrics["loss"]), float(STORED[f"{name}/loss"]), rtol=1e-6)
    assert int(metrics["tile_point_total"]) == int(STORED[f"{name}/tile_point_total"])
    for f in fx.FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(new_scene, f)), STORED[f"{name}/{f}"],
                                   atol=1e-6, rtol=0, err_msg=f)
    for key in ("visible_count", "max_radii"):
        np.testing.assert_array_equal(np.asarray(acc[key]), STORED[f"{name}/{key}"], err_msg=key)
