"""Training against the JAX package, on the CPU.

- Losses (SSIM map, SSIM, L1 + D-SSIM and its gradient, PSNR) against
  ``gausplat_tpu.train.losses``: rtol 1e-5 / atol 1e-6.
- One Adam update against ``make_optimizer(...).update`` from the same
  mid-training state, carried over with ``optimizer_state_from_arrays``:
  updates and state rtol 1e-5 / atol 1e-9 (per-field bias-correction
  counts and the outer schedule count differ on purpose).
- ``densify_and_prune`` and ``reset_opacity``: the same point count
  exactly, parameters atol 1e-6.
- ``Trainer`` against the JAX ``Trainer`` over 13 steps with densify,
  SH warm-up, an opacity reset and overflow checks (the schedule of
  tests/test_train.py::test_fit_scan_matches_fit): point counts and entry
  totals exactly, losses rtol 1e-4, positions atol 5e-4 (measured: losses
  within 7e-7 relative, positions within 1e-7); the JAX fit runs once per
  module. ``Trainer.fit_scan`` (chunks of at most 4) against the same JAX
  history with the same tolerances, against the port's ``fit`` bit for
  bit (parameters, Adam state, densify accumulators, history), and its
  chunks against the JAX package's ``next_host_event``.
- ``train_step_batch``'s loss is the mean of the per-view losses, and a
  checkpoint round-trips and refuses a state of another layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu import train as GT
from gausplat_tpu.train import losses as jlosses
from gausplat_tpu.train import optimizer as jopt
from gausplat_tpu_torch import train as TT

from tests.torch_helpers import DENSIFY, TRAIN_SCHEDULE, jax_chunks, train_arrays, views

PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
W = H = 48


def jax_scene(a):
    return G.GaussianScene(**{k: jnp.asarray(v) for k, v in a.items()})


def port_scene(a):
    return T.GaussianScene.from_numpy(**a, device="cpu")


def images(seed, n=2):
    rng = np.random.default_rng(seed)
    a = rng.random((n, 40, 56, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


def test_losses_match_jax():
    a, b = images(0)
    for x, y in ((a[0], b[0]), (a[1], a[1])):
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        np.testing.assert_allclose(TT.ssim_map(tx, ty).numpy(), jlosses.ssim_map(jx, jy),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(TT.ssim(tx, ty)), float(jlosses.ssim(jx, jy)),
                                   rtol=1e-5, atol=1e-6)
        for w in (0.2, 0.0):
            np.testing.assert_allclose(float(TT.photometric_loss(tx, ty, w)),
                                       float(jlosses.photometric_loss(jx, jy, w)),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(TT.psnr(tx, ty)), float(jlosses.psnr(jx, jy)),
                                   rtol=1e-5)
    want = jax.grad(lambda r: jlosses.photometric_loss(r, jnp.asarray(b[0])))(jnp.asarray(a[0]))
    tx = torch.tensor(a[0], requires_grad=True)
    TT.photometric_loss(tx, torch.as_tensor(b[0])).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)


def _grads(seed, p):
    rng = np.random.default_rng(seed)
    dims = dict(colors_sh=48, opacities=1, positions=3, rotations=4, scalings=3)
    return {f: (rng.standard_normal((p, d)) * 10.0 ** rng.uniform(-6, 0)).astype(np.float32)
            for f, d in dims.items()}


def test_adam_update_matches_optax():
    p = 30
    a = train_arrays(p, 1)
    config = dict(scene_extent=2.5, position_lr_max_steps=500)
    joptim = jopt.make_optimizer(jopt.OptimizerConfig(**config))
    # A mid-training state: two updates, then a densify-style re-seed of the
    # outer count only.
    jstate = joptim.init(jax_scene(a))
    for seed in (2, 3):
        _, jstate = joptim.update(G.GaussianScene(**_grads(seed, p)), jstate)
    jstate = jopt.seed_count(jstate, 321)
    _, jstate = joptim.update(G.GaussianScene(**_grads(4, p)), jstate)

    tstate = TT.optimizer_state_from_arrays(jstate, device="cpu")
    assert int(tstate["count"]) == 322 and int(tstate["adam"]["positions"][0]) == 3
    g = _grads(5, p)
    jupd, jnew = joptim.update(G.GaussianScene(**g), jstate)
    toptim = TT.make_optimizer(TT.OptimizerConfig(**config))
    tupd, tnew = toptim.update({f: torch.as_tensor(v) for f, v in g.items()}, tstate)
    for f in PARAMS:
        np.testing.assert_allclose(tupd[f].numpy(), np.asarray(getattr(jupd, f)),
                                   rtol=1e-5, atol=1e-9, err_msg=f)
        count, mu, nu = tnew["adam"][f]
        jcount, jmu, jnu = jnew["adam"][f]
        assert int(count) == int(jcount) == 4
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(nu.numpy(), np.asarray(jnu), rtol=1e-6, atol=1e-18)
    assert int(tnew["count"]) == int(jnew["count"]) == 323
    # A fresh state seeded at step 321 keeps the outer count only.
    seeded = TT.seed_count(toptim.init(port_scene(a)), 321)
    assert int(seeded["count"]) == 321 and int(seeded["adam"]["scalings"][0]) == 0
    for step in (0, 7, 499, 500, 10_000):
        np.testing.assert_allclose(
            float(TT.position_lr_schedule(TT.OptimizerConfig(**config))(torch.tensor(step))),
            float(jopt.position_lr_schedule(jopt.OptimizerConfig(**config))(jnp.int32(step))),
            rtol=1e-6,
        )


def _densify_inputs():
    p = 40
    a = train_arrays(p, 7)
    rng = np.random.default_rng(8)
    a["scalings"][:20] = np.log(0.004 + 0.004 * rng.random((20, 3)))  # small: clone
    a["opacities"][30:34] = -8.0  # transparent: pruned
    grad_sum = rng.uniform(0, 2e-3, p).astype(np.float32)
    visible = rng.integers(0, 4, p).astype(np.int32)
    avg = grad_sum / np.maximum(visible, 1)
    grad_sum[np.abs(avg / 2e-4 - 1) < 0.02] *= 1.1  # keep 2% from the threshold
    radii = rng.integers(0, 30, p).astype(np.int32)
    return a, grad_sum, visible, radii


def test_densify_state_accumulate_matches_jax():
    p = 40
    rng = np.random.default_rng(8)
    jstate = GT.DensifyState.zeros(p)
    tstate = TT.DensifyState.zeros(p, device="cpu")
    for _ in range(3):
        grad_norm = rng.uniform(0, 1e-3, p).astype(np.float32)
        radii = np.where(rng.random(p) < 0.3, 0, rng.integers(1, 30, p)).astype(np.int32)
        jstate.accumulate(jnp.asarray(grad_norm), jnp.asarray(radii))
        tstate.accumulate(torch.as_tensor(grad_norm), torch.as_tensor(radii))
    for field in ("grad_norm_sum", "visible_count", "max_radii"):
        got, want = getattr(tstate, field).numpy(), getattr(jstate, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=field)


@pytest.mark.parametrize("max_screen_radius", [0.0, 20.0])
def test_densify_and_prune_matches_jax(max_screen_radius):
    a, grad_sum, visible, radii = _densify_inputs()
    config = dict(max_screen_radius=max_screen_radius, seed=3)
    jnew, jstate, jstats = GT.densify_and_prune(
        jax_scene(a), GT.DensifyState(grad_sum, visible, radii), GT.DensifyConfig(**config))
    tnew, tstate, tstats = TT.densify_and_prune(
        port_scene(a),
        TT.DensifyState(torch.as_tensor(grad_sum), torch.as_tensor(visible),
                        torch.as_tensor(radii)),
        TT.DensifyConfig(**config))
    assert tstats == jstats
    assert jstats["cloned"] > 0 and jstats["split"] > 0 and jstats["pruned"] > jstats["split"]
    assert tnew.point_count == jnew.point_count
    assert tstate.grad_norm_sum.shape == (tnew.point_count,)
    for f in PARAMS:
        np.testing.assert_allclose(getattr(tnew, f).detach().numpy(),
                                   np.asarray(getattr(jnew, f)), atol=1e-6, rtol=0, err_msg=f)


def test_reset_opacity_and_camera_extent_match_jax():
    a = train_arrays(20, 4)
    a["opacities"][:10] = np.linspace(-9, 4, 10)[:, None]
    config = dict(opacity_reset_value=0.05)
    want = GT.reset_opacity(jax_scene(a), GT.DensifyConfig(**config))
    got = TT.reset_opacity(port_scene(a), TT.DensifyConfig(**config))
    for f in PARAMS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6, rtol=0, err_msg=f)
    pairs = [views(W, H, position=(x, 0.2 * x, -4.0)) for x in (-1.0, 0.0, 2.0)]
    assert TT.camera_extent([t for _, t in pairs]) == GT.densify.camera_extent(
        [j for j, _ in pairs])


def test_next_host_event_matches_jax():
    from gausplat_tpu.train.trainer import next_host_event as jax_next

    for kw in (dict(), dict(densify_from=4, densify_until=11, densify_interval=5,
                            sh_warmup_interval=6, overflow_check_interval=7,
                            opacity_reset_interval=8)):
        jc, tc = GT.TrainConfig(**kw), TT.TrainConfig(**kw)
        for now in (0, 3, 4, 5, 9, 10, 499, 500, 2999, 3000, 14_999):
            assert TT.next_host_event(tc, now, now + 10_000) == jax_next(jc, now, now + 10_000)


def _port_trainer(cls=None):
    topts = T.RenderOptions(tile_entry_capacity=2048, block_size=64)
    return (cls or TT.Trainer)(port_scene(train_arrays(25, 9)), W, H, TT.TrainConfig(
        render=topts, densify=TT.DensifyConfig(**DENSIFY), **TRAIN_SCHEDULE))


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX ``Trainer``'s 13-step ``fit`` on ``TRAIN_SCHEDULE``, run once
    for the tests that hold the port to it: the view pairs, the targets, the
    history and the final trainer."""
    jopts = G.RenderOptions(backend="xla", tile_entry_capacity=2048, block_size=64)
    pairs = [views(W, H), views(W, H, position=(0.3, 0.1, -4.0))]
    target = jax_scene(train_arrays(25, 5))
    targets = [np.array(G.render(target, j, jopts).colors_rgb_2d) for j, _ in pairs]
    jtr = GT.Trainer(jax_scene(train_arrays(25, 9)), W, H, GT.TrainConfig(
        render=jopts, densify=GT.DensifyConfig(**DENSIFY), **TRAIN_SCHEDULE))
    history = jtr.fit([j for j, _ in pairs], targets, 13)
    return dict(pairs=pairs, targets=targets, history=history, trainer=jtr)


def _port_fit_inputs(jax_fit):
    return ([t for _, t in jax_fit["pairs"]],
            [torch.as_tensor(x) for x in jax_fit["targets"]])


class _ChunkRecorder:
    """Wraps a trainer's ``StepGraph.run`` to record each chunk's length."""

    def __init__(self, trainer, run_steps=True):
        self.lengths = []
        run = trainer._graph.run

        def record(step, static_key, tensors, steps):
            self.lengths.append(steps)
            if run_steps:
                run(step, static_key, tensors, steps)

        trainer._graph.run = record


@pytest.fixture(scope="module")
def port_scan(jax_fit):
    """The port's ``fit_scan(..., 13, max_chunk=4)`` on the CPU, with its
    chunk lengths."""
    trainer = _port_trainer()
    recorder = _ChunkRecorder(trainer)
    history = trainer.fit_scan(*_port_fit_inputs(jax_fit), 13, max_chunk=4)
    return dict(trainer=trainer, history=history, chunks=recorder.lengths)


def _assert_matches_jax(ttr, th, jax_fit):
    jtr, jh = jax_fit["trainer"], jax_fit["history"]
    assert jtr.step_count == ttr.step_count == 13
    assert ttr.scene.point_count == jtr.scene.point_count > 25
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal([h["tile_point_total"] for h in th],
                                  [h["tile_point_total"] for h in jh])
    for f in PARAMS:
        atol = 5e-4 if f == "positions" else 1e-3
        np.testing.assert_allclose(getattr(ttr.scene, f).detach().numpy(),
                                   np.asarray(getattr(jtr.scene, f)), atol=atol, err_msg=f)
    assert ttr._sh_degree() == jtr._sh_degree() == 2


def test_trainer_matches_jax(jax_fit):
    ttr = _port_trainer()
    th = ttr.fit(*_port_fit_inputs(jax_fit), 13)
    jh = jax_fit["history"]
    assert [h.get("point_count") for h in th] == [h.get("point_count") for h in jh]
    assert any(h.get("split") for h in th) and any(h.get("cloned") for h in th)
    _assert_matches_jax(ttr, th, jax_fit)


def test_fit_scan_matches_jax(jax_fit, port_scan):
    """``fit_scan`` in chunks of at most 4 against the JAX ``fit``: the
    tolerances of JAX's own tests/test_train.py::test_fit_scan_matches_fit."""
    _assert_matches_jax(port_scan["trainer"], port_scan["history"], jax_fit)
    assert set(port_scan["history"][0]) == {"loss", "psnr", "tile_point_total"}


def test_fit_scan_matches_fit(jax_fit, port_scan):
    """On the CPU ``fit_scan`` runs the step of ``fit`` eagerly, step by step,
    with the camera and target picked from stacks: the parameters, the Adam
    state, the densify accumulators and the history bit for bit."""
    ttr = _port_trainer()
    th = ttr.fit(*_port_fit_inputs(jax_fit), 13)
    str_, sh = port_scan["trainer"], port_scan["history"]
    assert str_.step_count == ttr.step_count
    for key in ("loss", "psnr", "tile_point_total"):
        assert [h[key] for h in sh] == [h[key] for h in th], key
    for f in PARAMS:
        assert torch.equal(getattr(str_.scene, f), getattr(ttr.scene, f)), f
        for got, want in zip(str_._opt_state["adam"][f], ttr._opt_state["adam"][f]):
            assert torch.equal(got, want), f
    assert torch.equal(str_._opt_state["count"], ttr._opt_state["count"])
    for k, v in ttr._densify_acc.items():
        assert torch.equal(str_._densify_acc[k], v), k
    assert int(str_._entry_watermark) == int(ttr._entry_watermark)
    assert str_._entry_capacity == ttr._entry_capacity


def test_fit_scan_chunks_follow_jax_schedule(port_scan):
    """The chunks break where the JAX package's ``next_host_event`` puts the
    host events: on the 13-step fit above, and (steps not run, host events
    skipped) on the default 3DGS schedule with its defaults."""
    jc = GT.TrainConfig(**TRAIN_SCHEDULE)
    assert port_scan["chunks"] == jax_chunks(jc, 0, 13, 4)
    assert port_scan["chunks"] == [4, 1, 1, 1, 1, 2, 2, 1]
    trainer = TT.Trainer(port_scene(train_arrays(5, 1)), W, H)
    recorder = _ChunkRecorder(trainer, run_steps=False)
    trainer._host_events = dict
    trainer.step_count = 2_990
    pair = views(W, H)[1]
    history = trainer.fit_scan([pair], [np.zeros((H, W, 3), np.float32)], 1_210)
    assert len(history) == 1_210
    assert recorder.lengths == jax_chunks(GT.TrainConfig(), 2_990, 1_210, 200)


def test_train_step_batch_loss_is_mean_of_views(jax_fit):
    ttr = _port_trainer()
    tviews, ttargets = _port_fit_inputs(jax_fit)
    scene = ttr.scene
    opts = ttr._options()
    with torch.no_grad():
        per_view = [float(TT.photometric_loss(T.render(scene, v, opts).colors_rgb_2d, t))
                    for v, t in zip(tviews + tviews[:1], ttargets + ttargets[:1])]
        radii = [T.render(scene, v, opts).radii for v in tviews + tviews[:1]]
    before = scene.positions.detach().clone()
    metrics = ttr.train_step_batch(tviews + tviews[:1], ttargets + ttargets[:1])
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(per_view), rtol=1e-6)
    assert ttr.step_count == 3
    assert not torch.equal(ttr.scene.positions.detach(), before)
    visible = sum((r > 0).to(torch.int32) for r in radii)
    assert torch.equal(ttr._densify_acc["visible_count"], visible)
    assert int(ttr._densify_acc["visible_count"].max()) == 3


def test_checkpoint_round_trip(tmp_path):
    a = train_arrays(12, 6)
    scene = port_scene(a)
    optim = TT.make_optimizer()
    state = TT.seed_count(optim.init(scene), 41)
    _, state = optim.update({f: torch.as_tensor(v) for f, v in _grads(1, 12).items()}, state)
    path = str(tmp_path / "ckpt.pt")
    TT.save_training_state(path, scene, state, step=42)
    got_scene, got_state, step = TT.load_training_state(path, optim.init(scene), device="cpu")
    assert step == 42
    for f in PARAMS:
        assert torch.equal(getattr(got_scene, f), getattr(scene, f).detach()), f
        for x, y in zip(got_state["adam"][f], state["adam"][f]):
            assert torch.equal(x, y)
    assert int(got_state["count"]) == 42
    # A template of another layout (other point count) is refused.
    with pytest.raises(ValueError, match="shape"):
        TT.load_training_state(path, optim.init(port_scene(train_arrays(13, 6))), device="cpu")
    bad = {**state, "adam": {k: v for k, v in state["adam"].items() if k != "scalings"}}
    TT.save_training_state(path, scene, bad, step=1)
    with pytest.raises(ValueError, match="structure"):
        TT.load_training_state(path, optim.init(scene), device="cpu")


def test_captured_launches_count_at_replay():
    """A graph's capture runs nothing, so its kernel calls leave the counts
    as they were; each replay adds the captured launches."""
    from gausplat_tpu_torch.utils.kernels import CudaKernel, captured_launches, count_replay

    kernel, idle = CudaKernel("expand.cu", "gs_test_entry", []), CudaKernel("expand.cu", "x", [])
    kernel.launches = 5
    with captured_launches() as recorded:
        kernel.launches += 3  # what three launches of the wrapper do
    assert kernel.launches == 5 and recorded == {kernel: 3} and idle not in recorded
    for _ in range(2):
        count_replay(recorded)
    assert kernel.launches == 11 and idle.launches == 0
