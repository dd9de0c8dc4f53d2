"""The port's last three scripts against the JAX package's, on the CPU:
``train_convergence``'s setup, config and host-event schedule against the
JAX script's lines; ``mesh_scale``'s parity step and dry run at n = 8 and
``train_sharded_compare`` at 2 steps, all in one spawn of 8 gloo ranks
(the rank worker is ``gausplat_tpu_torch.testing.scripts_worker``), held
to the JAX script's tolerances, the JAX record ``MESH_SCALE_r05.json`` and
the JAX ``value_and_grad`` + Adam and ``Trainer.train_step_batch``; and the
densify interval of the JAX lego record ``train_long_r05_lego.json``.
"""

import dataclasses
import json
import pathlib
from collections import namedtuple

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu_torch.scripts import mesh_scale as MS
from gausplat_tpu_torch.scripts import train_convergence as TC
from gausplat_tpu_torch.scripts import train_long as TL
from gausplat_tpu_torch.scripts import train_sharded_compare as SC
from gausplat_tpu_torch.testing import scripts_worker, spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
COMPARE_STEPS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("scripts_ranks")
    spawn_ranks(scripts_worker, 8, str(out), COMPARE_STEPS)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]


# --- train_convergence ----------------------------------------------------------------


def _jax_convergence_script(iters):
    """``scripts/train_convergence.py``'s lines up to its ``Trainer`` (the
    script runs at import), without the target renders."""
    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu.train import TrainConfig

    size = 256
    opts = G.RenderOptions(tile_entry_capacity=1 << 17, block_size=256)
    rng = np.random.default_rng(0)
    p = 500
    truth = G.GaussianScene.from_points(
        G.Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.7))
    truth = truth.set_scalings(jnp.asarray(0.03 + 0.08 * rng.random((p, 3)), jnp.float32))
    truth = truth.set_opacities(jnp.asarray(0.3 + 0.6 * rng.random((p, 1)), jnp.float32))
    views = []
    for i in range(10):
        a = 2 * np.pi * i / 10
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([4 * s, 0.0, -4 * c])
        views.append(G.View(field_of_view_x=1.0, field_of_view_y=1.0, image_height=size,
                            image_width=size, view_id=i, view_position=pos,
                            view_transform=G.View.transform(rot.T, -rot @ pos)))
    q = 150
    start = G.GaussianScene.from_points(
        G.Points(rng.random((q, 3)).astype(np.float32), rng.standard_normal((q, 3)) * 0.7))
    cfg = TrainConfig(render=opts, densify_from=300, densify_until=iters - 300,
                      densify_interval=150, sh_warmup_interval=300,
                      opacity_reset_interval=10**9)
    return truth, views, start, cfg


def _schedule(next_event, config, end):
    now, events = 0, []
    while now < end:
        now = next_event(config, now, end)
        events.append(now)
    return events


def test_train_convergence_matches_the_jax_script(monkeypatch):
    """The setup is ``long_fit_setup(lego=False)``'s, draw for draw the JAX
    script's (the target renders, which ``test_torch_tools.py`` holds to
    JAX, are stubbed here); the config equals the script's field by field
    and follows the JAX ``Trainer``'s host-event schedule over all 1,500
    steps."""
    from gausplat_tpu.train.trainer import next_host_event as jax_next

    iters = 1500
    frame = namedtuple("Frame", "colors_rgb_2d")
    rendered = []

    def stub_render(scene, view, options):
        rendered.append(view.view_id)
        return frame(torch.zeros((view.image_height, view.image_width, 3)))

    monkeypatch.setattr(TL, "render", stub_render)
    setup = TC.convergence_setup(iters, "cpu")
    toy = TL.long_fit_setup(lego=False, device="cpu", iterations=iters)
    assert rendered == list(range(10)) * 2
    assert setup["options"] == toy["options"] and setup["size"] == toy["size"] == 256
    for name in ("truth", "start"):
        for f in FIELDS:
            assert torch.equal(getattr(setup[name], f), getattr(toy[name], f)), (name, f)

    truth, views, start, cfg = _jax_convergence_script(iters)
    for f in FIELDS:
        got = getattr(setup["truth"], f).detach().numpy()
        want = np.asarray(getattr(truth, f))
        if f in ("opacities", "scalings"):  # through each package's log: one ulp
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(getattr(setup["start"], f).detach().numpy(),
                                      np.asarray(getattr(start, f)), err_msg=f)
    for tv, jv in zip(setup["views"], views, strict=True):
        for key in ("field_of_view_x", "field_of_view_y", "image_height", "image_width",
                    "view_id"):
            assert getattr(tv, key) == getattr(jv, key), key
        np.testing.assert_array_equal(tv.view_transform, jv.view_transform)

    config = setup["config"]
    for field in dataclasses.fields(config):
        got, want = getattr(config, field.name), getattr(cfg, field.name)
        if field.name == "render":
            for key in ("colors_sh_degree_max", "tile_entry_capacity", "block_size",
                        "tight_culling"):
                assert getattr(got, key) == getattr(want, key), key
        elif field.name in ("optimizer", "densify"):
            for sub in dataclasses.fields(got):
                assert getattr(got, sub.name) == getattr(want, sub.name), (field.name, sub.name)
        else:
            assert got == want, field.name
    assert config.optimizer.scene_extent == config.densify.scene_extent == 1.0
    events = _schedule(T.train.next_host_event, config, iters)
    assert events == _schedule(jax_next, cfg, iters)
    assert set(range(300, 1200, 150)) <= set(events)  # every densify event
    assert TC.curve_steps(iters) == (0, 375, 750, 1125, 1499)


# --- mesh_scale at n = 8 and its dry run --------------------------------------------------


def _jax_mesh_scale_reference(n):
    """``scripts/mesh_scale.py``'s worker without its mesh: the single-device
    loss over both views with the densification ref, its gradients, and the
    scene after one Adam update."""
    import jax
    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu.train.losses import photometric_loss
    from gausplat_tpu.train.optimizer import make_optimizer

    w, h = 64, (n // 2 + 1) * 16
    opts = G.RenderOptions(backend="xla", tile_entry_capacity=8192, block_size=64)
    rng = np.random.default_rng(3)
    p = 60
    scene = G.GaussianScene.from_points(
        G.Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.6))
    scene = scene.set_scalings(jnp.asarray(0.05 + 0.1 * rng.random((p, 3)), jnp.float32))
    scene = scene.set_opacities(jnp.asarray(0.3 + 0.5 * rng.random((p, 1)), jnp.float32))
    views = []
    for i in range(2):
        a = 0.2 * i
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([4 * s, 0.0, -4 * c])
        views.append(G.View(field_of_view_x=1.0, field_of_view_y=2.0, image_height=h,
                            image_width=w, view_id=i, view_position=pos,
                            view_transform=G.View.transform(rot.T, -rot @ pos)))
    targets = [np.asarray(G.render(scene, v, opts).colors_rgb_2d) * 0.5 for v in views]

    def loss_fn(s, ref):
        total = 0.0
        for v, t in zip(views, targets):
            out = G.render(s, v, opts, positions_2d_grad_norm_ref=ref)
            total = total + photometric_loss(out.colors_rgb_2d, jnp.asarray(t), 0.2)
        return total / len(views)

    loss, (grads, grad_norm) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        scene, jnp.zeros((p,), jnp.float32))
    optimizer = make_optimizer()
    updates, _ = optimizer.update(grads, optimizer.init(scene), scene)
    new = jax.tree_util.tree_map(lambda q, u: q + u, scene, updates)
    return float(loss), np.asarray(grad_norm), {f: np.asarray(getattr(new, f)) for f in FIELDS}


def test_mesh_scale_at_8_ranks_matches_jax(ranks):
    """The JAX script's gates at n = 8 (rank 0's, against the port's
    single-device step), the loss within 1e-5 relative of the record's
    ``loss_ref``, every rank the same result, slab 3 (rows 96-127 of an
    80-row frame) wholly in the padding, and the updated scene against the
    JAX package's single-device ``value_and_grad`` + Adam."""
    got = ranks[0]
    errors = {k.split("/")[-1]: float(v) for k, v in got.items() if k.startswith("parity/errors/")}
    assert MS.parity_within(errors), errors
    assert int(got["parity/h_pad"]) == 128 and int(got["parity/tile_point_total"]) > 0
    record = MS.record_losses()[8]
    assert abs(float(got["parity/loss"]) - record) <= 1e-5 * record
    for r, rank in enumerate(ranks):
        assert float(rank["parity/loss"]) == float(got["parity/loss"]), r
        for f in FIELDS:
            np.testing.assert_array_equal(rank[f"parity/scene/{f}"], got[f"parity/scene/{f}"])
        assert list(rank["parity/slab"]) == [(r % 4) * 32, 32]
        assert bool(rank["parity/pad_slab"]) == (r % 4 == 3)

    loss, grad_norm, scene = _jax_mesh_scale_reference(8)
    np.testing.assert_allclose(float(got["parity/loss"]), loss, rtol=1e-5)
    for f in FIELDS:
        np.testing.assert_allclose(got[f"parity/scene/{f}"], scene[f], atol=2e-5, rtol=0,
                                   err_msg=f)
    scale = float(grad_norm.max())
    np.testing.assert_allclose(got["parity/grad_norm_sum"] / scale, grad_norm / scale,
                               atol=5e-5, rtol=0)


def _jax_dryrun_loss(d_data):
    """The JAX single-device loss of the dry run's toy mode: its toy scene
    (``__graft_entry__._toy_scene_and_camera``) rendered from the 2 * data
    copies of its camera, the mean photometric loss (SSIM weight 0.2, the
    sharded step's default) against zero targets."""
    import importlib.util

    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu.train.losses import photometric_loss

    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    scene, _, base = entry._toy_scene_and_camera(128, 64, 48)
    opts = G.RenderOptions(backend="xla", tile_entry_capacity=1 << 14, block_size=64)
    losses = []
    for i in range(2 * d_data):
        view = G.View(field_of_view_x=base.field_of_view_x, field_of_view_y=base.field_of_view_y,
                      image_height=48, image_width=64, view_id=i,
                      view_position=base.view_position, view_transform=base.view_transform)
        image = G.render(scene, view, opts).colors_rgb_2d
        losses.append(float(photometric_loss(image, jnp.zeros_like(image), 0.2)))
    return sum(losses) / len(losses)


def test_dryrun_toy_at_8_ranks(ranks):
    """The dry run's sharded step at n = 8 on the (2, 4) mesh: a finite
    loss with entries, the same on every rank, and within 1e-5 relative of
    the JAX package's single-device loss of the same toy scene and views."""
    for rank in ranks:
        assert list(rank["dryrun/mesh"]) == [2, 4] and int(rank["dryrun/h_pad"]) == 64
        assert np.isfinite(float(rank["dryrun/loss"])) and int(rank["dryrun/entries"]) > 0
        assert float(rank["dryrun/loss"]) == float(ranks[0]["dryrun/loss"])
    np.testing.assert_allclose(float(ranks[0]["dryrun/loss"]), _jax_dryrun_loss(2), rtol=1e-5)


# --- train_sharded_compare --------------------------------------------------------------


def test_train_sharded_compare_matches_single_and_jax(ranks):
    """Two steps: the sharded scene within 2e-5 of the single batched
    trainer's, and the single side's losses within 1e-5 relative of the
    JAX ``Trainer.train_step_batch``'s on the same targets. The single
    trainer's ``step_count`` is 4 after its first call, so its second step
    renders at SH degree 3 where the sharded one renders at degree 1: the
    SH coefficients of degrees 2 and 3 (``colors_sh`` is ``[P, 16, 3]``
    flattened: columns 12-47) move on the single side only, and stay at
    their start on the sharded one."""
    import gausplat_tpu as G
    from gausplat_tpu.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    single = SC.run_single(COMPARE_STEPS, "cpu", log=lambda line: None)
    start = SC.scene_arrays(SC.fresh("cpu"))["colors_sh"][:, 12:]
    for f in FIELDS:
        got, want = ranks[0][f"sharded/scene/{f}"], single["scene"][f]
        if f == "colors_sh":
            np.testing.assert_array_equal(got[:, 12:], start)
            assert np.abs(want[:, 12:] - start).max() > 2e-5
            got, want = got[:, :12], want[:, :12]
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=f)
    np.testing.assert_allclose(ranks[0]["sharded/losses"], single["losses"], rtol=2e-4)
    for rank in ranks[1:]:
        np.testing.assert_array_equal(rank["sharded/losses"], ranks[0]["sharded/losses"])

    views = SC.compare_views()
    targets = [t.numpy() for t in SC.compare_targets(views, "cpu")]
    jviews = [G.View(field_of_view_x=v.field_of_view_x, field_of_view_y=v.field_of_view_y,
                     image_height=v.image_height, image_width=v.image_width, view_id=v.view_id,
                     view_position=v.view_position, view_transform=v.view_transform)
              for v in views]
    r = np.random.default_rng(7)
    jstart = G.GaussianScene.from_points(
        G.Points(r.random((120, 3)).astype(np.float32), r.standard_normal((120, 3)) * 0.7))
    opts = G.RenderOptions(backend="xla", tile_entry_capacity=1 << 16, block_size=128)
    trainer = Trainer(jstart, SC.SIZE, SC.SIZE, TrainConfig(
        render=opts, densify_from=10**9, sh_warmup_interval=1, opacity_reset_interval=10**9))
    losses = [float(trainer.train_step_batch(jviews, targets)["loss"])
              for _ in range(COMPARE_STEPS)]
    np.testing.assert_allclose(single["losses"], losses, rtol=1e-5)


# --- the lego record's densify interval ---------------------------------------------------


def test_lego_point_count_changes_only_at_multiples_of_500():
    """Each 200-step chunk in which the point count changes holds a multiple
    of 500 (so chunks that hold only multiples of 300 leave it): the JAX
    record ran at a densify interval of 500, as the port's rerun does."""
    for name in ("train_long_r05_lego.json", "train_long_h100_lego_i500.json"):
        data = json.loads((ROOT / name).read_text())
        records = data["records"] if isinstance(data, dict) else data
        changed = 0
        for before, after in zip(records, records[1:]):
            if after["points"] != before["points"]:
                changed += 1
                chunk = range(before["step"] + 1, after["step"] + 1)
                assert any(k % 500 == 0 for k in chunk), (name, after["step"])
        assert changed >= 20, name
