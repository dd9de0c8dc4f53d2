"""The JAX package's multi-device answers for the port's parallel tests.

``gausplat_tpu.parallel`` compiles its sharded programs for the 8-device
virtual CPU mesh in minutes each (tests/test_parallel.py's four tests
take 90-250 s apiece on one CPU host), too long to run again in every
test run of the port. This file runs them once on that mesh and stores
their inputs and outputs in ``tests/data/torch_parallel_xcheck.npz``;
``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded_train.py``
hold the port's 4 spawned gloo ranks to it. The inputs are the JAX tests'
own (tests/test_parallel.py, tests/test_sharded_train.py):

- ``data_parallel``: ``render_data_parallel`` of 4 views (64x64) of the
  40-point scene on a 4-way ``data`` axis, and ``jax.value_and_grad`` of
  ``mean(image ** 2)`` for the five parameters and the densification ref;
- ``tile_sharded``: ``render_tile_sharded`` of one 64x48 view on a 4-way
  ``tiles`` axis (slabs of 16 rows, the last all padding), and its
  gradients likewise;
- ``l1``, ``l1+dssim``, ``non-divisible-height``: one step of
  ``make_sharded_train_step`` on a (2, 2) mesh from the 30-point scene,
  targets padded with 7.7: loss, entry total, updated parameters and the
  densify statistics;
- ``fit``: ``ShardedTrainer.fit`` for 4 steps with densify events after
  steps 2 and 4: losses, point counts and the final parameters.

Regenerate, from the root of the repository:

    PYTHONPATH=. python tests/torch_parallel_fixture.py
"""

import os
import pathlib
import time

import numpy as np

PATH = pathlib.Path(__file__).resolve().parent / "data" / "torch_parallel_xcheck.npz"

FIELDS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
W = 64
#: Heights: the data-parallel views, the tile-sharded view, the train views.
RENDER_H, TILE_H, TRAIN_HEIGHTS = 64, 48, (64, 48)
RENDER = dict(tile_entry_capacity=2048, block_size=64)
TILE_RENDER = dict(tile_entry_capacity=4096, block_size=64)
TRAIN_RENDER = dict(tile_entry_capacity=4096, block_size=64)
#: The sharded step's cases: (name, height, ssim_weight).
STEP_CASES = (("l1", 64, 0.0), ("l1+dssim", 64, 0.2), ("non-divisible-height", 48, 0.2))
FIT_STEPS = 4
#: tests/test_sharded_train.py::test_sharded_fit_with_densify_event's schedule.
FIT_CONFIG = dict(ssim_weight=0.0, densify_from=1, densify_until=10, densify_interval=2,
                  opacity_reset_interval=10**9)
FIT_DENSIFY = dict(grad_threshold=1e-7, percent_dense=0.05)


def render_views(module, n, height):
    """tests/test_parallel.py::_views, in either package."""
    out = []
    for i in range(n):
        c, s = np.cos(0.15 * i), np.sin(0.15 * i)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        out.append(module.View(
            field_of_view_x=1.0, field_of_view_y=1.0, image_height=height, image_width=W,
            view_id=i, view_position=[4 * s, 0.0, -4 * c],
            view_transform=module.View.transform(rot.T, [0.0, 0.0, 4.0])))
    return out


def train_views(module, n, height):
    """tests/test_sharded_train.py::_views, in either package."""
    out = []
    for i in range(n):
        c, s = np.cos(0.2 * i), np.sin(0.2 * i)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([4 * s, 0.0, -4 * c])
        out.append(module.View(
            field_of_view_x=1.0, field_of_view_y=1.0, image_height=height, image_width=W,
            view_id=i, view_position=pos, view_transform=module.View.transform(rot.T, -rot @ pos)))
    return out


def jax_scene(p, seed, spread, scale, opacity):
    """The JAX tests' scene recipe: ``from_points`` of seeded points, then
    per-axis scales ``scale[0] + scale[1] * U`` and opacities likewise."""
    import jax.numpy as jnp

    import gausplat_tpu as G

    rng = np.random.default_rng(seed)
    pts = G.Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * spread)
    scene = G.GaussianScene.from_points(pts)
    scene = scene.set_scalings(jnp.asarray(scale[0] + scale[1] * rng.random((p, 3)),
                                           jnp.float32))
    return scene.set_opacities(jnp.asarray(opacity[0] + opacity[1] * rng.random((p, 1)),
                                           jnp.float32))


#: name -> the recipe's arguments: tests/test_parallel.py::_scene,
#: tests/test_sharded_train.py::_scene (train, target at seed 9, fit).
SCENES = {
    "render": dict(p=40, seed=2, spread=0.8, scale=(0.03, 0.1), opacity=(0.2, 0.6)),
    "train": dict(p=30, seed=3, spread=0.6, scale=(0.05, 0.1), opacity=(0.3, 0.5)),
    "target": dict(p=30, seed=9, spread=0.6, scale=(0.05, 0.1), opacity=(0.3, 0.5)),
    "fit": dict(p=24, seed=4, spread=0.6, scale=(0.05, 0.1), opacity=(0.3, 0.5)),
}


def _arrays(scene) -> dict:
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


def _value_and_grads(scene, fn) -> dict:
    """``fn(scene, ref)``'s outputs and the gradients of mean(image ** 2)."""
    import jax
    import jax.numpy as jnp

    def loss(s, ref):
        out = fn(s, ref)
        return jnp.mean(out.colors_rgb_2d ** 2), out

    ref = jnp.zeros((scene.point_count,), jnp.float32)
    (_, out), (g_scene, g_ref) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        scene, ref)
    rec = {field: np.asarray(getattr(out, field)) for field in out._fields}
    rec.update({f"grad/{f}": np.asarray(getattr(g_scene, f)) for f in FIELDS})
    rec["grad/norm"] = np.asarray(g_ref)
    return rec


def build(log=print) -> dict:
    import jax.numpy as jnp

    import gausplat_tpu as G
    from gausplat_tpu import train as GT
    from gausplat_tpu.parallel import make_mesh, render_data_parallel, render_tile_sharded
    from gausplat_tpu.parallel.render import stack_cameras
    from gausplat_tpu.parallel.train_step import ShardedTrainer, make_sharded_train_step
    from gausplat_tpu.train.densify import zero_densify_acc

    scenes = {name: jax_scene(**kw) for name, kw in SCENES.items()}
    out = {f"scene/{name}/{f}": v for name, s in scenes.items()
           for f, v in _arrays(s).items()}
    records = {}

    start = time.perf_counter()
    mesh = make_mesh((4,), ("data",))
    cams = stack_cameras(render_views(G, 4, RENDER_H))
    opts = G.RenderOptions(backend="xla", **RENDER)
    records["data_parallel"] = _value_and_grads(scenes["render"], lambda s, ref: (
        render_data_parallel(s, cams, W, RENDER_H, mesh, "data", opts,
                             positions_2d_grad_norm_ref=ref)))
    log(f"data_parallel {time.perf_counter() - start:.1f} s")

    start = time.perf_counter()
    mesh = make_mesh((4,), ("tiles",))
    view = render_views(G, 1, TILE_H)[0]
    opts = G.RenderOptions(backend="xla", **TILE_RENDER)
    records["tile_sharded"] = _value_and_grads(scenes["render"], lambda s, ref: (
        render_tile_sharded(s, view, mesh, "tiles", opts, positions_2d_grad_norm_ref=ref)))
    log(f"tile_sharded {time.perf_counter() - start:.1f} s")

    opts = G.RenderOptions(backend="xla", **TRAIN_RENDER)
    for h in TRAIN_HEIGHTS:
        out[f"targets/{h}"] = np.stack([
            np.asarray(G.render(scenes["target"], v, opts).colors_rgb_2d)
            for v in train_views(G, 2, h)])
    mesh = make_mesh((2, 2), ("data", "tiles"))
    for name, h, ssim_weight in STEP_CASES:
        start = time.perf_counter()
        scene = scenes["train"]
        step, optimizer, h_pad, _ = make_sharded_train_step(
            mesh, W, h, scene.point_count, opts, ssim_weight=ssim_weight)
        tgt = jnp.asarray(np.pad(out[f"targets/{h}"], ((0, 0), (0, h_pad - h), (0, 0), (0, 0)),
                                 constant_values=7.7))
        new_scene, _, acc, metrics = step(scene, optimizer.init(scene),
                                          zero_densify_acc(scene.point_count),
                                          stack_cameras(train_views(G, 2, h)), tgt)
        records[name] = dict(h_pad=np.array(h_pad), **_arrays(new_scene),
                             **{k: np.asarray(v) for k, v in {**metrics, **acc}.items()})
        log(f"{name} {time.perf_counter() - start:.1f} s")

    start = time.perf_counter()
    config = GT.TrainConfig(render=opts, densify=GT.DensifyConfig(**FIT_DENSIFY), **FIT_CONFIG)
    trainer = ShardedTrainer(scenes["fit"], mesh, W, 64, config)
    history = trainer.fit(stack_cameras(train_views(G, 2, 64)), out["targets/64"], FIT_STEPS)
    records["fit"] = dict(loss=np.array([h["loss"] for h in history]),
                          point_count=np.array([h.get("point_count", -1) for h in history]),
                          **_arrays(trainer.scene))
    log(f"fit {time.perf_counter() - start:.1f} s")

    out.update({f"{case}/{k}": v for case, rec in records.items() for k, v in rec.items()})
    return out


def main():
    # The JAX package's test mesh (tests/conftest.py): 8 virtual CPU devices.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    PATH.parent.mkdir(exist_ok=True)
    np.savez_compressed(PATH, **build())
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
