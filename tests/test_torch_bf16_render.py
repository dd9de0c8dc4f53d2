"""The whole render and the trainer with bf16 entry rows
(``RenderOptions(entry_dtype="bf16")``) of gausplat_tpu_torch against the
JAX package, on the CPU.

- ``render`` with bf16 rows against ``gausplat_tpu.render(backend="xla")``
  with bf16 rows: images and transmittances atol 1e-4, integers exactly.
- Its gradients (five parameters and the densification signal) against
  ``jax.grad`` within ``BF16_GRAD_ATOL`` (2e-4) scaled by each field's
  largest magnitude: twice the f32 bound, because the per-entry gradient
  rows flip bf16 roundings against JAX's (tests/test_torch_bf16.py;
  measured here: at most 4.8e-5).
- ``Trainer`` with bf16 rows against the JAX ``Trainer`` over 5 steps:
  losses rtol 1e-4, entry totals exactly, parameters atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu import train as GT
from gausplat_tpu_torch import train as TT

from tests.torch_helpers import (
    MEDIUM, SMALL, assert_outputs_match, assert_scaled_close, scene_arrays, scenes, views,
)

CASES = {"small": SMALL, "medium": MEDIUM}
BF16_GRAD_ATOL = 2e-4
PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")


def _options(module, c, **extra):
    return module.RenderOptions(tile_entry_capacity=c["capacity"], block_size=c["block"],
                                entry_dtype="bf16", **extra)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_render_and_grads_match_jax(case):
    c = CASES[case]
    jscene, tscene = scenes(scene_arrays(c["p"]))
    jview, tview = views(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    jopts = _options(G, c, backend="xla")
    weight = np.random.default_rng(5).standard_normal(
        (c["height"], c["width"], 3)).astype(np.float32)

    def loss(s, r):
        out = G.render(s, jview, jopts, r)
        return jnp.sum(out.colors_rgb_2d * weight), out

    (_, want), (jgrads, jnorm) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jscene, jnp.zeros((c["p"],)))
    ref = torch.zeros(c["p"], requires_grad=True)
    got = T.render(tscene, tview, _options(T, c), ref, device="cpu")
    assert int(got.tile_point_total) > 100
    assert_outputs_match(want, got, atol=1e-4)
    torch.sum(got.colors_rgb_2d * torch.as_tensor(weight)).backward()
    for name in PARAMS:
        assert_scaled_close(getattr(tscene, name).grad.numpy(), np.asarray(getattr(jgrads, name)),
                            err_msg=name, atol=BF16_GRAD_ATOL)
    assert_scaled_close(ref.grad.numpy(), np.asarray(jnorm), err_msg="norm", atol=BF16_GRAD_ATOL)


def _train_arrays(p, seed):
    """tests/test_torch_train.py's anisotropic scene."""
    rng = np.random.default_rng(seed)
    return dict(
        colors_sh=(rng.standard_normal((p, 48)) * 0.3).astype(np.float32),
        opacities=np.full((p, 1), np.log(0.7 / 0.3), np.float32),
        positions=(rng.standard_normal((p, 3)) * 0.6).astype(np.float32),
        rotations=rng.standard_normal((p, 4)).astype(np.float32),
        scalings=np.log(0.08 + 0.15 * rng.random((p, 3))).astype(np.float32),
    )


def test_bf16_trainer_matches_jax():
    w = h = 48
    kw = dict(tile_entry_capacity=2048, block_size=64, entry_dtype="bf16")
    jopts, topts = G.RenderOptions(backend="xla", **kw), T.RenderOptions(**kw)
    pairs = [views(w, h), views(w, h, position=(0.3, 0.1, -4.0))]
    target = G.GaussianScene(**{k: jnp.asarray(v) for k, v in _train_arrays(25, 5).items()})
    targets = [np.array(G.render(target, j, jopts).colors_rgb_2d) for j, _ in pairs]
    start = _train_arrays(25, 9)
    jtr = GT.Trainer(G.GaussianScene(**{k: jnp.asarray(v) for k, v in start.items()}), w, h,
                     GT.TrainConfig(render=jopts))
    ttr = TT.Trainer(T.GaussianScene.from_numpy(**start, device="cpu"), w, h,
                     TT.TrainConfig(render=topts))
    jh = jtr.fit([j for j, _ in pairs], targets, 5)
    th = ttr.fit([t for _, t in pairs], [torch.as_tensor(x) for x in targets], 5)
    assert ttr._options().entry_dtype == "bf16"
    np.testing.assert_allclose([x["loss"] for x in th], [x["loss"] for x in jh], rtol=1e-4)
    np.testing.assert_array_equal([x["tile_point_total"] for x in th],
                                  [x["tile_point_total"] for x in jh])
    for f in PARAMS:
        np.testing.assert_allclose(getattr(ttr.scene, f).detach().numpy(),
                                   np.asarray(getattr(jtr.scene, f)), atol=1e-4, err_msg=f)
