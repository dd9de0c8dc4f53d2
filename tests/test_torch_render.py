"""The whole slice: ``gausplat_tpu_torch.render`` against
``gausplat_tpu.render(backend="xla")`` on the same weights (carried over
with ``GaussianScene.from_arrays``). Image and transmittance atol=1e-4
(the goldens' bound, tests/test_golden_image.py); radii, rendered counts
and ``tile_point_total`` exactly. Also ``render_views``, the validation
errors, capacity calibration and the oracle goldens."""

import os
import pathlib

import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu_torch import errors

from tests.golden_scenes import CASES as GOLDEN_CASES, REFERENCE_FIXTURE
from tests.torch_helpers import (
    MEDIUM, SMALL, assert_outputs_match, scene_arrays, scenes, views,
)

TESTS = pathlib.Path(__file__).parent

RENDER_CASES = {
    "small_tight": (SMALL, 3, True),
    "small_reference_aabb": (SMALL, 3, False),
    "medium_shdeg3": (MEDIUM, 3, True),
    "medium_shdeg1": (MEDIUM, 1, True),
}


def _options(module, c, sh_degree, tight, **extra):
    return module.RenderOptions(
        colors_sh_degree_max=sh_degree, tight_culling=tight,
        tile_entry_capacity=c["capacity"], block_size=c["block"], **extra,
    )


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax(case):
    c, sh_degree, tight = RENDER_CASES[case]
    jscene, tscene = scenes(scene_arrays(c["p"]))
    jview, tview = views(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    want = G.render(jscene, jview, _options(G, c, sh_degree, tight, backend="xla"))
    got = T.render(tscene, tview, _options(T, c, sh_degree, tight), device="cpu")
    assert int(got.tile_point_total) > 100
    assert got.colors_rgb_2d.grad_fn is not None  # differentiable
    assert_outputs_match(want, got, atol=1e-4)


def test_render_overflow_truncates_like_jax():
    c = dict(SMALL, capacity=128)
    jscene, tscene = scenes(scene_arrays(c["p"]))
    jview, tview = views(c["width"], c["height"])
    want = G.render(jscene, jview, _options(G, c, 3, True, backend="xla"))
    got = T.render(tscene, tview, _options(T, c, 3, True))
    assert int(got.tile_point_total) > 128
    assert_outputs_match(want, got, atol=1e-4)


def test_render_views_matches_jax():
    c = SMALL
    jscene, tscene = scenes(scene_arrays(c["p"]))
    pairs = [views(c["width"], c["height"], position=(x, 0.1, -4.0)) for x in (-0.4, 0.0, 0.5)]
    want = G.render_views(jscene, [j for j, _ in pairs], _options(G, c, 3, True, backend="xla"))
    got = T.render_views(tscene, [t for _, t in pairs], _options(T, c, 3, True))
    assert got.colors_rgb_2d.shape == (3, c["height"], c["width"], 3)
    assert_outputs_match(want, got, atol=1e-4)


@pytest.mark.parametrize("mode", ["vmap", "map"])
def test_render_views_modes_match_render_and_jax(mode):
    """Each mode bit for bit against stacked ``render`` calls (and
    differentiable), and within 1e-4 of the JAX ``render_views`` in the
    same mode; any other mode raises ``ValueError`` before any work."""
    c = SMALL
    jscene, tscene = scenes(scene_arrays(c["p"]))
    # The views of test_render_views_matches_jax: one JAX compile serves both.
    pairs = [views(c["width"], c["height"], position=(x, 0.1, -4.0)) for x in (-0.4, 0.0, 0.5)]
    opts = _options(T, c, 3, True)
    got = T.render_views(tscene, [t for _, t in pairs], opts, mode=mode)
    singles = [T.render(tscene, t, opts) for _, t in pairs]
    for field, value in zip(got._fields, got):
        assert torch.equal(value, torch.stack([getattr(o, field) for o in singles])), field
    torch.sum(got.colors_rgb_2d).backward()
    assert tscene.positions.grad is not None and bool(tscene.positions.grad.abs().sum() > 0)
    want = G.render_views(jscene, [j for j, _ in pairs], _options(G, c, 3, True, backend="xla"),
                          mode=mode)
    assert_outputs_match(want, got, atol=1e-4)
    with pytest.raises(ValueError, match="mode"):
        T.render_views(tscene, [t for _, t in pairs], opts, mode="bogus")


def test_calibrate_options_matches_jax():
    c = MEDIUM
    jscene, tscene = scenes(scene_arrays(c["p"]))
    pairs = [views(c["width"], c["height"], position=(x, 0.0, -4.0)) for x in (0.0, 0.6)]
    for tight in (True, False):
        jopt = G.RenderOptions(tight_culling=tight)
        topt = T.RenderOptions(tight_culling=tight)
        assert T.count_tile_entries(tscene, pairs[1][1], topt) == G.count_tile_entries(
            jscene, pairs[1][0], jopt)
        got = T.calibrate_options(tscene, [t for _, t in pairs], topt)
        want = G.calibrate_options(jscene, [j for j, _ in pairs], jopt)
        assert got.tile_entry_capacity == want.tile_entry_capacity


def test_capacity_rounding_matches_jax():
    from gausplat_tpu.render.pipeline import _capacity as jax_capacity
    from gausplat_tpu_torch.render.pipeline import _capacity

    for p, cap, block in [(80, None, 64), (5000, None, 256), (80, 70000, 256), (3, 10, 64)]:
        assert _capacity(p, T.RenderOptions(tile_entry_capacity=cap, block_size=block)) == \
            jax_capacity(p, G.RenderOptions(tile_entry_capacity=cap, block_size=block))


def test_validation_errors():
    _, tscene = scenes(scene_arrays(8))
    _, tview = views(32, 32)
    with pytest.raises(errors.UnsupportedSphericalHarmonicsDegreeError):
        T.render(tscene, tview, T.RenderOptions(colors_sh_degree_max=4))
    bf16 = T.render(tscene, tview, T.RenderOptions(entry_dtype="bf16"))
    f32 = T.render(tscene, tview)
    assert bf16.colors_rgb_2d.shape == (32, 32, 3) and bool(torch.isfinite(bf16.colors_rgb_2d).all())
    assert torch.equal(bf16.radii, f32.radii) and int(bf16.tile_point_total) > 0
    with pytest.raises(ValueError, match="entry_dtype"):
        T.render(tscene, tview, T.RenderOptions(entry_dtype="f16"))
    with pytest.raises(errors.InvalidPixelCountError):
        T.render(tscene, views(0, 32)[1])
    with pytest.raises(errors.InvalidPixelCountError):
        T.render(tscene, views(4096, 4097)[1])
    _, empty = scenes({k: v[:0] for k, v in scene_arrays(8).items()})
    with pytest.raises(errors.MismatchedPointCountError):
        T.render(empty, tview)
    with pytest.raises(ValueError, match="backend"):
        T.render(tscene, tview, T.RenderOptions(backend="pallas"))
    with pytest.raises(ValueError, match="CUDA"):
        T.render(tscene, tview, T.RenderOptions(backend="cuda"))
    with pytest.raises(ValueError, match="scene is on"):
        T.render(tscene, tview, device="meta")
    with pytest.raises(errors.InvalidPixelCountError):
        T.render_views(tscene, [tview, views(48, 32)[1]])
    with pytest.raises(ValueError):
        T.render_views(tscene, [])


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_image(case):
    """The port against the f64 oracle goldens; only the two sixstars cases
    need the reference renderer's PLY fixture."""
    if case.startswith("sixstars") and not os.path.exists(REFERENCE_FIXTURE):
        pytest.skip("reference fixture not present")
    make_scene, make_view, sh_degree = GOLDEN_CASES[case]
    jview = make_view()
    tview = T.View(
        field_of_view_x=jview.field_of_view_x, field_of_view_y=jview.field_of_view_y,
        image_height=jview.image_height, image_width=jview.image_width,
        view_position=jview.view_position, view_transform=jview.view_transform,
    )
    opts = T.RenderOptions(
        colors_sh_degree_max=sh_degree, tile_entry_capacity=1 << 14, block_size=64,
        tight_culling=False,
    )
    img = T.render(T.GaussianScene.from_arrays(make_scene(), device="cpu"), tview, opts)
    golden = np.load(TESTS / f"golden_{case}.npy")
    np.testing.assert_allclose(img.colors_rgb_2d.detach().numpy(), golden, atol=1e-4)
