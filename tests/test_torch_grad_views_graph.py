"""The differentiable ``render_views`` through its graph pair
(``render/grad_graph.py``, entry point ``"render_views"``) on the CPU, and
``parallel.render_views``'s (``"parallel.render_views"``).

On the card a differentiable ``render_views`` call is one forward graph
replay of every view's render, one after another on one stream in either
mode, each field stacked, and its backward one backward graph replay. On a
CPU device ``_render_views_graphed`` runs the same pair with every replay
eager. Held here, on SMALL from the views of
``tests/test_torch_render.py::test_render_views_matches_jax``:

- against ``jax.grad`` of ``gausplat_tpu.render_views(backend="xla")`` of
  ``sum(image * G)`` (one JAX compile, the ``vmap`` mode), after the
  warm-up, the capture and a replay, within 1e-4 scaled by each field's
  largest magnitude, in both modes;
- bit for bit against ``_render_views_eager`` and its autograd backward,
  every output and gradient, over the sequences of
  ``tests/test_torch_grad_graph.py`` (two calls before one backward,
  backwards in the reverse order, a dropped call, a kept call, a frozen
  parameter subset, an in-place update between calls and one between a
  call and its backward), the modes taking turns call by call: one pair
  serves both;
- ``parallel.render_views`` through its pair bit for bit its eager form;
- ``render`` and ``render_views`` called in turn keep one pair each.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu_torch.parallel import stack_cameras
from gausplat_tpu_torch.parallel.render import _views_eager, _views_graphed
from gausplat_tpu_torch.render.grad_graph import grad_graph
from gausplat_tpu_torch.render.pipeline import (
    _render_graphed, _render_views_eager, _render_views_graphed,
)

from tests.torch_helpers import SMALL, assert_scaled_close, scene_arrays, scenes, views

CPU = torch.device("cpu")
PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
C = SMALL
PAIRS = [views(C["width"], C["height"], position=(x, 0.1, -4.0)) for x in (-0.4, 0.0, 0.5)]
VIEWS_A = [t for _, t in PAIRS]
VIEWS_B = VIEWS_A[1:] + VIEWS_A[:1]  # new cameras, the same count
WEIGHTS = [torch.as_tensor(np.random.default_rng(seed).standard_normal(
    (len(VIEWS_A), C["height"], C["width"], 3)).astype(np.float32)) for seed in (5, 6)]
MODES = ("vmap", "map")


def _options(module, **extra):
    return module.RenderOptions(tile_entry_capacity=C["capacity"], block_size=C["block"],
                                **extra)


def _pair(name):
    graph = grad_graph(name, CPU)
    graph.release()
    return graph


@functools.lru_cache(maxsize=1)
def _jax_grads():
    jscene, _ = scenes(scene_arrays(C["p"]))

    def loss(scene):
        out = G.render_views(scene, [j for j, _ in PAIRS], _options(G, backend="xla"))
        return jnp.sum(out.colors_rgb_2d * WEIGHTS[0].numpy())

    grads = jax.grad(loss)(jscene)
    return {name: np.asarray(getattr(grads, name)) for name in PARAMS}


@pytest.mark.parametrize("mode", MODES)
def test_graphed_render_views_grads_match_jax(mode):
    want = _jax_grads()
    graph = _pair("render_views")
    scene = T.GaussianScene.from_numpy(**scene_arrays(C["p"]), device="cpu")
    for _ in range(3):  # the warm-up, the capture, a replay
        scene.zero_grad(set_to_none=True)
        out = _render_views_graphed(scene, VIEWS_A, _options(T), mode)
        torch.sum(out.colors_rgb_2d * WEIGHTS[0]).backward()
    assert (graph.captures, graph.replays) == (1, {"forward": 2, "backward": 2})
    assert out.colors_rgb_2d.shape == (len(VIEWS_A), C["height"], C["width"], 3)
    for name in PARAMS:
        got = getattr(scene, name).grad.numpy()
        assert np.isfinite(got).all() and np.abs(want[name]).max() > 0, name
        assert_scaled_close(got, want[name], err_msg=name)


class Side:
    """One side of a bit-for-bit comparison: ``render_views`` through
    ``fn``, the modes taking turns call by call; records every output and
    every gradient it sees, in order."""

    def __init__(self, fn, frozen=()):
        self.fn, self.calls = fn, 0
        self.scene = T.GaussianScene.from_numpy(**scene_arrays(C["p"]), device="cpu")
        for name in frozen:
            getattr(self.scene, name).requires_grad_(False)
        self.record = []

    def render(self, view_set):
        out = self.fn(self.scene, view_set, _options(T), MODES[self.calls % 2], None)
        self.calls += 1
        self.record += [t.detach() for t in out]
        return out

    def backward(self, *outs):
        self.scene.zero_grad(set_to_none=True)
        sum(torch.sum(out.colors_rgb_2d * WEIGHTS[i % 2]) for i, out in enumerate(outs)).backward()
        self.record += [p.grad for p in self.scene.parameters() if p.grad is not None]

    def step(self, view_set):
        self.backward(self.render(view_set))

    def update(self):
        """An in-place update of every parameter, as an optimizer makes."""
        with torch.no_grad():
            for i, p in enumerate(self.scene.parameters()):
                p.mul_(1.0 + 0.01 * (i + 1))


def two_calls_one_backward(s):
    s.backward(s.render(VIEWS_A), s.render(VIEWS_B))
    s.backward(s.render(VIEWS_B), s.render(VIEWS_A))


def reverse_order_backwards(s):
    a, b = s.render(VIEWS_A), s.render(VIEWS_B)
    s.backward(b)
    s.backward(a)


def dropped_call(s):
    s.render(VIEWS_B)  # its output dropped: nothing to keep for a backward
    s.step(VIEWS_A)


def kept_call(s):
    kept = s.render(VIEWS_B)  # an evaluation call under grad, kept
    s.step(VIEWS_A)
    s.backward(kept)


def in_place_updates(s):
    s.step(VIEWS_A)
    s.update()
    s.step(VIEWS_B)
    a = s.render(VIEWS_A)
    s.update()
    with pytest.raises(RuntimeError, match="inplace"):
        s.backward(a)
    s.step(VIEWS_B)


SEQUENCES = {
    "two_calls_one_backward": (two_calls_one_backward, (), 2),
    "reverse_order_backwards": (reverse_order_backwards, (), 1),
    "dropped_call": (dropped_call, (), 0),
    "kept_call": (kept_call, (), 1),
    "frozen_subset": (two_calls_one_backward, ("rotations", "scalings"), 2),
    "in_place_updates": (in_place_updates, (), 0),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_graphed_render_views_matches_the_eager_loop_bit_for_bit(name):
    sequence, frozen, moves = SEQUENCES[name]
    graph = _pair("render_views")
    sides = [Side(_render_views_graphed, frozen), Side(_render_views_eager, frozen)]
    for side in sides:
        side.step(VIEWS_A)  # the graphed side's warm-up ("vmap")
        side.step(VIEWS_B)  # and its capture ("map")
        sequence(side)
    assert graph.captures == 1 and graph.replays["forward"] > 1, graph.replays
    assert graph.moves == moves, graph.moves
    got, want = sides[0].record, sides[1].record
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), i


def test_parallel_render_views_graphed_matches_its_eager_form():
    graph = _pair("parallel.render_views")
    records = []
    for fn in (_views_graphed, _views_eager):
        scene = T.GaussianScene.from_numpy(**scene_arrays(C["p"]), device="cpu")
        record = []
        for view_set in (VIEWS_A, VIEWS_A, VIEWS_A, VIEWS_B):
            scene.zero_grad(set_to_none=True)
            out = fn(scene, stack_cameras(view_set, device="cpu"), C["width"], C["height"],
                     _options(T))
            torch.sum(out.colors_rgb_2d * WEIGHTS[0]).backward()
            record += [t.detach() for t in out] + [p.grad for p in scene.parameters()]
        if fn is _views_graphed:
            assert (graph.captures, graph.replays) == (1, {"forward": 3, "backward": 3})
        records.append(record)
    assert len(records[0]) == len(records[1]) == 40
    for i, (a, b) in enumerate(zip(*records)):
        assert a.shape == b.shape and torch.equal(a, b), i


def test_render_and_render_views_keep_one_pair_each():
    single, batch = _pair("render"), _pair("render_views")
    scene = T.GaussianScene.from_numpy(**scene_arrays(C["p"]), device="cpu")
    for _ in range(4):
        for call in (lambda: _render_graphed(scene, VIEWS_A[0], _options(T)),
                     lambda: _render_views_graphed(scene, VIEWS_A, _options(T))):
            scene.zero_grad(set_to_none=True)
            call().colors_rgb_2d.sum().backward()
    assert (single.captures, single.replays) == (1, {"forward": 3, "backward": 3})
    assert (batch.captures, batch.replays) == (1, {"forward": 3, "backward": 3})
