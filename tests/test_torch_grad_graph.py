"""The differentiable render through its graph pair
(``render/grad_graph.py``) on the CPU.

On the card a differentiable ``render`` is one forward graph replay and
its backward one backward graph replay. On a CPU device the same calls run
``GraphRenderFunction`` with every replay run eagerly: the forward's
saved tensors and outputs copied into the static ones, the backward through
the static autograd graph, and a pending call's state moved out before a
later forward overwrites it and back before its backward. Held here:

- against ``jax.grad`` of ``gausplat_tpu.render(backend="xla")``, as
  ``tests/test_torch_grad.py`` holds the eager render: the five parameter
  gradients and the densification signal of ``sum(image * G)`` after the
  warm-up and the capture, within 1e-4 scaled by each field's largest
  magnitude (2e-4 for bf16 rows, as ``tests/test_torch_bf16_render.py``),
  on SMALL and MEDIUM, tight culling on and off, a truncated capacity, f32
  and bf16 rows;
- bit for bit against ``_render_eager`` and its autograd backward, every
  output and every gradient, over sequences of calls: two forwards then one
  backward, backwards in the reverse order, a dropped forward, a frozen
  parameter subset, no ref, a fresh ref each call, an in-place parameter
  update between calls (read by the next call), and one between a forward
  and its backward (which raises on both sides).

The card's side (captures, replays, launches, the host reading nothing
back, a caller's capture staying eager) is in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gausplat_tpu as G
import gausplat_tpu_torch as T
from gausplat_tpu_torch.render.grad_graph import grad_graph
from gausplat_tpu_torch.render.pipeline import _render_eager, _render_graphed

from tests.torch_helpers import (
    MEDIUM, SMALL, assert_scaled_close, scene_arrays, scenes, views,
)

CPU = torch.device("cpu")
PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")
BF16_GRAD_ATOL = 2e-4

#: (scene, tight culling, capacity, entry rows); the f32 cases are
#: tests/test_torch_grad.py's, so the JAX programs come from its cache.
JAX_CASES = {
    "small_tight": (SMALL, True, SMALL["capacity"], "f32"),
    "small_reference_aabb": (SMALL, False, SMALL["capacity"], "f32"),
    "small_truncated": (SMALL, True, 128, "f32"),
    "medium_tight": (MEDIUM, True, None, "f32"),
    "medium_reference_aabb": (MEDIUM, False, None, "f32"),
    "small_bf16": (SMALL, True, SMALL["capacity"], "bf16"),
    "medium_bf16": (MEDIUM, True, MEDIUM["capacity"], "bf16"),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_graphed_render_grads_match_jax(case):
    c, tight, capacity, rows = JAX_CASES[case]
    arrays = scene_arrays(c["p"])
    jscene, tscene = scenes(arrays)
    jview, tview = views(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    weight = np.random.default_rng(5).standard_normal(
        (c["height"], c["width"], 3)).astype(np.float32)
    kw = dict(tile_entry_capacity=capacity, block_size=c["block"], tight_culling=tight)
    if rows == "bf16":
        kw["entry_dtype"] = "bf16"
    p = c["p"]

    def jloss(scene, ref):
        out = G.render(scene, jview, G.RenderOptions(backend="xla", **kw), ref)
        return jnp.sum(out.colors_rgb_2d * weight)

    jgrads, jnorm = jax.grad(jloss, argnums=(0, 1))(jscene, jnp.zeros((p,), jnp.float32))
    want = {name: np.asarray(getattr(jgrads, name)) for name in PARAMS}
    want["norm"] = np.asarray(jnorm)

    graph = grad_graph("render", CPU)
    graph.release()
    options = T.RenderOptions(**kw)
    for call in range(3):  # the warm-up, the capture, a replay
        tscene.zero_grad(set_to_none=True)
        ref = torch.zeros(p, requires_grad=True)
        out = _render_graphed(tscene, tview, options, ref)
        torch.sum(out.colors_rgb_2d * torch.as_tensor(weight)).backward()
    assert (graph.captures, graph.replays) == (1, {"forward": 2, "backward": 2})
    if case.endswith("truncated"):
        assert int(out.tile_point_total) > capacity
    got = {name: getattr(tscene, name).grad.numpy() for name in PARAMS}
    got["norm"] = ref.grad.numpy()
    atol = BF16_GRAD_ATOL if rows == "bf16" else 1e-4
    for name in want:
        assert np.isfinite(got[name]).all(), name
        assert np.abs(want[name]).max() > 0, name
        assert_scaled_close(got[name], want[name], err_msg=name, atol=atol)


C = SMALL
OPTIONS = T.RenderOptions(tile_entry_capacity=C["capacity"], block_size=C["block"])
_, VIEW_A = views(C["width"], C["height"], position=(0.3, -0.2, -4.0))
_, VIEW_B = views(C["width"], C["height"], position=(-0.4, 0.1, -4.0))
WEIGHTS = [torch.as_tensor(np.random.default_rng(seed).standard_normal(
    (C["height"], C["width"], 3)).astype(np.float32)) for seed in (5, 6)]


class Side:
    """One side of a bit-for-bit comparison: renders through ``fn`` and
    records every output and every gradient it sees, in order."""

    def __init__(self, fn, frozen=()):
        self.fn = fn
        self.scene = T.GaussianScene.from_numpy(**scene_arrays(C["p"]), device="cpu")
        for name in frozen:
            getattr(self.scene, name).requires_grad_(False)
        self.record = []

    def render(self, view, ref="fresh"):
        if ref == "fresh":
            ref = torch.zeros(C["p"], requires_grad=True)
        out = self.fn(self.scene, view, OPTIONS, ref)
        self.record += [t.detach() for t in out]
        return out, ref

    def backward(self, *pairs):
        """``loss = sum(image_i * W_i)`` over ``(out, ref)`` pairs, then its
        backward; records the parameters' and the refs' gradients."""
        self.scene.zero_grad(set_to_none=True)
        loss = sum(torch.sum(out.colors_rgb_2d * WEIGHTS[i % 2])
                   for i, (out, _) in enumerate(pairs))
        loss.backward()
        self.record += [p.grad for p in self.scene.parameters() if p.grad is not None]
        self.record += [ref.grad for _, ref in pairs if ref is not None]

    def step(self, view, ref="fresh"):
        self.backward(self.render(view, ref))

    def update(self):
        """An in-place update of every parameter, as an optimizer makes."""
        with torch.no_grad():
            for i, p in enumerate(self.scene.parameters()):
                p.mul_(1.0 + 0.01 * (i + 1))


def two_forwards_one_backward(s):
    s.backward(s.render(VIEW_A), s.render(VIEW_B))
    s.backward(s.render(VIEW_B), s.render(VIEW_A))


def reverse_order_backwards(s):
    a, b = s.render(VIEW_A), s.render(VIEW_B)
    s.backward(b)
    s.backward(a)
    a, b, c = s.render(VIEW_B), s.render(VIEW_A), s.render(VIEW_B)
    s.backward(c)
    s.backward(a)
    s.backward(b)


def dropped_forward(s):
    s.render(VIEW_B)  # its output dropped: nothing to keep for a backward
    s.step(VIEW_A)
    s.step(VIEW_B)


def kept_forward(s):
    kept = s.render(VIEW_B)  # an evaluation render under grad, kept
    s.step(VIEW_A)
    s.backward(kept)


def no_ref(s):
    s.step(VIEW_A, ref=None)
    s.step(VIEW_B, ref=None)
    s.backward(s.render(VIEW_A, ref=None), s.render(VIEW_B, ref=None))


def one_ref_for_every_call(s):
    ref = torch.zeros(C["p"], requires_grad=True)
    for view in (VIEW_A, VIEW_B, VIEW_A):
        ref.grad = None
        s.step(view, ref=ref)


def in_place_between_calls(s):
    for view in (VIEW_A, VIEW_B, VIEW_A):
        s.step(view)
        s.update()
    a = s.render(VIEW_A)
    s.update()
    with pytest.raises(RuntimeError, match="inplace"):
        s.backward(a)
    s.step(VIEW_B)


SEQUENCES = {
    "two_forwards_one_backward": (two_forwards_one_backward, ()),
    "reverse_order_backwards": (reverse_order_backwards, ()),
    "dropped_forward": (dropped_forward, ()),
    "kept_forward": (kept_forward, ()),
    "frozen_subset": (two_forwards_one_backward, ("rotations", "scalings")),
    "no_ref": (no_ref, ()),
    "one_ref_for_every_call": (one_ref_for_every_call, ()),
    "in_place_between_calls": (in_place_between_calls, ()),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_graphed_render_matches_the_eager_render_bit_for_bit(name):
    sequence, frozen = SEQUENCES[name]
    graph = grad_graph("render", CPU)
    graph.release()
    sides = [Side(_render_graphed, frozen), Side(_render_eager, frozen)]
    for side in sides:
        ref = None if name == "no_ref" else "fresh"
        side.step(VIEW_A, ref)  # the graphed side's warm-up
        side.step(VIEW_B, ref)  # and its capture
        sequence(side)
    assert graph.captures == 1 and graph.replays["forward"] > 1
    got, want = sides[0].record, sides[1].record
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), i
    # A call's state moves out only while its backward may still come.
    moves = {"two_forwards_one_backward": 2, "frozen_subset": 2, "no_ref": 1,
             "reverse_order_backwards": 3, "kept_forward": 1}
    assert graph.moves == moves.get(name, 0), graph.moves
