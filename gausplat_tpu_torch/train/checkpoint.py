"""Checkpoint / resume of the full training state.

Counterpart of ``gausplat_tpu/train/checkpoint.py``, with ``torch.save`` in
place of orbax: the scene's five parameters, the optimizer state and the
step, all as CPU tensors, loaded with ``torch.load(weights_only=True)``.
The scene alone also round-trips through the PLY codec
(:mod:`gausplat_tpu_torch.scene.ply`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..scene.gaussian_3d import PARAM_DIMS, GaussianScene


def _leaves(tree, path=()):
    """``(path, leaf)`` of a nest of dicts (keys in sorted order, as JAX
    flattens them), tuples and lists."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (str(i),))
    else:
        yield path, tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {key: _map(value, fn) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(value, fn) for value in tree)
    return fn(tree)


def save_training_state(
    path: str,
    scene: GaussianScene,
    opt_state: Any = None,
    step: int = 0,
) -> None:
    """Save the scene (and the optimizer state, if given) with torch.save."""
    payload = {
        "scene": {name: getattr(scene, name).detach().cpu() for name in PARAM_DIMS},
        "step": int(step),
    }
    if opt_state is not None:
        payload["opt_state"] = _map(opt_state, lambda t: t.detach().cpu())
    torch.save(payload, path)


def load_training_state(
    path: str,
    opt_state_template: Any = None,
    *,
    device,
) -> tuple[GaussianScene, Optional[Any], int]:
    """Load ``(scene, opt_state, step)`` saved by :func:`save_training_state`
    onto ``device``.

    With ``opt_state_template`` (e.g. ``make_optimizer(...).init(scene)``)
    the optimizer state is checked against it: every leaf's path (names and
    order) and shape must match, so a changed optimizer layout fails
    loudly instead of scrambling the moments.
    """
    payload = torch.load(path, map_location=device, weights_only=True)
    scene = GaussianScene(**payload["scene"])
    opt_state = payload.get("opt_state")
    if opt_state is not None and opt_state_template is not None:
        got = list(_leaves(opt_state))
        want = list(_leaves(opt_state_template))
        got_paths = [p for p, _ in got]
        want_paths = [p for p, _ in want]
        if got_paths != want_paths:
            mismatch = next(
                (a, b) for a, b in zip(got_paths + [None], want_paths + [None]) if a != b
            )
            raise ValueError(
                "checkpointed optimizer state does not match the template "
                f"structure; first mismatch: {mismatch}"
            )
        for (path_, leaf), (_, wleaf) in zip(got, want):
            if tuple(leaf.shape) != tuple(wleaf.shape):
                raise ValueError(
                    f"optimizer-state leaf {'/'.join(path_)} shape "
                    f"{tuple(leaf.shape)} != template {tuple(wleaf.shape)}"
                )
    return scene, opt_state, int(payload["step"])
