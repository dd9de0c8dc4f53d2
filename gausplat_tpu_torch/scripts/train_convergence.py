"""Training-convergence run: fit the toy scene of ``train_long`` over its
10 views with densification and print five points of the curve.

The counterpart of ``scripts/train_convergence.py``, seed for seed. The
scene, views, targets and start cloud are
:func:`~gausplat_tpu_torch.scripts.train_long.long_fit_setup`'s toy recipe
(a 500-Gaussian ground truth at 256x256, a fresh 150-point start); the
schedule is this script's own: densify every 150 steps from step 300 to
``iters - 300``, SH warm-up every 300 steps, no opacity reset, and the
``OptimizerConfig`` / ``DensifyConfig`` defaults (``scene_extent`` 1.0).

    python -m gausplat_tpu_torch.scripts.train_convergence [ITERS] [--device cuda]

ITERS is 1,500 by default. The run is on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..train import TrainConfig, Trainer
from . import path_launches
from .train_long import long_fit_setup


def convergence_config(options, iters: int) -> TrainConfig:
    """The script's schedule over ``iters`` steps, rendering with ``options``."""
    return TrainConfig(render=options, densify_from=300, densify_until=iters - 300,
                       densify_interval=150, sh_warmup_interval=300,
                       opacity_reset_interval=10**9)


def convergence_setup(iters: int = 1500, device="cuda") -> dict:
    """``long_fit_setup(lego=False)``'s seeded inputs on ``device`` with this
    script's ``TrainConfig`` in place of that recipe's."""
    setup = long_fit_setup(lego=False, device=device, iterations=iters)
    return {**setup, "config": convergence_config(setup["options"], iters)}


def curve_steps(iters: int) -> tuple:
    """The five steps (0-based) whose metrics the script prints."""
    return (0, iters // 4, iters // 2, 3 * iters // 4, iters - 1)


def train_convergence(iters: int = 1500, device="cuda", log=print) -> dict:
    """Fit for ``iters`` steps with ``Trainer.fit`` and log the JAX script's
    lines. Returns ``history`` (one dict of host floats per step; densify
    steps also carry ``point_count``), ``curve`` (the five printed points),
    ``points_start`` / ``points_end``, the fit's wall ``fit_seconds``, the
    ``launches`` of kernels A, B and C during the fit (not the set-up's
    target renders), the ``trainer`` and its ``views``."""
    setup = convergence_setup(iters, device)
    size = setup["size"]
    trainer = Trainer(setup["start"], size, size, setup["config"])
    points_start = trainer.scene.point_count
    before = path_launches()
    start = time.perf_counter()
    history = trainer.fit(setup["views"], setup["targets"], iters)  # reads the device at its end
    fit_seconds = time.perf_counter() - start
    launches = {k: n - before[k] for k, n in path_launches().items()}
    curve = []
    for k in curve_steps(iters):
        h = history[k]
        curve.append(dict(step=k + 1, loss=h["loss"], psnr=h["psnr"],
                          point_count=h.get("point_count")))
        log(f"step {k + 1:5d}: loss={h['loss']:.4f} psnr={h['psnr']:.2f} dB "
            f"pts={h.get('point_count', '')}")
    log(f"final points: {trainer.scene.point_count}")
    return dict(history=history, curve=curve, points_start=points_start,
                points_end=trainer.scene.point_count, fit_seconds=fit_seconds,
                launches=launches, trainer=trainer, views=setup["views"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="?", default=1500)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    train_convergence(args.iters, args.device, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
