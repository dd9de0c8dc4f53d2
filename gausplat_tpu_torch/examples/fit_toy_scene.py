"""End-to-end demo: fit a toy 3DGS scene to target renders, then export.

The counterpart of ``examples/fit_toy_scene.py``: create a ground-truth
scene, render target views, initialise a fresh scene from a noisy point
cloud, train it (with densification enabled), and round-trip the result
through the 3DGS PLY codec (native where a host compiler is found). It
runs on the CUDA card unless asked for the CPU:

    python -m gausplat_tpu_torch.examples.fit_toy_scene [ITERATIONS] [DEVICE]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..render.pipeline import RenderOptions, render
from ..render.view import View
from ..scene.gaussian_3d import GaussianScene
from ..scene.ply import decode_polygon, encode_polygon
from ..scene.point import Points
from ..train import TrainConfig, Trainer, camera_extent, psnr

SIZE = 128


def make_views(n, size=SIZE):
    """``n`` cameras on a ring of radius 4 around the origin, looking at it."""
    views = []
    for i in range(n):
        angle = 2 * np.pi * i / n
        c, s = np.cos(angle), np.sin(angle)
        # Look-at-origin world->view rotation (rows: right, up, forward).
        rotation = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        position = np.array([4 * s, 0.0, -4 * c])
        views.append(
            View(
                field_of_view_x=1.0,
                field_of_view_y=1.0,
                image_height=size,
                image_width=size,
                view_id=i,
                view_position=position,
                view_transform=View.transform(rotation.T, -rotation @ position),
            )
        )
    return views


def toy_setup(iterations: int = 400, *, device="cuda") -> dict:
    """The example's seeded inputs on ``device``: the 120-point truth, its 6
    views at 128x128 and their target renders, the 60-point start and the
    ``TrainConfig`` (densify from step 100 to ``iterations - 100``)."""
    rng = np.random.default_rng(0)
    opts = RenderOptions(tile_entry_capacity=1 << 15, block_size=128)

    # Ground truth: 120 colorful Gaussians in a ball.
    p = 120
    truth = GaussianScene.from_points(
        Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.6),
        device=device,
    )
    truth = truth.set_scalings(np.asarray(0.05 + 0.1 * rng.random((p, 3)), np.float32))
    truth = truth.set_opacities(np.asarray(0.3 + 0.6 * rng.random((p, 1)), np.float32))

    views = make_views(6, SIZE)
    with torch.no_grad():
        targets = [render(truth, v, opts).colors_rgb_2d for v in views]

    # Start from a noisy sparse cloud.
    q = 60
    start = GaussianScene.from_points(
        Points(rng.random((q, 3)).astype(np.float32), rng.standard_normal((q, 3)) * 0.6),
        device=device,
    )

    config = TrainConfig(
        render=opts,
        densify_from=100,
        densify_until=max(iterations - 100, 101),
        densify_interval=100,
        sh_warmup_interval=100,
        opacity_reset_interval=10**9,
    )
    # The densify size thresholds and the position lr both key to the
    # camera extent (standard 3DGS spatial_lr_scale).
    extent = camera_extent(views)
    config = dataclasses.replace(
        config,
        densify=dataclasses.replace(config.densify, scene_extent=extent),
        optimizer=dataclasses.replace(config.optimizer, scene_extent=extent),
    )
    return dict(truth=truth, views=views, targets=targets, start=start, config=config)


def fit_toy_scene(iterations: int = 400, *, device="cuda", log=print) -> dict:
    """Fit the toy scene on ``device`` and round-trip it through the PLY
    codec. Returns the first and last history entries, every step's loss,
    the point counts, the PLY size, the round trip's PSNR against target 0,
    and whether the decoded scene equals the fitted one (arrays and view
    0's render bit for bit)."""
    setup = toy_setup(iterations, device=device)
    views, targets, start = setup["views"], setup["targets"], setup["start"]
    opts = setup["config"].render
    trainer = Trainer(start, SIZE, SIZE, setup["config"])

    history = trainer.fit(views, targets, iterations)
    first, last = history[0], history[-1]
    log(f"step 1:   loss={first['loss']:.4f} psnr={first['psnr']:.2f} dB "
        f"points={start.point_count}")
    log(f"step {len(history)}: loss={last['loss']:.4f} psnr={last['psnr']:.2f} dB "
        f"points={trainer.scene.point_count}")

    # Checkpoint round trip through the 3DGS PLY format.
    blob = encode_polygon(trainer.scene)
    restored = decode_polygon(blob, device=device)
    with torch.no_grad():
        check = render(restored, views[0], opts).colors_rgb_2d
        fitted = render(trainer.scene, views[0], opts).colors_rgb_2d
    round_trip_psnr = float(psnr(check, targets[0]))
    log(f"PLY round trip: {len(blob)} bytes, psnr vs target {round_trip_psnr:.2f} dB")
    identical = torch.equal(check, fitted) and all(
        torch.equal(getattr(restored, f), getattr(trainer.scene, f))
        for f in ("colors_sh", "opacities", "positions", "rotations", "scalings"))
    return dict(
        first=first, last=last, losses=[h["loss"] for h in history],
        points_start=start.point_count, points_end=trainer.scene.point_count,
        ply_bytes=len(blob), round_trip_psnr=round_trip_psnr, round_trip_identical=identical,
    )


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    fit_toy_scene(int(argv[0]) if argv else 400,
                  device=argv[1] if len(argv) > 1 else "cuda")


if __name__ == "__main__":
    main()
