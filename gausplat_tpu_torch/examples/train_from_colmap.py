"""Train a 3DGS scene from a COLMAP sparse reconstruction.

The counterpart of ``examples/train_from_colmap.py``: load a COLMAP sparse
model, initialise a Gaussian scene from the SfM points, fit it to the
captured images with packed bf16 entry rows
(``RenderOptions(entry_dtype="bf16")``), export a .3dgs.ply. It runs on the
CUDA card unless asked for the CPU:

    python -m gausplat_tpu_torch.examples.train_from_colmap SPARSE_DIR IMAGE_DIR [OUT.ply] [ITERS] [DEVICE]

``SPARSE_DIR`` holds cameras.bin / images.bin / points3D.bin; ``IMAGE_DIR``
the registered images (file names from images.bin), read with PIL (needed
only here). Images larger than 1600 px are downscaled as standard 3DGS
training does. The fit is ``Trainer.fit_scan``, round-robin over the
views, as in the JAX example: on the card each run of steps between host
events replays one captured step.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..render.pipeline import RenderOptions
from ..scene.colmap import load_sparse_model
from ..scene.gaussian_3d import GaussianScene
from ..scene.ply import encode_polygon
from ..train import TrainConfig, Trainer, camera_extent

#: Longest image side the fit uses.
MAX_SIZE = 1600


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """An RGB image as float32 ``[height, width, 3]`` in [0, 1]."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(
            "reading captured images needs PIL (pillow); install it or adapt "
            "load_image to your codec"
        ) from e
    img = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(img, np.float32) / 255.0


def train_from_colmap(
    sparse_dir: str,
    image_dir: str,
    out_path: str = "scene.3dgs.ply",
    iterations: int = 7_000,
    *,
    device="cuda",
    log=print,
) -> list:
    """Load, initialise, fit on ``device`` and export; returns the fit's
    metric history (one dict per step)."""
    names: dict = {}
    points, views_map = load_sparse_model(sparse_dir, names)
    log(f"{len(points)} SfM points, {len(views_map)} registered views")

    views, targets = [], []
    for vid, view in sorted(views_map.items()):
        if view.image_width > MAX_SIZE:
            view = view.resize_max(MAX_SIZE)
        image = load_image(os.path.join(image_dir, names[vid]), view.image_width,
                           view.image_height)
        views.append(view)
        targets.append(torch.as_tensor(image, device=device))

    scene = GaussianScene.from_points(points, device=device)
    extent = camera_extent(views)
    cfg = TrainConfig(iterations=iterations, render=RenderOptions(entry_dtype="bf16"))
    # Both extent consumers: the densify size thresholds and the position
    # learning rate (the standard recipe's spatial_lr_scale).
    cfg = dataclasses.replace(
        cfg,
        densify=dataclasses.replace(cfg.densify, scene_extent=extent),
        optimizer=dataclasses.replace(cfg.optimizer, scene_extent=extent),
    )
    trainer = Trainer(scene, views[0].image_width, views[0].image_height, cfg)
    history = trainer.fit_scan(views, targets, iterations)
    log(f"final loss {history[-1]['loss']:.4f}, psnr {history[-1]['psnr']:.2f} dB, "
        f"{trainer.scene.point_count} Gaussians")

    with open(out_path, "wb") as fh:
        fh.write(encode_polygon(trainer.scene))
    log(f"wrote {out_path}")
    return history


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    train_from_colmap(
        argv[0], argv[1],
        argv[2] if len(argv) > 2 else "scene.3dgs.ply",
        int(argv[3]) if len(argv) > 3 else 7_000,
        device=argv[4] if len(argv) > 4 else "cuda",
    )


if __name__ == "__main__":
    main()
