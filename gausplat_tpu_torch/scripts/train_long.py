"""Long training run on a synthetic multi-view scene, with densification;
writes the loss / PSNR / point-count curve as JSON.

The counterpart of ``scripts/train_long.py``, recipe for recipe and seed
for seed. The default toy recipe: a 500-Gaussian ground truth rendered
from 10 orbit views at 256x256, training from a fresh 150-point cloud.
``--full`` (or 20,000 iterations and more) takes the full 3DGS schedule of
the ``TrainConfig`` defaults: densify to step 15,000, opacity resets every
3,000, SH warm-up every 1,000. ``--lego`` (implies ``--full``) scales the
scene to lego class: 800x800 targets from a 4,000-Gaussian ground truth
over 16 views on two elevation rings, training from 2,000 points (meant
as true positions plus noise; see :func:`long_fit_setup`).

    python -m gausplat_tpu_torch.scripts.train_long [ITERS] [OUT.json] \\
        [--full] [--lego] [--entry-dtype f32|bf16] [--densify-interval 300] \\
        [--deadline-s 0] [--device cuda]

The loop calls ``Trainer.fit_scan`` in chunks of 200 steps, round-robin
over the views (on the card each sub-chunk between host events replays
one captured step), and after each chunk appends one record: the last step's
``step``, ``loss``, ``psnr`` and ``points`` (as the JAX script does), the
chunk's means, its wall milliseconds per step (CUDA events on the card),
its largest entry total with the capacity that step ran with, the count of
capacity growths so far, and the peak device memory so far. The file is
rewritten after every chunk, so a run cut short leaves its curve. A step
whose entries overflow their capacity (which truncates the image and the
gradients) stops the run with an error. ``--deadline-s`` stops cleanly
after that many wall seconds.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from ..render.pipeline import RenderOptions, render
from ..render.view import View
from ..scene.gaussian_3d import GaussianScene
from ..scene.point import Points
from ..train import DensifyConfig, OptimizerConfig, TrainConfig, Trainer, camera_extent
from . import ring_views

CHUNK = 200


def _orbit_view(i, n, elev, vid, size, fov):
    """Camera at distance 4 on an elevation-``elev`` ring, looking at the
    origin (world->cam rotation R, camera centre R.T @ [0, 0, -4],
    translation [0, 0, 4])."""
    a = 2 * np.pi * i / n
    c, s = np.cos(a), np.sin(a)
    rot_y = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    ce, se = np.cos(elev), np.sin(elev)
    rot_x = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])
    rot = rot_x @ rot_y  # world->cam
    pos = rot.T @ np.array([0.0, 0.0, -4.0])
    return View(
        field_of_view_x=fov, field_of_view_y=fov,
        image_height=size, image_width=size, view_id=vid,
        view_position=pos,
        view_transform=View.transform(rot.T, np.array([0.0, 0.0, 4.0])),
    )


def long_fit_setup(lego: bool, full: bool = False, device="cuda", *, iterations=None,
                   entry_dtype: str = "f32", densify_interval: int = 300) -> dict:
    """The recipe's seeded inputs on ``device``: the truth scene, the views
    and their target renders, the start cloud, the render options and the
    ``TrainConfig`` (``full`` or ``lego``: the full schedule; else densify
    until ``min(iterations - 500, 6000)``)."""
    full = full or lego
    iterations = iterations or (30_000 if full else 10_000)
    size = 800 if lego else 256
    opts = RenderOptions(
        tile_entry_capacity=1 << (18 if lego else 17),
        block_size=256,
        entry_dtype=entry_dtype,
    )
    rng = np.random.default_rng(0)

    p = 4_000 if lego else 500
    truth = GaussianScene.from_points(
        Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.7),
        device=device,
    )
    gt_scale = (0.015 + 0.04 * rng.random((p, 3))) if lego else (
        0.03 + 0.08 * rng.random((p, 3))
    )
    truth = truth.set_scalings(np.asarray(gt_scale, np.float32))
    truth = truth.set_opacities(np.asarray(0.3 + 0.6 * rng.random((p, 1)), np.float32))

    if lego:
        # 16 views: two elevation rings of 8 around the unit-box scene.
        views = []
        for i in range(8):
            views.append(_orbit_view(i, 8, 0.0, len(views), size, 0.8))
        for i in range(8):
            views.append(_orbit_view(i, 8, 0.45, len(views), size, 0.8))
    else:
        views = ring_views(10, size, size)
    with torch.no_grad():
        targets = [render(truth, v, opts).colors_rgb_2d for v in views]

    if lego:
        # Meant as an SfM-like start (a noisy 2,000-point subsample of the
        # true geometry), but ``Points`` takes the colours first: as in the
        # JAX script, whose records this run is held to, the noisy positions
        # become the colours and uniform draws in the unit box the positions.
        q = 2_000
        sel = rng.choice(p, q, replace=True)
        pos0 = truth.positions.detach().cpu().numpy()[sel] + rng.standard_normal((q, 3)) * 0.02
        start = GaussianScene.from_points(
            Points(pos0.astype(np.float32), rng.random((q, 3)).astype(np.float32)),
            device=device,
        )
    else:
        q = 150
        start = GaussianScene.from_points(
            Points(rng.random((q, 3)).astype(np.float32), rng.standard_normal((q, 3)) * 0.7),
            device=device,
        )

    if full:
        # The full 3DGS schedule; the position lr and the densify size
        # thresholds key to the camera extent (3DGS's spatial_lr_scale).
        extent = camera_extent(views)
        config = TrainConfig(
            render=opts,
            densify_from=500,
            densify_until=15_000,
            densify_interval=densify_interval,
            sh_warmup_interval=1_000,
            opacity_reset_interval=3_000,
            optimizer=OptimizerConfig(scene_extent=extent),
            densify=DensifyConfig(scene_extent=extent),
        )
    else:
        config = TrainConfig(
            render=opts,
            densify_from=500,
            densify_until=min(iterations - 500, 6000),
            densify_interval=300,
            sh_warmup_interval=500,
            opacity_reset_interval=10**9,
        )
    return dict(truth=truth, views=views, targets=targets, start=start, options=opts,
                config=config, size=size, iterations=iterations)


class CapacityTrainer(Trainer):
    """A :class:`Trainer` whose step metrics also carry ``capacity``, the
    entry capacity the step rendered with (the trainer grows it only at its
    host events, so in ``fit_scan`` it is the capacity of the step's
    sub-chunk)."""

    def _step_info(self) -> dict:
        return {"capacity": self._entry_capacity}


def card_name() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, where it is found."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    done = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 else None


def run_long_fit(setup: dict, iterations: int, out_path=None, *, deadline_s=None,
                 log=print) -> dict:
    """Fit ``setup``'s start to its targets for ``iterations`` steps in
    chunks; returns the run's record (``records``: one per chunk) and the
    trainer. Raises ``RuntimeError`` when a step's entries overflow the
    capacity it ran with (after writing the curve so far)."""
    start_scene, views, targets = setup["start"], setup["views"], setup["targets"]
    cuda = start_scene.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(start_scene.device)
    tr = CapacityTrainer(start_scene, setup["size"], setup["size"], setup["config"])
    run = dict(device=torch.cuda.get_device_name(start_scene.device) if cuda else "cpu",
               card=card_name() if cuda else None, torch=torch.__version__,
               iterations=iterations, chunk=CHUNK, records=[])
    records = run["records"]
    capacity, growths = tr._entry_capacity, 0
    t_start = time.perf_counter()

    def write():
        run["seconds"] = time.perf_counter() - t_start
        if out_path:
            with open(out_path, "w") as f:
                json.dump(run, f, indent=0)

    step = 0
    while step < iterations:
        if deadline_s and time.perf_counter() - t_start > deadline_s:
            log(f"deadline {deadline_s}s reached at step {step}; stopping")
            break
        k = min(CHUNK, iterations - step)
        if cuda:
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            hist = tr.fit_scan(views, targets, k)
            end.record()
            end.synchronize()
            ms = begin.elapsed_time(end) / k
        else:
            t0 = time.perf_counter()
            hist = tr.fit_scan(views, targets, k)
            ms = (time.perf_counter() - t0) * 1e3 / k
        step += k
        worst = max(hist, key=lambda h: h["tile_point_total"] - h["capacity"])
        for h in hist:
            if h["capacity"] != capacity:
                capacity, growths = h["capacity"], growths + 1
        peak = max(hist, key=lambda h: h["tile_point_total"])
        h = hist[-1]
        rec = {
            "step": tr.step_count,
            "loss": h["loss"],
            "psnr": h["psnr"],
            "points": tr.scene.point_count,
            "mean_loss": float(np.mean([x["loss"] for x in hist])),
            "mean_psnr": float(np.mean([x["psnr"] for x in hist])),
            "ms_per_step": ms,
            "max_total": int(peak["tile_point_total"]),
            "capacity": peak["capacity"],
            "capacity_growths": growths,
            "peak_memory_gb": torch.cuda.max_memory_allocated(start_scene.device) / 1e9
            if cuda else None,
        }
        records.append(rec)
        log(json.dumps(rec))
        write()
        if worst["tile_point_total"] > worst["capacity"]:
            raise RuntimeError(
                f"an entry total of {int(worst['tile_point_total'])} overflowed its capacity "
                f"of {worst['capacity']} in the chunk ending at step {tr.step_count}")
    run["capacity_growths"] = growths + (tr._entry_capacity != capacity)
    run["final_points"] = tr.scene.point_count
    if cuda:
        run["peak_memory_gb"] = torch.cuda.max_memory_allocated(start_scene.device) / 1e9
    write()
    log(f"done; final points: {tr.scene.point_count}, {run['seconds']:.1f} s, "
        f"capacity growths {run['capacity_growths']}, peak memory {run.get('peak_memory_gb')}")
    return dict(run=run, trainer=tr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="?")
    ap.add_argument("out", nargs="?", default="train_long.json")
    ap.add_argument("--full", action="store_true", help="the full 3DGS schedule")
    ap.add_argument("--lego", action="store_true", help="the lego-class scene (implies --full)")
    ap.add_argument("--entry-dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--densify-interval", type=int, default=300,
                    help="steps between densify events of the full schedule")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="stop after this many wall seconds (0: no deadline)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    full = args.lego or args.full or (args.iters is not None and args.iters >= 20_000)
    iterations = args.iters if args.iters is not None else (30_000 if full else 10_000)
    setup = long_fit_setup(args.lego, full, args.device, iterations=iterations,
                           entry_dtype=args.entry_dtype,
                           densify_interval=args.densify_interval)
    print("targets rendered", flush=True)
    run_long_fit(setup, iterations, args.out, deadline_s=args.deadline_s or None,
                 log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
