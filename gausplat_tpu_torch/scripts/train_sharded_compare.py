"""Sharded against single-device training parity at scale: the same batched
fit with the (data x tiles) sharded step on 8 ranks of ``torch.distributed``
and with the single-device batch step; the final PSNRs must agree within
0.5 dB.

The counterpart of ``scripts/train_sharded_compare.py``, seed for seed: a
300-Gaussian truth from ``default_rng(0)`` rendered from 4 orbit views at
128x128, training from a 120-point start from ``default_rng(7)``, with no
densification (the two trainers advance ``step_count`` by 4 and by 1 a
call, so their event schedules would differ), SH warm-up every step and no
opacity reset. The single-device side runs ``Trainer.train_step_batch``
``ITERS`` times in this process; the sharded side runs ``ShardedTrainer``
on a (2, 4) mesh of ``("data", "tiles")`` in 8 spawned ranks over gloo (on
one card the ranks share it: NCCL refuses two ranks on one GPU). Each
side's PSNR is the mean over the views of a single-device render of its
final scene.

    python -m gausplat_tpu_torch.scripts.train_sharded_compare [ITERS] [--device cuda]

ITERS is 600 by default. Both sides run on the card unless ``--device
cpu`` is given. Prints three JSON lines, ``single_batched_psnr``,
``sharded_psnr`` and ``delta_db``, and exits non-zero when ``delta_db``
is above 0.5.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..render.pipeline import RenderOptions, render
from ..scene.gaussian_3d import GaussianScene
from ..scene.point import Points
from ..train import TrainConfig, Trainer
from ..train.losses import psnr
from ..train.optimizer import FIELDS
from . import build_path_kernels, path_launches, rank_device, ring_views

SIZE = 128
#: The mesh of the sharded side, and its ranks.
MESH = (2, 4)
RANKS = MESH[0] * MESH[1]
#: The JAX script's claim on the final PSNRs.
MAX_DELTA_DB = 0.5
OPTIONS = RenderOptions(tile_entry_capacity=1 << 16, block_size=128)
#: No densification, SH warm-up every step (both trainers reach degree 3
#: within three steps), no opacity reset.
CONFIG = TrainConfig(render=OPTIONS, densify_from=10**9, sh_warmup_interval=1,
                     opacity_reset_interval=10**9)


def compare_views() -> list:
    return ring_views(4, SIZE, SIZE)


def compare_truth(device) -> GaussianScene:
    rng = np.random.default_rng(0)
    p = 300
    truth = GaussianScene.from_points(
        Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.7),
        device=device)
    truth = truth.set_scalings(np.asarray(0.04 + 0.1 * rng.random((p, 3)), np.float32))
    return truth.set_opacities(np.asarray(0.3 + 0.6 * rng.random((p, 1)), np.float32))


def fresh(device) -> GaussianScene:
    """The start cloud both sides train from."""
    r = np.random.default_rng(7)
    q = 120
    return GaussianScene.from_points(
        Points(r.random((q, 3)).astype(np.float32), r.standard_normal((q, 3)) * 0.7),
        device=device)


def compare_targets(views, device) -> list:
    """The truth's renders of ``views``, as ``[H, W, 3]`` tensors on ``device``."""
    truth = compare_truth(device)
    with torch.no_grad():
        return [render(truth, v, OPTIONS).colors_rgb_2d for v in views]


def eval_psnr(scene, views, targets) -> float:
    """Mean PSNR over the views of single-device renders of ``scene``."""
    with torch.no_grad():
        vals = [float(psnr(render(scene, v, OPTIONS).colors_rgb_2d, t))
                for v, t in zip(views, targets)]
    return sum(vals) / len(vals)


def scene_arrays(scene) -> dict:
    return {f: getattr(scene, f).detach().cpu().numpy() for f in FIELDS}


def _fit(step, side, iters, log) -> dict:
    """``iters`` calls of ``step``: their ``losses`` (read once at the end),
    the kernels' ``launches`` and the wall ``seconds``."""
    before = path_launches()
    start = time.perf_counter()
    losses = []
    for i in range(iters):
        losses.append(step()["loss"])
        if (i + 1) % 50 == 0:
            log(f"{side} {i + 1}/{iters}")
    losses = [float(x) for x in losses]
    return dict(losses=losses, launches={k: n - before[k] for k, n in path_launches().items()},
                seconds=time.perf_counter() - start)


def run_single(iters: int, device, log=print) -> dict:
    """The single-device side: ``iters`` batch steps over the 4 views.
    Returns ``psnr``, ``points``, the step ``losses``, the final ``scene``
    arrays, the ``launches`` of kernels A, B and C over the steps and the
    steps' wall ``seconds``."""
    views = compare_views()
    targets = compare_targets(views, device)
    trainer = Trainer(fresh(device), SIZE, SIZE, CONFIG)
    return dict(_fit(lambda: trainer.train_step_batch(views, targets), "single", iters, log),
                psnr=eval_psnr(trainer.scene, views, targets), points=trainer.scene.point_count,
                scene=scene_arrays(trainer.scene))


def sharded_rank(rank: int, iters: int, device, log=print) -> dict:
    """The sharded side, run by every rank of an initialised default
    process group of at least 8 ranks: ``ShardedTrainer`` on the (2, 4)
    mesh for ``iters`` steps. Returns what :func:`run_single` returns (the
    launches and seconds this rank's, the rest the same on every rank) and
    this rank's ``slab``, its index on the tiles axis."""
    from ..parallel import make_mesh, stack_cameras
    from ..parallel.train_step import ShardedTrainer

    views = compare_views()
    targets = compare_targets(views, device)
    mesh = make_mesh(MESH, ("data", "tiles"))
    trainer = ShardedTrainer(fresh(device), mesh, SIZE, SIZE, CONFIG)
    padded = trainer.pad_targets(torch.stack(targets))
    cams = stack_cameras(views, device=device)
    return dict(_fit(lambda: trainer.train_step(cams, padded), "sharded", iters,
                     log if rank == 0 else (lambda line: None)),
                psnr=eval_psnr(trainer.scene, views, targets), points=trainer.scene.point_count,
                scene=scene_arrays(trainer.scene), slab=mesh.coords["tiles"])


def sharded_worker(rank: int, out_dir: str, iters: int, device: str) -> None:
    """A spawned rank: :func:`sharded_rank`; every rank writes
    ``out_dir/rank{rank}.json`` (its launches, seconds and slab), rank 0 also
    ``out_dir/sharded.npz``."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    result = sharded_rank(rank, iters, rank_device(device),
                          log=lambda line: print(line, flush=True))
    out_dir = pathlib.Path(out_dir)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(
        {k: result[k] for k in ("launches", "seconds", "slab")}))
    if rank == 0:
        np.savez(out_dir / "sharded.npz", psnr=result["psnr"], points=result["points"],
                 losses=np.asarray(result["losses"]),
                 **{f"scene/{k}": v for k, v in result["scene"].items()})


def run_sharded(iters: int, device) -> dict:
    """The sharded side in 8 spawned gloo ranks on ``device``: what
    :func:`run_single` returns, with the launches summed over the ranks and
    over the ranks of each slab (``slab_launches``), and each rank's
    ``rank_seconds``."""
    from ..testing import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="gausplat_sharded_compare_") as tmp:
        tmp = pathlib.Path(tmp)
        spawn_ranks(sharded_worker, RANKS, str(tmp), iters, str(device), backend="gloo")
        got = dict(np.load(tmp / "sharded.npz"))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(RANKS)]
    def total(of):
        return {k: sum(r["launches"][k] for r in of) for k in ranks[0]["launches"]}

    return dict(psnr=float(got["psnr"]), points=int(got["points"]),
                losses=got["losses"].tolist(), scene={f: got[f"scene/{f}"] for f in FIELDS},
                launches=total(ranks),
                slab_launches=[total([r for r in ranks if r["slab"] == i])
                               for i in range(MESH[1])],
                rank_seconds=[r["seconds"] for r in ranks])


def compare(iters: int = 600, device="cuda", log=print) -> dict:
    """Both sides; logs the JAX script's three JSON lines and returns
    ``single``, ``sharded`` (each as :func:`run_single` returns it) and
    ``delta_db``."""
    device = rank_device(device)
    if device.type == "cuda":
        build_path_kernels()
    single = run_single(iters, device, log)
    log(json.dumps({"single_batched_psnr": single["psnr"], "points": single["points"]}))
    sharded = run_sharded(iters, device)
    log(json.dumps({"sharded_psnr": sharded["psnr"], "points": sharded["points"]}))
    delta = abs(single["psnr"] - sharded["psnr"])
    log(json.dumps({"delta_db": delta}))
    return dict(single=single, sharded=sharded, delta_db=delta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="?", default=600)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    result = compare(args.iters, args.device, log=lambda line: print(line, flush=True))
    return 0 if result["delta_db"] <= MAX_DELTA_DB else 1


if __name__ == "__main__":
    sys.exit(main())
