"""Mesh-scaling sweep: sharded-train parity at 8, 16 and 32 ranks.

The counterpart of ``scripts/mesh_scale.py``. For each rank count n it
spawns n ranks of ``torch.distributed`` (gloo; on one card they share it)
on a (data=2, tiles=n/2) mesh and runs:

1. one ``make_sharded_train_step`` step against the single-device loss
   over both views (with the densification ref) and one Adam update, at an
   image height of (n/2 + 1) tile rows, so that the rows do not split
   evenly over the slabs: the last slabs lie wholly in the padding, and the
   SSIM halo crosses them. Held to the JAX script's tolerances: the loss
   within rtol 2e-4, the five updated parameters within 2e-5, and the
   densification signal within 5e-5 scaled by its largest value;
2. :func:`dryrun_toy`, the toy mode of the JAX package's multichip dry run
   at n: one sharded step on the 128-point toy scene, whose loss must be
   finite and whose entry total must be above 0.

Each n's sharded loss is printed beside the JAX record's single-device
``loss_ref`` (``MESH_SCALE_r05.json``, read as data) and held to it within
1e-5 relative on the CPU and 2e-4 on the card. A rank that fails ends the
sweep with an error.

    python -m gausplat_tpu_torch.scripts.mesh_scale [OUT.json] [--device cuda]

The ranks run on the card unless ``--device cpu`` is given; the kernels
are built once in this process before any rank starts.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..render.pipeline import RenderOptions, render
from ..render.view import View
from ..scene.gaussian_3d import GaussianScene
from ..scene.point import Points
from ..train.losses import photometric_loss
from ..train.optimizer import FIELDS
from . import build_path_kernels, path_launches, rank_device, ring_views, zero_launches

#: The JAX package's record of the same sweep (read as data).
RECORD = pathlib.Path(__file__).resolve().parents[2] / "MESH_SCALE_r05.json"
SWEEP = (8, 16, 32)
#: The JAX script's parity tolerances.
LOSS_RTOL, PARAM_ATOL, GRAD_NORM_SCALED_ATOL = 2e-4, 2e-5, 5e-5
#: The sharded loss against the record's single-device loss, by device type.
RECORD_RTOL = {"cpu": 1e-5, "cuda": 2e-4}
SSIM_WEIGHT = 0.2  # the halo exchange crosses the slab boundaries
WIDTH = 64
D_DATA = 2


def parity_height(n: int) -> int:
    """(n/2 + 1) tile rows: an uneven split over the n/2 slabs."""
    return (n // D_DATA + 1) * 16


PARITY_OPTIONS = RenderOptions(tile_entry_capacity=8192, block_size=64)


def parity_scene(device) -> GaussianScene:
    """60 points from ``default_rng(3)``."""
    rng = np.random.default_rng(3)
    p = 60
    scene = GaussianScene.from_points(
        Points(rng.random((p, 3)).astype(np.float32), rng.standard_normal((p, 3)) * 0.6),
        device=device)
    scene = scene.set_scalings(np.asarray(0.05 + 0.1 * rng.random((p, 3)), np.float32))
    return scene.set_opacities(np.asarray(0.3 + 0.5 * rng.random((p, 1)), np.float32))


def parity_views(height: int) -> list:
    return ring_views(2, WIDTH, height, fov_y=2.0, angle_step=0.2)


def parity_inputs(n: int, device) -> tuple:
    """The parity check's seeded scene, its two views and their targets
    ``[2, H, W, 3]``: the scene's own renders times 0.5."""
    scene = parity_scene(device)
    views = parity_views(parity_height(n))
    with torch.no_grad():
        targets = torch.stack([render(scene, v, PARITY_OPTIONS).colors_rgb_2d * 0.5
                               for v in views])
    return scene, views, targets


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def single_reference(n: int, device, optimizer) -> dict:
    """The single-device side of the parity check: the mean photometric
    loss over both views, its gradients (with the densification ref's),
    and the scene after one Adam update from a fresh state."""
    scene, views, targets = parity_inputs(n, device)
    ref = torch.zeros((scene.point_count,), dtype=torch.float32, device=device,
                      requires_grad=True)
    loss = sum(photometric_loss(render(scene, v, PARITY_OPTIONS, ref).colors_rgb_2d, t,
                                SSIM_WEIGHT)
               for v, t in zip(views, targets)) / len(views)
    params = [getattr(scene, f) for f in FIELDS]
    *grads, grad_norm = torch.autograd.grad(loss, params + [ref])
    updates, _ = optimizer.update(dict(zip(FIELDS, grads)), optimizer.init(scene))
    return dict(loss=float(loss.detach()), grad_norm=_numpy(grad_norm),
                scene={f: _numpy(p.detach() + updates[f]) for f, p in zip(FIELDS, params)})


def parity_errors(sharded: dict, reference: dict) -> dict:
    """The sharded step against the single-device reference, in the units of
    the tolerances: the loss's relative error, each parameter's largest
    absolute error, and the densification signal's largest error scaled by
    the reference's largest value."""
    scale = max(float(reference["grad_norm"].max()), 1e-12)
    errors = {"loss_rel": abs(sharded["loss"] - reference["loss"]) / abs(reference["loss"]),
              "grad_norm_scaled": float(np.abs(sharded["grad_norm_sum"] - reference["grad_norm"]
                                               ).max()) / scale}
    for f in FIELDS:
        errors[f] = float(np.abs(sharded["scene"][f] - reference["scene"][f]).max())
    return errors


def parity_within(errors: dict) -> bool:
    return (errors["loss_rel"] <= LOSS_RTOL
            and errors["grad_norm_scaled"] <= GRAD_NORM_SCALED_ATOL
            and all(errors[f] <= PARAM_ATOL for f in FIELDS))


def parity_rank(rank: int, n: int, device) -> dict:
    """Part 1 at n, run by every rank of an initialised default process group
    of at least n ranks: the sharded step on the (2, n/2) mesh from the
    seeded scene and a fresh Adam state. Returns ``loss``,
    ``tile_point_total``, the updated ``scene`` arrays, ``grad_norm_sum``
    and ``h_pad`` (the same on every rank), and this rank's ``slab``
    ``(y0, rows)``, ``pad_slab`` (whether the slab lies wholly below the
    image) and the step's ``launches``. Rank 0 also computes
    :func:`single_reference` and returns ``loss_ref`` and ``errors``, and
    raises ``AssertionError`` beyond the tolerances."""
    from ..parallel import make_mesh, stack_cameras
    from ..parallel.train_step import make_sharded_train_step
    from ..train.densify import zero_densify_acc

    d_tiles = n // D_DATA
    height = parity_height(n)
    scene, views, targets = parity_inputs(n, device)
    mesh = make_mesh((D_DATA, d_tiles), ("data", "tiles"))
    step, optimizer, h_pad = make_sharded_train_step(mesh, WIDTH, height, scene.point_count,
                                                     PARITY_OPTIONS, ssim_weight=SSIM_WEIGHT)
    # The pad rows' targets are poison that the step must mask.
    padded = torch.nn.functional.pad(targets, (0, 0, 0, 0, 0, h_pad - height), value=7.7)
    cams = stack_cameras(views, device=device)
    acc = zero_densify_acc(scene.point_count, device)
    zero_launches()
    scene, _, acc, metrics = step(scene, optimizer.init(scene), acc, cams, padded)
    h_local = h_pad // d_tiles
    y0 = mesh.coords["tiles"] * h_local
    out = dict(n=n, mesh=[D_DATA, d_tiles], image=[WIDTH, height], h_pad=h_pad,
               loss=float(metrics["loss"]), tile_point_total=int(metrics["tile_point_total"]),
               scene={f: _numpy(getattr(scene, f)) for f in FIELDS},
               grad_norm_sum=_numpy(acc["grad_norm_sum"]), slab=[y0, h_local],
               pad_slab=y0 >= height, launches=path_launches())
    if rank == 0:
        reference = single_reference(n, device, optimizer)
        out.update(loss_ref=reference["loss"], errors=parity_errors(out, reference))
        if not parity_within(out["errors"]):
            raise AssertionError(f"the sharded step at n={n} differs from the single-device "
                                 f"one: {out['errors']}")
        if out["tile_point_total"] <= 0:
            raise AssertionError(f"the sharded step at n={n} binned no entry")
    return out


def toy_scene_and_view(point_count: int, width: int, height: int, device) -> tuple:
    """The JAX package's toy scene and camera of its dry run: seeded points
    in the unit box, small scales, opacities in [0.1, 0.9), seen from 4
    units back."""
    rng = np.random.default_rng(0)
    scene = GaussianScene.from_points(
        Points(rng.random((point_count, 3)).astype(np.float32),
               rng.standard_normal((point_count, 3)) * 0.8), device=device)
    scene = scene.set_scalings(np.asarray(0.01 + 0.05 * rng.random((point_count, 3)),
                                          np.float32))
    scene = scene.set_opacities(np.asarray(0.1 + 0.8 * rng.random((point_count, 1)),
                                           np.float32))
    view = View(field_of_view_x=1.0, field_of_view_y=1.0, image_height=height,
                image_width=width, view_position=[0.0, 0.0, -4.0],
                view_transform=View.transform(np.eye(3), [0.0, 0.0, 4.0]))
    return scene, view


def dryrun_toy(n: int, device, log=print) -> dict:
    """One sharded training step on an n-rank mesh, the toy mode of the JAX
    package's multichip dry run: n factored as (data, tiles) with data the
    first of 2, 3, 4 that divides it, the 128-point toy scene at 64x48,
    2 * data views of its camera and zero targets. Run by every rank of an
    initialised default process group of at least n ranks. Raises
    ``AssertionError`` unless the loss is finite and the entry total above
    0. Returns ``mesh``, ``loss``, ``entries``, ``h_pad`` and ``launches``
    of the step."""
    from ..parallel import make_mesh, stack_cameras
    from ..parallel.train_step import make_sharded_train_step
    from ..train.densify import zero_densify_acc

    d_data = next((c for c in (2, 3, 4) if n % c == 0), 1)
    d_tiles = n // d_data
    mesh = make_mesh((d_data, d_tiles), ("data", "tiles"))
    point_count, width, height = 128, 64, 48
    scene, base = toy_scene_and_view(point_count, width, height, device)
    options = RenderOptions(tile_entry_capacity=1 << 14, block_size=64)
    views = [View(field_of_view_x=base.field_of_view_x, field_of_view_y=base.field_of_view_y,
                  image_height=height, image_width=width, view_id=i,
                  view_position=base.view_position, view_transform=base.view_transform)
             for i in range(2 * d_data)]
    step, optimizer, h_pad = make_sharded_train_step(mesh, width, height, point_count, options)
    targets = torch.zeros((len(views), h_pad, width, 3), dtype=torch.float32, device=device)
    cams = stack_cameras(views, device=device)
    acc = zero_densify_acc(point_count, device)
    zero_launches()
    scene, _, _, metrics = step(scene, optimizer.init(scene), acc, cams, targets)
    loss, entries = float(metrics["loss"]), int(metrics["tile_point_total"])
    if not math.isfinite(loss):
        raise AssertionError(f"the dry run at n={n} gave a non-finite loss: {loss}")
    if entries <= 0:
        raise AssertionError(f"the dry run at n={n} binned no entry")
    log(f"dryrun_toy OK: mesh=(data={d_data}, tiles={d_tiles}), loss={loss:.5f}, "
        f"entries={entries}")
    return dict(mesh=[d_data, d_tiles], loss=loss, entries=entries, h_pad=h_pad,
                launches=path_launches())


def scale_worker(rank: int, out_dir: str, n: int, device: str) -> None:
    """A spawned rank of the sweep at n: :func:`parity_rank`, then
    :func:`dryrun_toy`; writes ``out_dir/rank{rank}.json`` (no arrays)."""
    dev = rank_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    start = time.perf_counter()
    parity = parity_rank(rank, n, dev)
    parity_s = time.perf_counter() - start
    start = time.perf_counter()
    dryrun = dryrun_toy(n, dev, log=(lambda line: print(line, flush=True)) if rank == 0
                        else (lambda line: None))
    rec = {k: v for k, v in parity.items() if k not in ("scene", "grad_norm_sum")}
    rec.update(rank=rank, dryrun=dryrun, parity_s=parity_s,
               dryrun_s=time.perf_counter() - start)
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def record_losses() -> dict:
    """The JAX record's single-device loss by rank count."""
    return {r["n"]: r["loss_ref"] for r in json.loads(RECORD.read_text())}


def run_scale(n: int, device, record_loss: float) -> dict:
    """The sweep's step at n in n spawned gloo ranks on ``device``: rank 0's
    record, with the launches summed over every rank and over the ranks of
    each slab, which slabs lie wholly in the padding, and the sharded loss
    against ``record_loss``. Raises where a rank failed or the loss is
    beyond the record's tolerance."""
    from ..testing import spawn_ranks

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gausplat_mesh_scale_") as tmp:
        spawn_ranks(scale_worker, n, tmp, n, str(device), backend="gloo")
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(n)]
    rec = dict(ranks[0])
    for key in ("launches", "slab", "pad_slab", "rank"):
        rec.pop(key)
    if len({r["loss"] for r in ranks}) != 1:
        raise AssertionError(f"the ranks' losses differ at n={n}: {[r['loss'] for r in ranks]}")

    def total(counts: list) -> dict:
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    rec["dryrun"] = {k: v for k, v in rec["dryrun"].items() if k != "launches"}
    rtol = RECORD_RTOL[torch.device(device).type]
    rel = abs(rec["loss"] - record_loss) / abs(record_loss)
    slab_of = [r["slab"][0] // r["slab"][1] for r in ranks]
    rec.update(
        pad_slabs=sorted({i for i, r in zip(slab_of, ranks) if r["pad_slab"]}),
        launches=total([r["launches"] for r in ranks]),
        slab_launches=[total([r["launches"] for i, r in zip(slab_of, ranks) if i == slab])
                       for slab in range(n // D_DATA)],
        dryrun_launches=total([r["dryrun"]["launches"] for r in ranks]),
        seconds=time.perf_counter() - start, parity="ok", dryrun_toy_ok=True,
        rank_parity_s=[r["parity_s"] for r in ranks], rank_dryrun_s=[r["dryrun_s"] for r in ranks],
        record_loss_ref=record_loss, record_rel_err=rel, record_rtol=rtol)
    if rel > rtol:
        raise AssertionError(f"the sharded loss at n={n} is {rec['loss']}, the JAX "
                             f"record's {record_loss}: {rel:.3g} relative > {rtol}")
    return rec


def sweep(device="cuda", out_path=None, log=print) -> list:
    """:func:`run_scale` for each n of :data:`SWEEP`, one JSON line each;
    writes the list to ``out_path`` after every n."""
    device = rank_device(device)
    if device.type == "cuda":
        build_path_kernels()
    reference = record_losses()
    results = []
    for n in SWEEP:
        rec = run_scale(n, device, reference[n])
        log(json.dumps(rec))
        results.append(rec)
        if out_path:
            pathlib.Path(out_path).write_text(json.dumps(results, indent=1) + "\n")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="mesh_scale.json")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    sweep(args.device, args.out, log=lambda line: print(line, flush=True))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
