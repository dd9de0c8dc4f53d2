"""Drive the PyTorch + CUDA port on one NVIDIA GPU: serving and training.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It imports torch, numpy and ``gausplat_tpu_torch`` only (no JAX, and
nothing of ``tests/``), builds the three hand-written kernel libraries from
``gausplat_tpu_torch/csrc`` into ``build/gausplat_tpu_torch/`` (one nvcc
each, all at once; the rasterize libraries hold an entry point for f32
rows and one for packed bf16-pair rows), and runs twelve phases, each
printing one JSON line:

1. env: versions, the card, the kernel builds and their ptxas reports;
2. expand: the expansion kernel against its plain version, bit for bit
   (its four outputs, keys as sort-ready int32), on the small workloads of
   ``gausplat_tpu_torch.testing.EXPAND_WORKLOADS`` (chunk edges, cuts
   inside and at a chunk, no points, a run longer than a CTA, tile indices
   past 32768) and on the full-size projection output (and the CUDA
   projection's integer outputs against the CPU's);
3. rasterize: the forward kernel against its plain version on a small
   scene (image / transmittance atol 1e-4, counts exact) and at full size
   (image / transmittance within 1e-3, >= 99.99% of rendered counts
   equal), a second launch bit for bit, plus the count flips of an
   FMA-contracting build of the same source;
4. fixture: the CUDA render and its gradients against outputs stored by
   the JAX package (``tests/data/torch_xcheck.npz``), f32 and bf16 entry
   rows: images atol 1e-4, integers exact, gradients within 1e-3 scaled
   by each field's largest magnitude;
5. main_path: serving, under ``torch.no_grad``: a 1M-point scene at
   1920x1080 rendered for 5 views through ``render`` and once through
   ``render_views``, with the launch counts of both forward kernels, then
   CUDA-event timings of the render and of both forward kernels beside
   their plain versions at the serving shapes, with each kernel's own
   device time (profiler, by kernel name), the share of (entry, warp)
   pairs that the rasterizers' footprint keeps, ``torch.sort`` on B's
   int32 keys in turns with the same keys as int64, ``bin_gaussians`` as a
   whole, and a torch.profiler breakdown of the render;
6. rasterize_backward: the backward kernel against its plain version on
   the small scene (tight culling on and off) and at full size on the
   bench view with a seeded cotangent, per gradient row within 1e-3
   scaled by the row's largest magnitude, over the slots below the valid
   entry count, and a second launch bit for bit;
7. adversarial: both rasterizers on rows that stress their footprint skip
   (near-singular conics, opacities at the thresholds, huge and sub-pixel
   ellipses, pixels on an ellipse's edge, non-PD conics, NaN and inf):
   A's counts equal to the plain version's, C within 1e-3 scaled wherever
   the plain rows are finite (the only phase that leaves any slot out);
8. grad: the whole render backward through the kernels against the plain
   path on the small scene (five parameter gradients and the grad norm);
9. train: the slice's main path: ``Trainer.fit`` for 10 steps on the
   full-size scene (every SH degree, a densify, an opacity reset), with
   the launch counts of all three kernels; then, at the step's shapes,
   each kernel against its plain version (tolerances as in phases 2, 3
   and 6) and timed beside it (CUDA events around the wrapper, and the
   device time of its own kernels; B's call must launch nothing else), A
   and C also built without their footprint skip (bit-identical outputs
   required) and timed; the sorts and the binning as at serving; timings
   of a step and of forward + backward, the peak memory, and a profile of
   a step;
10. colmap_bf16: the bf16 training path from a COLMAP capture. A synthetic
   sparse model of the bench scene (1,000,000 SfM points, the 5 views as
   PINHOLE 1920x1080 images, no image files) is written to a temporary
   directory, loaded with ``load_sparse_model`` (views and points must
   round-trip), initialised with ``GaussianScene.from_points`` on the card
   and fitted with ``Trainer.fit`` for 10 steps with phase 9's
   ``TrainConfig`` and ``entry_dtype="bf16"`` against phase 9's f32
   targets (losses finite and falling, every entry total within its
   capacity, the packed kernels launched and the f32 rasterizers not);
   then, at the step's shapes, B bit for bit, the packed A against its
   plain version
   (image and transmittance within 1e-3, >= 99.99% of counts equal, a
   second launch and the build without the skip bit-identical) and the
   packed C (decoded: position rows within 1e-3 scaled, bf16 rows within
   1e-3 scaled plus one bf16 ulp of each element, the flips counted; a
   second launch and the build without the skip bit-identical), both timed
   beside their plain versions and beside the f32 entry points on the same
   projection, with bounds from the packed bytes; and render + loss +
   gradients on the fitted scene timed with bf16 and with f32 rows, in
   turns.
11. parallel: multi-device render and training on ``torch.distributed``:
   (a) one NCCL rank (world size 1) renders the bench view through
   ``render_tile_sharded``, bit for bit ``render``, gradients too; then four
   ranks spawned on this card over gloo (NCCL refuses two ranks on one
   GPU; the backend is printed) run (b) BASELINE.json's fifth
   configuration as ``scripts/mesh_4k.py`` makes it, 2,000,000 points at
   3840x2176, in 4 slabs (the record's 8, cut to 4), against the single
   render in rank 0 (at most 1e-3 of the pixels beyond 1e-4, radii equal,
   every slab within its capacity), and (c) the (2, 2) (data, tiles) step
   on the bench scene's 4 orbit views against the single-device loss
   (rtol 2e-4) and gradients (1e-3 scaled) the parent computed, then 3
   ``ShardedTrainer`` steps across a densify event, after which the ranks'
   scenes must agree bit for bit; each rank's wall time is printed (four
   processes share one card: not scaling numbers). Then A, B and C on
   slab 0 and on the last slab (its padded rows) of the step's first view,
   against their plain versions and timed beside them.
12. tools: the user-facing modules. (a) the PLY payload codec on the
   serving scene through the host C++ library (``utils/native.py``, which
   must be available) and through numpy (``scene/ply.py``): the same
   bytes, both decodes bit for bit the scene, seconds per million points
   each way; then ``encode_polygon`` / ``decode_polygon`` on the card, a
   bit-for-bit round trip; (b) ``python -m
   gausplat_tpu_torch.scripts.render_ply`` (its ``main``) on that PLY at
   1920x1080 on the card: A and B launched once each, and the PNG, read
   back with the standard library, equal to the u8 pixels of the
   in-process render of the same ``orbit_view``; (c) ``fit_toy_scene(400)``:
   losses finite, the last PSNR above the first, the decoded PLY's scene
   and its render bit for bit the fitted one, A, B and C launched; (d)
   ``train_long``'s lego recipe for 2,000 steps (losses finite, no step's
   entries over its capacity, the last 200-step chunk's mean loss below the
   first's, A, B and C launched), its curve printed beside the JAX
   package's record ``train_long_r05_lego.json`` (read as data) with the
   wall ms per step and the peak memory, then A, B and C at its shapes
   (view 0 of the fitted scene) against their plain versions and timed;
   (e) one render inside ``profiling.trace`` and two ``profiling.stage``
   scopes: the Chrome trace must name both stages and the kernels of A
   and B.

Then it prints the card's name and power limit, one JSON line of
per-kernel results, every number of which comes from a training path
(phase 9 for the f32 entry points of A, B and C, phase 10 for the packed
``rasterize_forward_bf16`` and ``rasterize_backward_bf16``, phase 11 for
A, B and C on the slabs, ``<kernel>@slab0`` and ``@last_slab``, whose
launches are the parallel path's summed over its ranks, phase 12 for A, B
and C at the lego fit's shapes, ``<kernel>@lego_fit``, whose launches are
its 2,000 steps': their
launches, and the error, time (``ms``, CUDA events around the wrapper;
``device_ms``, its kernels' device time), plain time and bound at the
step's shapes;
for A and C also the footprint's kept share and their registers, static
shared memory and resident CTAs per SM; all launch with no dynamic shared
memory), and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
last line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_xcheck.npz"
#: The full-size entry count of the bench scene, as recorded by the JAX
#: package (PERF_AB_r05.jsonl line 6); an integer, not a timing.
JAX_RECORDED_ENTRIES = 1_756_434
REPS = 5

#: One NVIDIA H100 SXM (data sheet peak rates):
#: f32 outside the tensor cores, and device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: f32 operations that every blended (entry, pixel) pair costs at least,
#: in the forward and again in the backward replay: dx, dy (2), the
#: quadratic form (9), the -0.5 scale and exp (2), the opacity product and
#: its clamp (2), the two blend tests (2). Only the blended pairs count
#: (``blended_pairs``): a pair that cannot blend may be rejected without
#: evaluating it, as the kernels' footprint skip rejects most of them.
PAIR_FLOPS_MIN = 17
#: Gradients of the backward kernel and of the render through the kernels
#: against their plain versions, scaled by each row's or field's largest
#: magnitude (sequential sums on the card against log-step sums).
GRAD_SCALED_ATOL = 1e-3


def nvidia_smi(query: str) -> str:
    done = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else done.stderr.strip()


def emit(phase: str, seconds: float, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "seconds": round(seconds, 3)}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = REPS) -> tuple[float, list[float]]:
    """Median CUDA-event time (ms) of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def in_turns(first, second, reps: int = REPS) -> dict:
    """Two functions timed in turns (first, second, second, first), each turn
    a :func:`cuda_ms`: per function, the median over both of its turns and
    every time (ms)."""
    times = {"first": [], "second": []}
    for name in ("first", "second", "second", "first"):
        times[name] += cuda_ms(first if name == "first" else second, reps)[1]
    return {name: (statistics.median(t), t) for name, t in times.items()}


def profile_device_time(fn, reps: int = 3, top: int = 12) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler,
    CUPTI), the device-busy time per call against the host clock, and the
    idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / reps
    kernels = []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = event.cuda_time_total
        kernels.append((device_us / 1e3 / reps, event.count // reps, event.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms == 0.0:
        return dict(device_busy_ms="not measured (the profiler saw no device time)",
                    wall_ms=wall_ms)
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches=sum(k[1] for k in kernels),
        top=[dict(ms=ms, calls=n, name=name) for ms, n, name in kernels[:top]],
    )


#: The device kernels of each kernel library, by the names the profiler
#: reports them under (a memset that a library issues shows as "Memset").
DEVICE_KERNELS = {
    "expand.cu": ("expand_chunk_sums", "expand_slots", "Memset"),
    "rasterize_forward.cu": ("rasterize_forward_kernel",),
    "rasterize_backward.cu": ("rasterize_backward_kernel",),
}


def device_ms(fn, names=None, reps: int = 20) -> dict:
    """Device time per call of ``fn`` (torch.profiler, CUPTI) over ``reps``
    calls after a warm-up: ``device_ms`` of the kernels whose names contain
    one of ``names``, or of every kernel where ``names`` is None
    (``kernels``: by name), ``device_all_ms`` of every kernel, and the names
    of the others that ran. "not measured" where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    every = 0.0
    mine, others = {}, []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(event, "device_time_total", None)
        us = event.cuda_time_total if us is None else us
        every += us
        found = ([event.key[:90]] if names is None
                 else [name for name in names if name in event.key])
        if found:
            mine[found[0]] = mine.get(found[0], 0.0) + us / 1e3 / reps
        else:
            others.append(event.key[:90])
    if every == 0.0:
        return dict(device_ms="not measured (the profiler saw no device time)")
    return dict(device_ms=sum(mine.values()), device_all_ms=every / 1e3 / reps,
                kernels=mine, other_kernels=others)


def kernel_device_ms(fn, kernel) -> dict:
    """:func:`device_ms` of the kernels of ``kernel``'s library."""
    return device_ms(fn, DEVICE_KERNELS[kernel.source.name])


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max()) if a.numel() else 0.0


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error divided by the reference's largest magnitude."""
    if not want.numel():
        return 0.0
    scale = float(want.detach().double().abs().max())
    return max_abs(got, want) / scale if scale > 0 else max_abs(got, want)


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time for the work (ms): the larger of the bytes over the
    card's memory rate and the f32 operations over its f32 rate."""
    ms_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ms_ops = flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(ms_bytes, ms_ops),
                bound_by="bytes" if ms_bytes >= ms_ops else "operations",
                bound_bytes=bytes_moved, bound_flops=flops)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def entry_bytes(rows, ids, ranges) -> int:
    """The bytes of a rasterizer's entry inputs that this run's data needs
    read: the tile ranges whole, the sorted ids below the valid entry count
    (each tile stages only its ``[r0, r1)``), and the rows of the points
    those ids name (the rows of culled points are never gathered)."""
    valid = int(ranges[:, 1].max()) if ranges.numel() else 0
    points = int(torch.unique(ids[:valid]).numel())
    return nbytes(ranges) + ids.element_size() * valid + rows.shape[0] * rows.element_size() * points


# --- inputs (numpy recipes from a seed) ----------------------------------------


def small_scene_arrays(p=80, seed=3):
    """The scene of tests/test_rasterize.py::_scene_arrays."""
    rng = np.random.default_rng(seed)
    csh = rng.standard_normal((p, 48)).astype(np.float32) * 0.4
    positions = (rng.standard_normal((p, 3)) * 0.8).astype(np.float32)
    rotations = rng.standard_normal((p, 4)).astype(np.float32)
    scalings = np.log(0.02 + 0.15 * rng.random((p, 3))).astype(np.float32)
    op_inner = (rng.standard_normal((p, 1)) * 2).astype(np.float32)
    return dict(colors_sh=csh, opacities=op_inner, positions=positions,
                rotations=rotations, scalings=scalings)


def bench_scene_arrays(point_count=1_000_000):
    """bench.py::_make_inputs: points in a ball, garden-like scales."""
    rng = np.random.default_rng(0)
    positions = (rng.standard_normal((point_count, 3)) * 2.2).astype(np.float32)
    colors_sh = rng.standard_normal((point_count, 48)).astype(np.float32) * 0.2
    opacities = rng.standard_normal((point_count, 1)).astype(np.float32)
    rotations = rng.standard_normal((point_count, 4)).astype(np.float32)
    scalings = np.log(0.002 + 0.008 * rng.random((point_count, 3))).astype(np.float32)
    return dict(colors_sh=colors_sh, opacities=opacities, positions=positions,
                rotations=rotations, scalings=scalings)


def train_start_arrays(arrays):
    """The train phase's start point: the target's arrays with seeded noise."""
    p = arrays["positions"].shape[0]
    rng = np.random.default_rng(1)
    start = {k: v.copy() for k, v in arrays.items()}
    start["colors_sh"][:, :3] += rng.normal(0.0, 0.3, (p, 3)).astype(np.float32)
    start["opacities"] -= 1.0
    start["positions"] += rng.normal(0.0, 0.01, (p, 3)).astype(np.float32)
    return start


def orbit_view(T, yaw, pitch, width=1920, height=1080, distance=8.0):
    """The bench camera (fov 1.2 x 0.8, 8 units behind the origin, looking
    at it), turned by ``yaw`` / ``pitch`` radians about the origin."""
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    turn = ry @ rx
    position = turn @ np.array([0.0, 0.0, -distance])
    world_to_view = turn.T
    return T.View(
        field_of_view_x=1.2, field_of_view_y=0.8,
        image_height=height, image_width=width,
        view_position=position,
        view_transform=T.View.transform(world_to_view.T, -world_to_view @ position),
    )


def bench_views(T):
    """The five 1920x1080 views of the bench scene: straight on, then turned
    by 0.1 rad left, right, up and down."""
    return [orbit_view(T, 0.0, 0.0), orbit_view(T, 0.1, 0.0), orbit_view(T, -0.1, 0.0),
            orbit_view(T, 0.0, 0.1), orbit_view(T, 0.0, -0.1)]


def raster_inputs(scene, view, capacity, tight, device, sh_degree=3, packed=False, slab=None):
    """Entry rows (f32, or packed bf16 pairs), sorted ids, tile ranges, the
    tile count across and the projection of one view, as the render builds
    them; with ``slab = (y0, rows)``, of the slab of ``rows`` rows from row
    ``y0``, as a tile-sharded render builds it (the camera's screen origin
    shifted by ``y0``)."""
    from gausplat_tpu_torch.ops.binning import bin_gaussians
    from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
    from gausplat_tpu_torch.ops.blend import pack_rows
    from gausplat_tpu_torch.ops.rasterize import pack_point_data

    y0, rows = slab if slab is not None else (0, view.image_height)
    tcx, tcy = -(-view.image_width // 16), -(-rows // 16)
    camera = Camera.from_view(view, device=device)
    if slab is not None:
        camera.pos2d_shift = torch.tensor([0.0, float(y0)], device=device)
    with torch.no_grad():
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
            camera, sh_degree=sh_degree,
            tile_count_x=tcx, tile_count_y=tcy, opacities=scene.opacities,
            tight_culling=tight,
        )
        binning = bin_gaussians(
            proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
        )
        rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
        rows = pack_rows(rows) if packed else rows
    return rows, binning.point_indices, binning.tile_ranges, tcx, proj


def expand_args(proj):
    """Kernel B's inputs from a projection."""
    return (proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min, proj.tile_counts)


def small_view(T):
    """The camera of tests/test_rasterize.py: 56x40, 4 units back."""
    return T.View(
        field_of_view_x=1.0, field_of_view_y=0.8, image_height=40, image_width=56,
        view_position=[0.0, 0.0, -4.0],
        view_transform=T.View.transform(np.eye(3), [0.0, 0.0, 4.0]),
    )


# --- each kernel against its plain version ----------------------------------------


def compare_expand(args, capacity, tile_count_x) -> dict:
    """Kernel B against its plain version: every output bit for bit."""
    from gausplat_tpu_torch.ops.binning import make_point_orders
    from gausplat_tpu_torch.ops.expand import fused_point_orders

    got = fused_point_orders(*args, tile_count_x=tile_count_x, capacity=capacity)
    ref = make_point_orders(*args, tile_count_x=tile_count_x, capacity=capacity)
    torch.cuda.synchronize()
    return dict(bit_identical=[bool(torch.equal(a, b)) for a, b in zip(got, ref)],
                max_abs=max(max_abs(a, b) for a, b in zip(got, ref)),
                out_bytes=nbytes(*got))


def sort_and_binning(proj, tcx, tcy, capacity) -> dict:
    """Kernel B's consumer at these shapes: ``torch.sort(stable=True)`` on
    B's int32 keys and on the same keys widened to int64 (the layout before
    the int32 keys), in turns (int64, int32, int32, int64), each also by its
    device time; both must give the same order. Then ``bin_gaussians`` as a
    whole through the kernel: CUDA-event and device time."""
    from gausplat_tpu_torch.ops.binning import bin_gaussians, keys_to_u32
    from gausplat_tpu_torch.ops.expand import fused_point_orders

    b_args = expand_args(proj)
    keys = fused_point_orders(*b_args, tile_count_x=tcx, capacity=capacity)[0]
    wide = keys_to_u32(keys)
    check(torch.equal(torch.sort(keys, stable=True)[1], torch.sort(wide, stable=True)[1]),
          "the int32 and int64 keys sort into different orders")

    def sort32():
        return torch.sort(keys, stable=True)

    def sort64():
        return torch.sort(wide, stable=True)

    def binning():
        return bin_gaussians(*b_args, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
                             expand=fused_point_orders)

    turns = in_turns(sort64, sort32)
    bin_ms, bin_all = cuda_ms(binning)
    return dict(
        capacity=capacity, order="int64, int32, int32, int64",
        sort_int64_ms=turns["first"][0], sort_int32_ms=turns["second"][0],
        sort_int64_ms_all=turns["first"][1], sort_int32_ms_all=turns["second"][1],
        sort_int64_device=device_ms(sort64), sort_int32_device=device_ms(sort32),
        bin_gaussians_ms=bin_ms, bin_gaussians_ms_all=bin_all,
        bin_gaussians_device=device_ms(binning),
    )


def compare_forward(rows, ids, ranges, tcx, block_size=None) -> tuple[dict, tuple]:
    """Kernel A against its plain version, and against a second launch of
    itself (bit for bit); returns the record and the kernel's outputs."""
    from gausplat_tpu_torch.ops.rasterize import (
        DEFAULT_BLOCK_SIZE, rasterize_forward, rasterize_forward_torch,
    )

    got = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    again = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    ref = rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx,
                                  block_size=block_size or DEFAULT_BLOCK_SIZE)
    torch.cuda.synchronize()
    return dict(image_max_abs=max_abs(got[0], ref[0]),
                transmittance_max_abs=max_abs(got[1], ref[1]),
                count_equal_fraction=float((got[2] == ref[2]).double().mean()),
                count_mismatches=int((got[2] != ref[2]).sum()),
                repeat_bit_identical=all(torch.equal(a, b) for a, b in zip(got, again))), got


def forward_close_at_full_size(rec) -> bool:
    """Kernel A's tolerance at full size: image and transmittance within
    1e-3, at least 99.99% of the rendered counts equal, and a second launch
    bit-identical."""
    return (rec["image_max_abs"] <= 1e-3 and rec["transmittance_max_abs"] <= 1e-3
            and rec["count_equal_fraction"] >= 0.9999 and rec["repeat_bit_identical"])


def warp_keep_share(rows, ids, ranges, tcx) -> float:
    """The share of (entry, warp) pairs in the tile ranges that the kernels'
    footprint keeps (``entry_warp_masks``, the plain version of their mask)."""
    from gausplat_tpu_torch.ops.rasterize import WARPS_PER_TILE, entry_warp_masks

    masks = entry_warp_masks(rows, ids, ranges, tile_count_x=tcx).to(torch.int32)
    bits = (masks[:, None] >> torch.arange(WARPS_PER_TILE, device=masks.device)) & 1
    entries = int((ranges[:, 1] - ranges[:, 0]).clamp_min(0).sum())
    return int(bits.sum()) / (WARPS_PER_TILE * entries) if entries else 0.0


def blended_pairs(rows, ids, ranges, counts, tcx, block=256, tile_chunk=512) -> int:
    """The (entry, pixel) pairs that blend: below the pixel's rendered count
    ``counts`` [T, 256], with alpha >= 1/255 by the plain blend test
    (``ops/blend.py::density_terms``). A rasterizer evaluates at least
    these; the operation part of A's and C's bounds counts them."""
    from gausplat_tpu_torch.ops.blend import EntryBlock, decode_rows, density_terms
    from gausplat_tpu_torch.ops.rasterize import pixel_coords

    rows = decode_rows(rows)
    r0 = ranges[:, 0].long()
    walk = torch.minimum((ranges[:, 1].long() - r0).clamp_min(0),
                         counts.max(dim=1).values.long())
    steps = -(-walk // block)
    pos = torch.arange(block, device=rows.device)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for k in range(int(steps.max()) if steps.numel() else 0):
        for tiles in torch.split(torch.nonzero(steps > k).flatten(), tile_chunk):
            at = k * block + pos  # positions in the tiles' segments [B]
            inside = at < walk[tiles, None]  # [n, B]
            slots = torch.where(inside, r0[tiles, None] + at, 0)
            entries = EntryBlock.from_rows(rows[:, ids[slots].long()])
            pix_x, pix_y = pixel_coords(tiles, tcx)
            blendable = density_terms(entries, pix_x, pix_y)[4]  # [n, B, 256]
            below = at[None, :, None] < counts[tiles][:, None, :]
            total += (blendable & below & inside[..., None]).sum()
    return int(total)


def backward_inputs(rows, ids, ranges, tcx, grad_image):
    """Kernel C's inputs for one view: the forward kernel's image and counts,
    the tiled cotangent and <g, C>."""
    from gausplat_tpu_torch.ops.rasterize import rasterize_forward, tile_image

    image_tiles, _, count_tiles = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    tcy = ranges.shape[0] // tcx
    grad_tiles = tile_image(grad_image, tcx, tcy)
    gdotc = torch.sum(grad_tiles * image_tiles, dim=1)
    return (rows, ids, ranges, grad_tiles, gdotc, count_tiles)


def compare_backward(args, tcx, block_size, nonfinite_plain_allowed=False
                     ) -> tuple[dict, torch.Tensor]:
    """Kernel C against its plain version over the slots below the valid
    entry count, and against a second launch of itself (bit for bit);
    returns the record and the kernel's rows. f32 rows: per-row error
    scaled by the row's largest magnitude. Packed rows are compared decoded
    (``gausplat_tpu_torch.testing.compare_packed_grads``: position rows
    scaled, bf16 rows scaled beyond one bf16 ulp of each element, and the
    bf16 elements that flip). Every such slot is compared, unless
    ``nonfinite_plain_allowed`` (f32 rows built to be non-finite) leaves
    out the slots where the plain row is not finite."""
    from gausplat_tpu_torch.ops.blend import decode_rows, is_packed
    from gausplat_tpu_torch.ops.rasterize import rasterize_backward, rasterize_backward_torch
    from gausplat_tpu_torch.testing import compare_packed_grads

    got = rasterize_backward(*args, tile_count_x=tcx)
    again = rasterize_backward(*args, tile_count_x=tcx)
    ref = rasterize_backward_torch(*args, tile_count_x=tcx, block_size=block_size)
    torch.cuda.synchronize()
    valid = int(args[2][:, 1].max())
    got_f32, ref_f32 = decode_rows(got[:, :valid]), decode_rows(ref[:, :valid])
    finite = torch.isfinite(ref_f32)
    keep = finite if nonfinite_plain_allowed else torch.ones_like(finite)
    if is_packed(got):
        rec = compare_packed_grads(got[:, :valid], ref[:, :valid])
    else:
        rec = dict(row_scaled_err=[scaled_err(got_f32[r][keep[r]], ref_f32[r][keep[r]])
                                   for r in range(9)])
    return dict(valid_slots=valid, **rec, max_abs=max_abs(got_f32[keep], ref_f32[keep]),
                plain_nonfinite=int((~finite).sum()),
                nonfinite_plain_allowed=nonfinite_plain_allowed,
                finite=bool(torch.isfinite(got_f32).all()),
                repeat_bit_identical=bool(torch.equal(got[:, :valid], again[:, :valid]))), got


def backward_close(rec) -> bool:
    """Kernel C's tolerance: finite rows within ``GRAD_SCALED_ATOL`` of the
    plain version (packed: plus one bf16 ulp of each bf16 element; a NaN
    error fails), plain rows finite unless the record allows otherwise, and
    a second launch bit-identical."""
    return (rec["finite"] and all(e <= GRAD_SCALED_ATOL for e in rec["row_scaled_err"])
            and (rec["plain_nonfinite"] == 0 or rec["nonfinite_plain_allowed"])
            and rec["repeat_bit_identical"])


def time_without_skip(rows, ids, ranges, tcx, c_args, a_out, c_out) -> dict:
    """Kernels A and C (their entry points for the rows' layout) built
    without their footprint skip (``-DGS_FOOTPRINT_SKIP=0``,
    csrc/tile_batch.cuh): each build's time, launch facts, and whether its
    outputs equal the default build's bit for bit (they must: a skipped
    pair cannot blend)."""
    from gausplat_tpu_torch.ops.blend import is_packed
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD, RASTERIZE_BACKWARD_PACKED, RASTERIZE_FORWARD,
        RASTERIZE_FORWARD_PACKED, rasterize_backward, rasterize_forward,
    )
    from gausplat_tpu_torch.utils.kernels import NVCC_FLAGS, build_all

    flags = NVCC_FLAGS + ("-DGS_FOOTPRINT_SKIP=0",)
    a_kernel, c_kernel = ((RASTERIZE_FORWARD_PACKED, RASTERIZE_BACKWARD_PACKED) if is_packed(rows)
                          else (RASTERIZE_FORWARD, RASTERIZE_BACKWARD))
    a_kernel, c_kernel = a_kernel.with_flags(flags), c_kernel.with_flags(flags)
    build_all([a_kernel, c_kernel])
    valid = int(ranges[:, 1].max())

    def run_a():
        return rasterize_forward(rows, ids, ranges, tile_count_x=tcx, kernel=a_kernel)

    def run_c():
        return rasterize_backward(*c_args, tile_count_x=tcx, kernel=c_kernel)

    out = {}
    for name, kernel, run, same in (
        ("rasterize_forward", a_kernel, run_a,
         lambda got: all(torch.equal(a, b) for a, b in zip(got, a_out))),
        ("rasterize_backward", c_kernel, run_c,
         lambda got: bool(torch.equal(got[:, :valid], c_out[:, :valid]))),
    ):
        identical = same(run())
        ms, ms_all = cuda_ms(run)
        out[name] = dict(ms=ms, ms_all=ms_all, bit_identical_to_default=identical,
                         **kernel.launch_info())
    return out


def all_kernels():
    """Every kernel entry point of the port, in the order of the kernels line."""
    from gausplat_tpu_torch.ops.expand import EXPAND
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD, RASTERIZE_BACKWARD_PACKED, RASTERIZE_FORWARD,
        RASTERIZE_FORWARD_PACKED,
    )

    return (RASTERIZE_FORWARD, EXPAND, RASTERIZE_BACKWARD, RASTERIZE_FORWARD_PACKED,
            RASTERIZE_BACKWARD_PACKED)


def fit_ten_steps(trainer, views, targets) -> tuple[list, list, dict, float]:
    """The training path: ``Trainer.fit`` for 10 steps, in three calls (4, 4
    and 2 steps) so that every step's entry total is checked against the
    capacity it ran with. Every kernel's count is set to 0 just before and
    read just after. Returns the history, the segments, the launches and
    the seconds."""
    kernels = all_kernels()
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    start_time = time.perf_counter()
    history, segments = [], []
    for steps in (4, 4, 2):
        capacity, points = trainer._entry_capacity, trainer.scene.point_count
        part = trainer.fit(views, targets, steps)
        segments.append(dict(steps=steps, capacity=capacity, points_before=points,
                             points_after=trainer.scene.point_count,
                             max_total=max(int(h["tile_point_total"]) for h in part)))
        history += part
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start_time
    return history, segments, {kernel.entry: kernel.launches for kernel in kernels}, seconds


def train_config(options, views):
    """The training phases' ``TrainConfig``: every SH degree, a densify after
    steps 4 and 8, an opacity reset after step 8, an overflow check every 4
    steps, the scene extent of the views."""
    from gausplat_tpu_torch import train as TT

    extent = TT.camera_extent(views)
    return TT.TrainConfig(
        sh_warmup_interval=1, densify_from=4, densify_interval=4, densify_until=9,
        opacity_reset_interval=8, overflow_check_interval=4, render=options,
        optimizer=TT.OptimizerConfig(scene_extent=extent),
        densify=TT.DensifyConfig(scene_extent=extent),
    )


# --- phases ---------------------------------------------------------------------


def phase_env(ctx):
    from gausplat_tpu_torch.utils.kernels import build_all, find_nvcc

    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    release = [line for line in version.splitlines() if "release" in line]
    try:
        import triton  # noqa: F401  (reported only; the port does not use it)

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    kernels = all_kernels()
    start = time.perf_counter()
    build_all(kernels)  # one nvcc per library; the packed entry points share it
    builds = {k.entry: round(k.build_seconds, 3) for k in kernels}
    ptxas = {
        k.source.name: [line.split(":", 1)[1].strip() for line in (k.build_log or "").splitlines()
                        if "Used" in line and "registers" in line]
        for k in kernels
    }
    return dict(
        python=sys.version.split()[0], torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=release[0].strip() if release else version,
        triton=triton_version,
        device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(),
        nvidia_smi=ctx["card"], build_seconds=builds,
        build_all_seconds=time.perf_counter() - start, ptxas=ptxas,
    )


def phase_expand(ctx):
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
    from gausplat_tpu_torch.testing import EXPAND_WORKLOADS

    dev = ctx["device"]
    out = {}

    for name, workload in EXPAND_WORKLOADS.items():
        arrays, capacity, tcx = workload()
        args = [torch.as_tensor(a, device=dev) for a in arrays]
        same = compare_expand(args, capacity, tcx)["bit_identical"]
        out[name] = same
        check(all(same), f"expansion kernel differs from its plain version on {name}: {same}")

    # Full size: the projection of the bench scene at 1920x1080.
    scene, view = ctx["scene"], ctx["views"][0]
    tcx, tcy = -(-view.image_width // 16), -(-view.image_height // 16)

    def project(s, device):
        return project_gaussians(
            s.colors_sh, s.positions, s.rotations, s.scalings,
            Camera.from_view(view, device=device), sh_degree=3,
            tile_count_x=tcx, tile_count_y=tcy, opacities=s.opacities,
            tight_culling=True,
        )

    with torch.no_grad():
        proj = project(scene, dev)
        proj_cpu = project(T.GaussianScene.from_numpy(**ctx["arrays"], device="cpu"), "cpu")
    flips = {}
    for field in ("radii", "tile_x_max", "tile_x_min", "tile_y_max", "tile_y_min",
                  "tile_counts", "visible"):
        flips[field] = int((getattr(proj, field).cpu() != getattr(proj_cpu, field)).sum())
    float_err = {
        field: max_abs(getattr(proj, field).cpu(), getattr(proj_cpu, field))
        for field in ("color_r", "conic_xx", "conic_xy", "pos2d_x", "depths")
    }
    capacity = ctx["capacity"]
    full = compare_expand(expand_args(proj), capacity, tcx)
    out["full_size"] = same = full["bit_identical"]
    out["full_size_max_abs_diff"] = full["max_abs"]
    check(all(same), f"expansion kernel differs from its plain version at full size: {same}")
    ctx["proj"], ctx["tcx"], ctx["tcy"] = proj, tcx, tcy
    return dict(bit_identical=out, capacity=capacity,
                cuda_vs_cpu_projection_int_flips=flips,
                cuda_vs_cpu_projection_max_abs=float_err)


def phase_rasterize(ctx):
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.rasterize import RASTERIZE_FORWARD, rasterize_forward
    from gausplat_tpu_torch.utils.kernels import NVCC_FLAGS

    dev = ctx["device"]
    results = {}
    with torch.no_grad():
        small = T.GaussianScene.from_numpy(**small_scene_arrays(), device=dev)
        for tight in (False, True):
            rows, ids, ranges, tcx, _ = raster_inputs(small, small_view(T), 1024, tight, dev)
            rec, _ = compare_forward(rows, ids, ranges, tcx, block_size=64)
            results[f"small_tight{int(tight)}"] = rec
            check(rec["image_max_abs"] <= 1e-4 and rec["transmittance_max_abs"] <= 1e-4
                  and rec["count_mismatches"] == 0,
                  f"forward kernel differs from its plain version on the small scene: {rec}")

        rows, ids, ranges, tcx, _ = raster_inputs(
            ctx["scene"], ctx["views"][0], ctx["capacity"], True, dev)
        full, got = compare_forward(rows, ids, ranges, tcx)
        results["full_size"] = full
        check(forward_close_at_full_size(full),
              f"forward kernel differs from its plain version at full size: {full}")

        # The same source built with FMA contraction: how many counts move.
        fmad = RASTERIZE_FORWARD.with_flags(
            [f for f in NVCC_FLAGS if not f.startswith("-fmad")] + ["-fmad=true"]
        )
        contracted = rasterize_forward(rows, ids, ranges, tile_count_x=tcx, kernel=fmad)
        torch.cuda.synchronize()
        results["fmad_true_vs_false"] = dict(
            count_mismatches=int((contracted[2] != got[2]).sum()),
            image_max_abs=max_abs(contracted[0], got[0]),
        )
    ctx["raster_inputs"] = (rows, ids, ranges, tcx)
    ctx["raster_pairs"] = int(got[2].to(torch.int64).sum())
    ctx["raster_blended"] = blended_pairs(rows, ids, ranges, got[2], tcx)
    return results


def phase_fixture(ctx):
    import gausplat_tpu_torch as T

    data = np.load(FIXTURE)
    cases = sorted({key.split("/")[0] for key in data.files})
    dev = ctx["device"]
    out = {}
    for case in cases:
        g = {key.split("/", 1)[1]: data[key] for key in data.files if key.startswith(case + "/")}
        scene = T.GaussianScene.from_numpy(
            **{name: g[name] for name in ("colors_sh", "opacities", "positions",
                                          "rotations", "scalings")},
            device=dev,
        )
        fov_x, fov_y, height, width = g["view_shape"]
        view = T.View(
            field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
            image_height=int(height), image_width=int(width),
            view_position=g["view_position"], view_transform=g["view_transform"],
        )
        sh_degree, tight, capacity, block, bf16 = (int(x) for x in g["options"])
        options = T.RenderOptions(
            backend="cuda", colors_sh_degree_max=sh_degree, tight_culling=bool(tight),
            tile_entry_capacity=capacity, block_size=block,
            entry_dtype="bf16" if bf16 else "f32",
        )
        ref = torch.zeros(scene.point_count, device=dev, requires_grad=True)
        got = T.render(scene, view, options, ref)
        torch.sum(got.colors_rgb_2d * torch.as_tensor(g["grad_weight"], device=dev)).backward()
        grads = {name: p.grad for name, p in scene.named_parameters()}
        grads["norm"] = ref.grad
        grad_err = {name: scaled_err(value.cpu(), torch.as_tensor(g[f"grad_{name}"]))
                    for name, value in grads.items()}
        rec = dict(
            entry_dtype=options.entry_dtype,
            image_max_abs=max_abs(got.colors_rgb_2d.cpu(), torch.as_tensor(g["image"])),
            transmittance_max_abs=max_abs(got.transmittances.cpu(),
                                          torch.as_tensor(g["transmittance"])),
            count_mismatches=int((got.point_rendered_counts.cpu().numpy() != g["counts"]).sum()),
            radii_mismatches=int((got.radii.cpu().numpy() != g["radii"]).sum()),
            total=int(got.tile_point_total), jax_total=int(g["total"]),
            grad_scaled_err=grad_err,
        )
        out[case] = rec
        check(rec["image_max_abs"] <= 1e-4 and rec["transmittance_max_abs"] <= 1e-4
              and rec["count_mismatches"] == 0 and rec["radii_mismatches"] == 0
              and rec["total"] == rec["jax_total"]
              and max(grad_err.values()) <= GRAD_SCALED_ATOL,
              f"CUDA render differs from the JAX fixture on {case}: {rec}")
    return out


@torch.no_grad()
def phase_main_path(ctx):
    """Serving: no graph is built and nothing is kept for a backward."""
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.binning import make_point_orders
    from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_FORWARD, rasterize_forward, rasterize_forward_torch,
    )

    scene, views, options = ctx["scene"], ctx["views"], ctx["options"]
    kernels = (EXPAND, RASTERIZE_FORWARD)

    for kernel in kernels:
        kernel.launches = 0
    start = time.perf_counter()
    outs = [T.render(scene, view, options) for view in views]
    batched = T.render_views(scene, views, options)
    torch.cuda.synchronize()
    serve_seconds = time.perf_counter() - start
    launches = {kernel.source.name: kernel.launches for kernel in kernels}
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")

    capacity = options.tile_entry_capacity
    totals = [int(o.tile_point_total) for o in outs]
    for o in outs:
        check(bool(torch.isfinite(o.colors_rgb_2d).all()), "non-finite image")
        check(tuple(o.colors_rgb_2d.shape) == (1080, 1920, 3), "image shape")
    check(max(totals) <= capacity, f"entry overflow: {totals} > {capacity}")
    check(not any(o.colors_rgb_2d.requires_grad for o in outs), "serving built a graph")
    check(bool(torch.isfinite(batched.colors_rgb_2d).all()), "non-finite batched image")
    batch_same = all(
        torch.equal(batched.colors_rgb_2d[i], o.colors_rgb_2d)
        and torch.equal(batched.point_rendered_counts[i], o.point_rendered_counts)
        for i, o in enumerate(outs)
    )
    check(batch_same, "render_views differs from render on the same views")

    # Timings at the main path's shapes (these launches are not counted above).
    view = views[0]
    render_ms, render_all = cuda_ms(lambda: T.render(scene, view, options))
    plain_options = T.RenderOptions(tile_entry_capacity=capacity, backend="torch")
    plain_render_ms, plain_render_all = cuda_ms(lambda: T.render(scene, view, plain_options))
    b_args = expand_args(ctx["proj"])
    kw = dict(tile_count_x=ctx["tcx"], capacity=capacity)
    b_ms, b_all = cuda_ms(lambda: fused_point_orders(*b_args, **kw))
    b_plain_ms, b_plain_all = cuda_ms(lambda: make_point_orders(*b_args, **kw))
    b_device = kernel_device_ms(lambda: fused_point_orders(*b_args, **kw), EXPAND)
    rows, ids, ranges, tcx = ctx["raster_inputs"]
    a_ms, a_all = cuda_ms(lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx))
    a_plain_ms, a_plain_all = cuda_ms(
        lambda: rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx)
    )
    a_device = kernel_device_ms(lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx),
                                RASTERIZE_FORWARD)
    sorting = sort_and_binning(ctx["proj"], ctx["tcx"], ctx["tcy"], capacity)
    try:
        breakdown = profile_device_time(lambda: T.render(scene, view, options))
    except RuntimeError as e:  # the profiler is a measurement, not the path
        breakdown = dict(device_busy_ms=f"not measured ({e})")
    # Bounds from these shapes: each input read once, each output written
    # once; kernel A's operations over the blended pairs.
    tiles = ranges.shape[0]
    a_bound = bound(entry_bytes(rows, ids, ranges) + tiles * 256 * (3 + 1 + 1) * 4,
                    ctx["raster_blended"] * PAIR_FLOPS_MIN)
    a_bound["pairs_below_counts"] = ctx["raster_pairs"]
    a_bound["blended_pairs"] = ctx["raster_blended"]
    a_bound["warp_keep_share"] = warp_keep_share(rows, ids, ranges, tcx)
    b_bound = bound(nbytes(*b_args) + nbytes(*fused_point_orders(*b_args, **kw)), 0.0)
    return dict(
        card=ctx["card"], views=len(views), capacity=capacity, launches=launches,
        tile_point_total=totals,
        bench_view_total=totals[0], jax_recorded_total=JAX_RECORDED_ENTRIES,
        bench_view_total_minus_jax=totals[0] - JAX_RECORDED_ENTRIES,
        image_mean=[float(o.colors_rgb_2d.mean()) for o in outs],
        serve_5_views_plus_batch_seconds=serve_seconds,
        render_ms=render_ms, render_ms_all=render_all,
        plain_render_ms=plain_render_ms, plain_render_ms_all=plain_render_all,
        rasterize_forward_ms=a_ms, rasterize_forward_ms_all=a_all,
        rasterize_forward_plain_ms=a_plain_ms, rasterize_forward_plain_ms_all=a_plain_all,
        rasterize_forward_device=a_device,
        expand_ms=b_ms, expand_ms_all=b_all,
        expand_plain_ms=b_plain_ms, expand_plain_ms_all=b_plain_all, expand_device=b_device,
        rasterize_forward_bound=a_bound, expand_bound=b_bound, sort_and_binning=sorting,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        render_profile=breakdown,
    )


@torch.no_grad()
def phase_rasterize_backward(ctx):
    import gausplat_tpu_torch as T

    dev = ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(11)
    results = {}
    small = T.GaussianScene.from_numpy(**small_scene_arrays(), device=dev)
    for tight in (False, True):
        rows, ids, ranges, tcx, _ = raster_inputs(small, small_view(T), 1024, tight, dev)
        grad = torch.randn((40, 56, 3), generator=gen, device=dev)
        rec, _ = compare_backward(backward_inputs(rows, ids, ranges, tcx, grad), tcx, 64)
        results[f"small_tight{int(tight)}"] = rec
        check(backward_close(rec),
              f"backward kernel differs from its plain version on the small scene: {rec}")

    rows, ids, ranges, tcx = ctx["raster_inputs"]
    view = ctx["views"][0]
    grad = torch.randn((view.image_height, view.image_width, 3), generator=gen, device=dev)
    full, _ = compare_backward(backward_inputs(rows, ids, ranges, tcx, grad), tcx, 256)
    results["full_size"] = full
    check(backward_close(full),
          f"backward kernel differs from its plain version at full size: {full}")
    return results


@torch.no_grad()
def phase_adversarial(ctx):
    """Kernels A and C on rows that stress their footprint skip
    (``gausplat_tpu_torch.testing.adversarial_entries``: near-singular conics,
    opacities at 1/255 (1 +- 1e-6) and above 252/255, huge and sub-pixel
    ellipses, pixels on the edge of an ellipse and alone in their strip,
    non-PD conics, NaN and inf): A's counts equal to the plain version's,
    image and transmittance within 1e-4; C within GRAD_SCALED_ATOL wherever
    the plain rows are finite."""
    from gausplat_tpu_torch.testing import adversarial_entries

    dev = ctx["device"]
    rows, ids, ranges, width, height, tcx = adversarial_entries()
    rows, ids, ranges = (torch.as_tensor(a, device=dev) for a in (rows, ids, ranges))
    a_rec, _ = compare_forward(rows, ids, ranges, tcx, block_size=64)
    check(a_rec["count_mismatches"] == 0 and a_rec["image_max_abs"] <= 1e-4
          and a_rec["transmittance_max_abs"] <= 1e-4 and a_rec["repeat_bit_identical"],
          f"forward kernel differs from its plain version on the adversarial rows: {a_rec}")
    grad = torch.randn((height, width, 3), generator=torch.Generator(device=dev).manual_seed(13),
                       device=dev)
    c_rec, _ = compare_backward(backward_inputs(rows, ids, ranges, tcx, grad), tcx, 64,
                                nonfinite_plain_allowed=True)
    check(backward_close(c_rec),
          f"backward kernel differs from its plain version on the adversarial rows: {c_rec}")
    return dict(entries=int(ranges[0, 1] - ranges[0, 0]), tiles=int(ranges.shape[0]),
                warp_keep_share=warp_keep_share(rows, ids, ranges, tcx),
                rasterize_forward=a_rec, rasterize_backward=c_rec)


def phase_grad(ctx):
    import gausplat_tpu_torch as T

    dev = ctx["device"]
    view = small_view(T)
    weight = torch.randn((40, 56, 3), generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    grads = {}
    for backend in ("cuda", "torch"):
        scene = T.GaussianScene.from_numpy(**small_scene_arrays(), device=dev)
        ref = torch.zeros(scene.point_count, device=dev, requires_grad=True)
        out = T.render(scene, view, T.RenderOptions(backend=backend, tile_entry_capacity=1024,
                                                    block_size=64), ref)
        torch.sum(out.colors_rgb_2d * weight).backward()
        grads[backend] = {name: p.grad for name, p in scene.named_parameters()}
        grads[backend]["norm"] = ref.grad
    err = {name: scaled_err(grads["cuda"][name], want) for name, want in grads["torch"].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads["cuda"].values())
    check(finite and max(err.values()) <= GRAD_SCALED_ATOL,
          f"render gradients through the kernels differ from the plain path: {err}")
    return dict(scaled_err=err, tolerance=GRAD_SCALED_ATOL)


def phase_train(ctx):
    import dataclasses

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT
    from gausplat_tpu_torch.ops.binning import make_point_orders
    from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD, RASTERIZE_FORWARD, rasterize_backward, rasterize_backward_torch,
        rasterize_forward, rasterize_forward_torch, untile_image,
    )

    dev, views = ctx["device"], ctx["views"]
    with torch.no_grad():
        targets = [T.render(ctx["scene"], v, ctx["options"]).colors_rgb_2d for v in views]
    ctx["targets"] = targets
    scene = T.GaussianScene.from_numpy(**train_start_arrays(ctx["arrays"]), device=dev)
    options = T.calibrate_options(scene, views)
    config = train_config(options, views)
    extent = config.densify.scene_extent
    width, height = views[0].image_width, views[0].image_height
    trainer = TT.Trainer(scene, width, height, config)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history, segments, all_launches, fit_seconds = fit_ten_steps(trainer, views, targets)
    launches = {kernel.source.name: all_launches[kernel.entry]
                for kernel in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [h["loss"] for h in history]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    # The loss falls until the opacity reset after step 8 caps every
    # opacity at 0.01 (standard 3DGS; a long fit recovers over hundreds of
    # steps): step 5 sees view 0 again, step 7 is the last before the reset.
    reset = config.opacity_reset_interval
    check(losses[5] < losses[0] and losses[reset - 1] < losses[0],
          f"the loss did not fall before the opacity reset: {losses}")
    check(all(n >= 10 for n in launches.values()), f"a kernel ran under 10 times: {launches}")
    check(all(seg["max_total"] <= seg["capacity"] for seg in segments),
          f"entry overflow: {segments}")
    packed_launches = {k: all_launches[k] for k in ("gs_rasterize_forward_packed",
                                                    "gs_rasterize_backward_packed")}
    check(not any(packed_launches.values()), f"f32 training ran a packed kernel: {packed_launches}")
    densify = [{k: h[k] for k in ("cloned", "split", "pruned", "point_count")}
               for h in history if "point_count" in h]
    check(len(densify) >= 1, f"no densify event: {densify}")
    check(trainer._sh_degree() == 3, "the SH warm-up did not reach degree 3")

    # Forward + backward alone, and the densification signal.
    view, target = views[0], targets[0]

    def forward_backward():
        ref = torch.zeros(trainer.scene.point_count, device=dev, requires_grad=True)
        out = T.render(trainer.scene, view, trainer._options(), ref)
        loss = TT.photometric_loss(out.colors_rgb_2d, target)
        grads = torch.autograd.grad(loss, list(trainer.scene.parameters()) + [ref])
        return out, grads

    out, grads = forward_backward()
    norm = grads[-1]
    culled = out.radii == 0
    check(bool((norm >= 0).all()) and bool((norm[culled] == 0).all()),
          "grad norms negative, or nonzero on culled points")
    check(all(bool(torch.isfinite(g).all()) for g in grads), "non-finite gradient")
    fwd_bwd_ms, fwd_bwd_all = cuda_ms(forward_backward)

    # The three kernels at the step's shapes (view 0 after the fit, the
    # step's capacity): each against its plain version, timed beside it,
    # and its bound. Kernel C takes the loss's own image cotangent.
    opts = trainer._options()
    capacity = opts.tile_entry_capacity
    rows, ids, ranges, tcx, proj = raster_inputs(
        trainer.scene, view, capacity, opts.tight_culling, dev,
        sh_degree=opts.colors_sh_degree_max)
    b_args, b_kw = expand_args(proj), dict(tile_count_x=tcx, capacity=capacity)
    b_rec = compare_expand(b_args, capacity, tcx)
    check(all(b_rec["bit_identical"]),
          f"expansion kernel differs from its plain version at the step's shapes: {b_rec}")
    a_rec, a_out = compare_forward(rows, ids, ranges, tcx)
    check(forward_close_at_full_size(a_rec),
          f"forward kernel differs from its plain version at the step's shapes: {a_rec}")
    image = untile_image(a_out[0], tcx, ranges.shape[0] // tcx, width, height)
    image = image.detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(TT.photometric_loss(image, target), image)
    c_args = backward_inputs(rows, ids, ranges, tcx, cotangent)
    c_rec, c_out = compare_backward(c_args, tcx, 256)
    check(backward_close(c_rec),
          f"backward kernel differs from its plain version at the step's shapes: {c_rec}")

    times = {
        "rasterize_forward": (
            cuda_ms(lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx)),
            cuda_ms(lambda: rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx))),
        "expand_point_orders": (
            cuda_ms(lambda: fused_point_orders(*b_args, **b_kw)),
            cuda_ms(lambda: make_point_orders(*b_args, **b_kw))),
        "rasterize_backward": (
            cuda_ms(lambda: rasterize_backward(*c_args, tile_count_x=tcx)),
            cuda_ms(lambda: rasterize_backward_torch(*c_args, tile_count_x=tcx))),
    }
    # Device time of each kernel's own launches per call (profiler, by name);
    # B's call must launch nothing but its library's kernels.
    devices = {
        "rasterize_forward": kernel_device_ms(
            lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx), RASTERIZE_FORWARD),
        "expand_point_orders": kernel_device_ms(
            lambda: fused_point_orders(*b_args, **b_kw), EXPAND),
        "rasterize_backward": kernel_device_ms(
            lambda: rasterize_backward(*c_args, tile_count_x=tcx), RASTERIZE_BACKWARD),
    }
    check(not devices["expand_point_orders"].get("other_kernels"),
          f"the expansion launched other kernels: {devices['expand_point_orders']}")
    sorting = sort_and_binning(proj, tcx, ranges.shape[0] // tcx, capacity)
    # Bounds from these shapes: each input read once, each output written
    # once; A's and C's operations over the blended pairs.
    pairs = int(a_out[2].to(torch.int64).sum())
    blended = blended_pairs(rows, ids, ranges, a_out[2], tcx)
    bounds = {
        "rasterize_forward": bound(entry_bytes(rows, ids, ranges) + nbytes(*a_out),
                                   blended * PAIR_FLOPS_MIN),
        "expand_point_orders": bound(nbytes(*b_args) + b_rec["out_bytes"], 0.0),
        "rasterize_backward": bound(entry_bytes(rows, ids, ranges) + nbytes(*c_args[3:])
                                    + 9 * c_rec["valid_slots"] * 4, blended * PAIR_FLOPS_MIN),
    }
    keep = warp_keep_share(rows, ids, ranges, tcx)
    no_skip = time_without_skip(rows, ids, ranges, tcx, c_args, a_out, c_out)
    check(all(rec["bit_identical_to_default"] for rec in no_skip.values()),
          f"the skip changed an output of A or C: {no_skip}")
    # A's and C's footprint skip and their resources (registers and shared
    # memory as ptxas set them, and resident CTAs per SM).
    extra = {name: dict(warp_keep_share=keep, **kernel.launch_info())
             for name, kernel in (("rasterize_forward", RASTERIZE_FORWARD),
                                  ("rasterize_backward", RASTERIZE_BACKWARD))}
    errors = {
        "rasterize_forward": max(a_rec["image_max_abs"], a_rec["transmittance_max_abs"]),
        "expand_point_orders": b_rec["max_abs"],
        "rasterize_backward": c_rec["max_abs"],
    }
    kernel_rows = (
        ("rasterize_forward", "rasterize_forward.cu", "gausplat_tpu/ops/rasterize.py:409"),
        ("expand_point_orders", "expand.cu", "gausplat_tpu/ops/expand.py:121"),
        ("rasterize_backward", "rasterize_backward.cu", "gausplat_tpu/ops/rasterize.py:604"),
    )
    ctx["kernels"] = [
        dict(name=name, route="cuda", source=f"gausplat_tpu_torch/csrc/{source}",
             replaces=replaces, launches=launches[source], max_abs_err=errors[name],
             ms=times[name][0][0], plain_ms=times[name][1][0],
             device_ms=devices[name]["device_ms"],
             bound_ms=bounds[name]["bound_ms"], bound_by=bounds[name]["bound_by"],
             library_ms=None, **extra.get(name, {}))
        for name, source, replaces in kernel_rows
    ]

    # A step with no host event: no densify, no overflow read.
    trainer.config = dataclasses.replace(trainer.config, densify_until=0,
                                         overflow_check_interval=10**9)
    step_ms, step_all = cuda_ms(lambda: trainer.train_step(view, target))
    try:
        breakdown = profile_device_time(lambda: trainer.train_step(view, target))
    except RuntimeError as e:  # the profiler is a measurement, not the path
        breakdown = dict(device_busy_ms=f"not measured ({e})")

    return dict(
        card=ctx["card"], steps=len(history), launches=launches, losses=losses,
        psnr=[h["psnr"] for h in history], tile_point_total=[int(h["tile_point_total"])
                                                          for h in history],
        segments=segments, densify=densify, start_capacity=options.tile_entry_capacity,
        scene_extent=extent, loss_first=losses[0], loss_before_reset=losses[reset - 1],
        loss_last=losses[-1],
        fit_10_steps_seconds=fit_seconds, peak_memory_gb=peak_gb,
        forward_backward_ms=fwd_bwd_ms, forward_backward_ms_all=fwd_bwd_all,
        step_ms=step_ms, step_ms_all=step_all,
        kernels_at_step=dict(
            capacity=capacity, points=trainer.scene.point_count,
            pairs_below_counts=pairs, blended_pairs=blended,
            compare=dict(rasterize_forward=a_rec, expand_point_orders=b_rec,
                         rasterize_backward=c_rec),
            ms_all={name: t[0][1] for name, t in times.items()},
            plain_ms_all={name: t[1][1] for name, t in times.items()},
            device=devices, bounds=bounds, warp_keep_share=keep, no_skip=no_skip,
            sort_and_binning=sorting,
        ),
        grad_norm_max=float(norm.max()), culled_points=int(culled.sum()),
        step_profile=breakdown,
    )


def rotation_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """A rotation matrix -> its unit quaternion (w, x, y, z), COLMAP's order
    (Shepperd's method: the largest of the four squares first)."""
    t = np.trace(r)
    i = int(np.argmax([t, r[0, 0], r[1, 1], r[2, 2]]))
    if i == 0:
        w = math.sqrt(1.0 + t) / 2.0
        q = [w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
             (r[1, 0] - r[0, 1]) / (4 * w)]
    else:
        a, b, c = (i - 1, i % 3, (i + 1) % 3)
        v = math.sqrt(1.0 + r[a, a] - r[b, b] - r[c, c]) / 2.0
        q = [0.0] * 4
        q[0] = (r[c, b] - r[b, c]) / (4 * v)
        q[1 + a], q[1 + b], q[1 + c] = v, (r[b, a] + r[a, b]) / (4 * v), (r[c, a] + r[a, c]) / (4 * v)
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def write_sparse_model(directory: pathlib.Path, positions, colors_u8, views) -> None:
    """A COLMAP sparse model (cameras.bin, images.bin, points3D.bin, the
    binary layout that ``scene/colmap.py`` reads) of a point cloud seen by
    ``views``: one PINHOLE camera per view, no 2-D observations, empty
    tracks. Written with numpy and ``struct``; no images."""
    import struct

    with open(directory / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            fx = v.image_width / (2.0 * math.tan(v.field_of_view_x / 2.0))
            fy = v.image_height / (2.0 * math.tan(v.field_of_view_y / 2.0))
            fh.write(struct.pack("<iiQQ", i + 1, 1, v.image_width, v.image_height))
            fh.write(struct.pack("<4d", fx, fy, v.image_width / 2.0, v.image_height / 2.0))
    with open(directory / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            rotation = v.view_rotation()  # world -> view, p_view = R p + t
            fh.write(struct.pack("<I", i + 1))
            fh.write(struct.pack("<7d", *rotation_to_quat_wxyz(rotation), *v.view_translation()))
            fh.write(struct.pack("<I", i + 1))
            fh.write(f"view_{i:02d}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
                       ("track", "<u8")])
    points = np.zeros(len(positions), record)
    points["id"] = np.arange(1, len(positions) + 1)
    points["xyz"] = positions
    points["rgb"] = colors_u8
    points["error"] = 0.5
    with open(directory / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(positions)))
        points.tofile(fh)


def phase_colmap_bf16(ctx):
    """The bf16 training path from a COLMAP capture: a synthetic sparse
    model of the bench scene through ``load_sparse_model``,
    ``GaussianScene.from_points`` and ``Trainer.fit`` with packed bf16
    entry rows; then the packed kernels A and C at the step's shapes."""
    import dataclasses
    import tempfile

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT
    from gausplat_tpu_torch.constants import SH_C0
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD_PACKED, RASTERIZE_FORWARD_PACKED, rasterize_backward,
        rasterize_backward_torch, rasterize_forward, rasterize_forward_torch, untile_image,
    )
    from gausplat_tpu_torch.scene.colmap import load_sparse_model

    dev, views, arrays = ctx["device"], ctx["views"], ctx["arrays"]
    p = arrays["positions"].shape[0]
    colors_u8 = np.clip((arrays["colors_sh"][:, :3] * SH_C0 + 0.5) * 255.0 + 0.5, 0,
                        255).astype(np.uint8)
    positions = arrays["positions"].astype(np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        write_sparse_model(pathlib.Path(tmp), positions, colors_u8, views)
        write_seconds = time.perf_counter() - start
        names = {}
        start = time.perf_counter()
        points, loaded = load_sparse_model(tmp, names)
        load_seconds = time.perf_counter() - start
    check(len(points) == p and np.array_equal(points.positions, positions)
          and np.array_equal(points.colors_rgb, colors_u8.astype(np.float32) / 255.0),
          "the SfM points did not round-trip")
    loaded = [loaded[k] for k in sorted(loaded)]
    view_err = dict(
        fov=max(abs(a.field_of_view_x - b.field_of_view_x) + abs(a.field_of_view_y
                - b.field_of_view_y) for a, b in zip(loaded, views)),
        position=max(float(np.abs(a.view_position - b.view_position).max())
                     for a, b in zip(loaded, views)),
        transform=max(float(np.abs(a.view_transform - b.view_transform).max())
                      for a, b in zip(loaded, views)),
    )
    check(len(loaded) == len(views) and all(
        (a.image_width, a.image_height) == (b.image_width, b.image_height)
        for a, b in zip(loaded, views)) and max(view_err.values()) <= 1e-9,
        f"the views did not round-trip: {view_err}")

    start = time.perf_counter()
    scene = T.GaussianScene.from_points(points, device=dev)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - start
    options = T.calibrate_options(scene, loaded, T.RenderOptions(entry_dtype="bf16"))
    config = train_config(options, loaded)
    width, height = loaded[0].image_width, loaded[0].image_height
    trainer = TT.Trainer(scene, width, height, config)
    targets = ctx["targets"]
    history, segments, launches, fit_seconds = fit_ten_steps(trainer, loaded, targets)

    losses = [h["loss"] for h in history]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    # Steps 5 and 6 see views 0 and 1 again, before the opacity reset.
    check(losses[5] < losses[0] and losses[6] < losses[1], f"the loss did not fall: {losses}")
    check(all(seg["max_total"] <= seg["capacity"] for seg in segments),
          f"entry overflow: {segments}")
    path = ("gs_expand_point_orders", "gs_rasterize_forward_packed",
            "gs_rasterize_backward_packed")
    check(all(launches[k] >= 10 for k in path), f"a kernel of the bf16 path ran under 10 "
          f"times: {launches}")
    check(launches["gs_rasterize_forward"] == launches["gs_rasterize_backward"] == 0,
          f"the bf16 path ran an f32 rasterize kernel: {launches}")

    # The packed kernels at the step's shapes (view 0 after the fit, the
    # step's capacity), each against its plain version, and beside the f32
    # entry points on the same projection; C takes the loss's own cotangent.
    opts = trainer._options()
    view, target = loaded[0], targets[0]
    capacity = opts.tile_entry_capacity
    rows, ids, ranges, tcx, proj = raster_inputs(
        trainer.scene, view, capacity, opts.tight_culling, dev,
        sh_degree=opts.colors_sh_degree_max, packed=True)
    b_rec = compare_expand(expand_args(proj), capacity, tcx)
    check(all(b_rec["bit_identical"]),
          f"expansion kernel differs from its plain version at the bf16 step's shapes: {b_rec}")
    f32_rows = raster_inputs(trainer.scene, view, capacity, opts.tight_culling, dev,
                             sh_degree=opts.colors_sh_degree_max)[0]
    a_rec, a_out = compare_forward(rows, ids, ranges, tcx)
    check(forward_close_at_full_size(a_rec),
          f"packed forward kernel differs from its plain version at the step's shapes: {a_rec}")
    image = untile_image(a_out[0], tcx, ranges.shape[0] // tcx, width, height)
    image = image.detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(TT.photometric_loss(image, target), image)
    c_args = backward_inputs(rows, ids, ranges, tcx, cotangent)
    c_rec, c_out = compare_backward(c_args, tcx, 256)
    check(backward_close(c_rec),
          f"packed backward kernel differs from its plain version at the step's shapes: {c_rec}")
    no_skip = time_without_skip(rows, ids, ranges, tcx, c_args, a_out, c_out)
    check(all(rec["bit_identical_to_default"] for rec in no_skip.values()),
          f"the skip changed an output of packed A or C: {no_skip}")
    f32_c_args = backward_inputs(f32_rows, ids, ranges, tcx, cotangent)

    def forward_backward(entry_dtype):
        step_options = dataclasses.replace(opts, entry_dtype=entry_dtype)

        def run():
            ref = torch.zeros(trainer.scene.point_count, device=dev, requires_grad=True)
            out = T.render(trainer.scene, view, step_options, ref)
            loss = TT.photometric_loss(out.colors_rgb_2d, target)
            return torch.autograd.grad(loss, list(trainer.scene.parameters()) + [ref])

        return run

    # Render + loss + gradients on the same scene with each layout, in turns.
    fwd_bwd = in_turns(forward_backward("bf16"), forward_backward("f32"))

    # Each packed entry point in turns with the f32 one on the same
    # projection (packed, f32, f32, packed), and its plain version.
    a_turns = in_turns(lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx),
                       lambda: rasterize_forward(f32_rows, ids, ranges, tile_count_x=tcx))
    c_turns = in_turns(lambda: rasterize_backward(*c_args, tile_count_x=tcx),
                       lambda: rasterize_backward(*f32_c_args, tile_count_x=tcx))
    times = {
        "rasterize_forward_bf16": (a_turns["first"], cuda_ms(
            lambda: rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx))),
        "rasterize_forward_f32_same_scene": (a_turns["second"],),
        "rasterize_backward_bf16": (c_turns["first"], cuda_ms(
            lambda: rasterize_backward_torch(*c_args, tile_count_x=tcx))),
        "rasterize_backward_f32_same_scene": (c_turns["second"],),
    }
    # Bounds from the packed bytes: each input read once, each output
    # written once; the operations over the blended pairs of the decoded rows.
    pairs = int(a_out[2].to(torch.int64).sum())
    blended = blended_pairs(rows, ids, ranges, a_out[2], tcx)
    bounds = {
        "rasterize_forward_bf16": bound(entry_bytes(rows, ids, ranges) + nbytes(*a_out),
                                        blended * PAIR_FLOPS_MIN),
        "rasterize_backward_bf16": bound(entry_bytes(rows, ids, ranges) + nbytes(*c_args[3:])
                                         + 6 * c_rec["valid_slots"] * 4,
                                         blended * PAIR_FLOPS_MIN),
    }
    keep = warp_keep_share(rows, ids, ranges, tcx)
    devices = {
        "rasterize_forward_bf16": kernel_device_ms(
            lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx),
            RASTERIZE_FORWARD_PACKED),
        "rasterize_backward_bf16": kernel_device_ms(
            lambda: rasterize_backward(*c_args, tile_count_x=tcx), RASTERIZE_BACKWARD_PACKED),
    }
    errors = {"rasterize_forward_bf16": max(a_rec["image_max_abs"],
                                            a_rec["transmittance_max_abs"]),
              "rasterize_backward_bf16": c_rec["max_abs"]}
    for name, kernel, replaces in (
        ("rasterize_forward_bf16", RASTERIZE_FORWARD_PACKED, "gausplat_tpu/ops/rasterize.py:409"),
        ("rasterize_backward_bf16", RASTERIZE_BACKWARD_PACKED,
         "gausplat_tpu/ops/rasterize.py:604"),
    ):
        ctx["kernels"].append(dict(
            name=name, route="cuda", source=f"gausplat_tpu_torch/csrc/{kernel.source.name}",
            replaces=replaces, launches=launches[kernel.entry], max_abs_err=errors[name],
            ms=times[name][0][0], device_ms=devices[name]["device_ms"],
            plain_ms=times[name][1][0], bound_ms=bounds[name]["bound_ms"],
            bound_by=bounds[name]["bound_by"], library_ms=None, warp_keep_share=keep,
            **kernel.launch_info()))

    return dict(
        card=ctx["card"], points=len(points), views=len(loaded), write_seconds=write_seconds,
        load_seconds=load_seconds, from_points_seconds=init_seconds, view_round_trip=view_err,
        steps=len(history), launches=launches, losses=losses,
        psnr=[h["psnr"] for h in history],
        tile_point_total=[int(h["tile_point_total"]) for h in history], segments=segments,
        start_capacity=options.tile_entry_capacity, fit_10_steps_seconds=fit_seconds,
        forward_backward_ms=dict(bf16=fwd_bwd["first"], f32=fwd_bwd["second"]),
        kernels_at_step=dict(
            capacity=capacity, points=trainer.scene.point_count, pairs_below_counts=pairs,
            blended_pairs=blended,
            compare=dict(rasterize_forward_bf16=a_rec, rasterize_backward_bf16=c_rec,
                         expand_point_orders=b_rec),
            device=devices,
            ms_all={name: [t[1] for t in pair] for name, pair in times.items()},
            ms={name: [t[0] for t in pair] for name, pair in times.items()},
            bounds=bounds, warp_keep_share=keep, no_skip=no_skip,
        ),
    )


# --- the parallel phase: torch.distributed ----------------------------------------

#: BASELINE.json's fifth configuration, as scripts/mesh_4k.py renders it
#: (MESH4K_r05.json): 2,000,000 points of ``default_rng(7)`` at 3840x2176.
MESH4K_WIDTH, MESH4K_HEIGHT, MESH4K_POINTS = 3840, 2176, 2_000_000
#: The cut: 4 slabs, where the record has 8 (this machine has one card).
MESH4K_SLABS = 4
#: Entries per slab: the record's 2^21 per slab of 8 (its largest slab
#: held 1,955,178) times 4 for the slabs of twice the rows.
MESH4K_CAPACITY = MESH4K_SLABS << 23
#: The sharded step's ranks: a (data, tiles) mesh of 2 x 2 on the 4 orbit
#: views of the bench scene.
STEP_MESH = (2, 2)
#: Pixels of the 4K frame whose largest channel difference from the
#: single-device render may exceed 1e-4: at most this share.
MESH4K_PIXEL_SHARE = 1e-3


def mesh4k_scene(T, device):
    """scripts/mesh_4k.py's scene: ``from_points`` of seeded points, then
    per-axis scales in [0.004, 0.012) and opacities in [0.2, 0.9)."""
    rng = np.random.default_rng(7)
    points = T.Points(rng.random((MESH4K_POINTS, 3)).astype(np.float32),
                      (rng.standard_normal((MESH4K_POINTS, 3)) * np.array([2.2, 1.3, 1.0])
                       ).astype(np.float32))
    scene = T.GaussianScene.from_points(points, device=device)
    scene = scene.set_scalings(0.004 + 0.008 * rng.random((MESH4K_POINTS, 3)))
    return scene.set_opacities(0.2 + 0.7 * rng.random((MESH4K_POINTS, 1)))


def mesh4k_view(T):
    return T.View(field_of_view_x=1.2, field_of_view_y=0.75, image_height=MESH4K_HEIGHT,
                  image_width=MESH4K_WIDTH, view_position=[0.0, 0.0, -5.0],
                  view_transform=T.View.transform(np.eye(3), [0.0, 0.0, 5.0]))


def step_train_config(options, views):
    """The sharded trainer's schedule: SH degrees 0-2 over 3 steps, a
    densify after step 2, an overflow check every step."""
    from gausplat_tpu_torch import train as TT

    extent = TT.camera_extent(views)
    return TT.TrainConfig(
        sh_warmup_interval=1, densify_from=2, densify_interval=2, densify_until=3,
        opacity_reset_interval=10**9, overflow_check_interval=1, render=options,
        optimizer=TT.OptimizerConfig(scene_extent=extent),
        densify=TT.DensifyConfig(scene_extent=extent))


def params_digest(scene) -> str:
    import hashlib

    digest = hashlib.sha256()
    for p in scene.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def slab_bins(scene, view, index, device) -> dict:
    """How the tile rows that slab ``index`` of a ``MESH4K_SLABS``-way
    split bins differ from the whole frame's rows clipped to the slab: the
    points binned differently (their tile-row range, or whether they reach
    the slab at all), and the entries either way. The slab's bounds come
    from positions shifted by ``y0`` in f32, the frame's from the unshifted
    ones, so a bound that lies on a tile edge can round to either side."""
    from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
    from gausplat_tpu_torch.parallel.render import slab_rows

    h_local, _ = slab_rows(view.image_height, MESH4K_SLABS)
    tcx, tcy = -(-view.image_width // 16), h_local // 16
    t0 = index * tcy

    def project(camera, rows):
        with torch.no_grad():
            return project_gaussians(scene.colors_sh, scene.positions, scene.rotations,
                                     scene.scalings, camera, sh_degree=3, tile_count_x=tcx,
                                     tile_count_y=rows, opacities=scene.opacities,
                                     tight_culling=True)

    full = project(Camera.from_view(view, device=device), -(-view.image_height // 16))
    camera = Camera.from_view(view, device=device)
    camera.pos2d_shift = torch.tensor([0.0, float(index * h_local)], device=device)
    slab = project(camera, tcy)
    lo = (full.tile_y_min - t0).clamp(0, tcy)
    hi = (full.tile_y_max - t0).clamp(0, tcy)
    full_in = (full.tile_counts > 0) & (hi > lo)
    slab_in = slab.tile_counts > 0
    same = (lo == slab.tile_y_min) & (hi == slab.tile_y_max)
    differ = (full_in != slab_in) | (full_in & slab_in & ~same)
    width = (full.tile_x_max - full.tile_x_min).to(torch.int64)
    return dict(points_binned_differently=int(differ.sum()),
                entries_slab=int(slab.tile_counts.to(torch.int64).sum()),
                entries_frame_rows=int(torch.where(full_in, (hi - lo) * width, 0).sum()))


def parallel_worker(rank, out_dir, spec):
    """One of the four ranks of the parallel phase, all on one card
    (``spec["device"]``) over gloo: (b) the 4K frame of ``mesh4k_scene`` in 4 slabs
    (``render_tile_sharded``), rank 0 against the single-device render;
    (c) the (2, 2) sharded step on the bench scene's 4 orbit views, rank 0
    against the single-device loss and gradients in ``reference.pt``, then
    3 ``ShardedTrainer`` steps across a densify event. Writes
    ``rank{rank}.json``: its times, launch counts, checks and its scene's
    digest."""
    import torch.distributed as dist

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel import make_mesh, render_tile_sharded, stack_cameras
    from gausplat_tpu_torch.parallel.train_step import ShardedTrainer, make_sharded_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    out_dir = pathlib.Path(out_dir)
    kernels = all_kernels()
    rec = dict(rank=rank, backend=dist.get_backend())
    begin = time.perf_counter()

    # (b) The 4K frame in 4 slabs.
    scene = mesh4k_scene(T, dev)
    view = mesh4k_view(T)
    options = T.RenderOptions(tile_entry_capacity=MESH4K_CAPACITY, block_size=128)
    mesh = make_mesh((MESH4K_SLABS,), ("tiles",))
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    dist.barrier()
    start = time.perf_counter()
    with torch.no_grad():
        out = render_tile_sharded(scene, view, mesh, "tiles", options)
    torch.cuda.synchronize()
    rec["render_4k_seconds"] = time.perf_counter() - start
    launches = {k.entry: k.launches for k in kernels}
    slab_capacity = MESH4K_CAPACITY // MESH4K_SLABS
    rec["bins"] = slab_bins(scene, view, mesh.coords["tiles"], dev)
    rec["slab_watermark"], rec["slab_capacity"] = int(out.tile_point_total), slab_capacity
    check(int(out.tile_point_total) < slab_capacity,
          f"a slab overflowed: {int(out.tile_point_total)} >= {slab_capacity}")
    if rank == 0:
        with torch.no_grad():
            single = T.render(scene, view, options)
        diff = (out.colors_rgb_2d - single.colors_rgb_2d).abs().amax(dim=-1)
        rec["mesh4k"] = dict(
            image=[MESH4K_WIDTH, MESH4K_HEIGHT], points=MESH4K_POINTS, slabs=MESH4K_SLABS,
            visible_points=int((single.radii > 0).sum()),
            total_entries=int(single.tile_point_total), capacity=MESH4K_CAPACITY,
            max_abs_diff=float(diff.max()), share_beyond_1e4=float((diff > 1e-4).double().mean()),
            pixels_differing=int((diff > 0).sum()),
            transmittance_max_abs=max_abs(out.transmittances, single.transmittances),
            count_mismatches=int((out.point_rendered_counts
                                  != single.point_rendered_counts).sum()),
            radii_equal=bool(torch.equal(out.radii, single.radii)),
            finite=bool(torch.isfinite(out.colors_rgb_2d).all()),
            image_mean=float(out.colors_rgb_2d.mean()))
        m = rec["mesh4k"]
        check(m["finite"] and m["radii_equal"] and m["share_beyond_1e4"] <= MESH4K_PIXEL_SHARE
              and int(single.tile_point_total) <= MESH4K_CAPACITY,
              f"the 4K slabs differ from the single-device render: {m}")
        del single, diff
    del scene, out
    torch.cuda.empty_cache()

    # (c) The (2, 2) sharded step on the bench scene's 4 orbit views.
    arrays = bench_scene_arrays()
    views = bench_views(T)[1:]
    with torch.no_grad():
        bench = T.GaussianScene.from_numpy(**arrays, device=dev)
        targets = torch.stack([
            T.render(bench, v, T.RenderOptions(tile_entry_capacity=spec["bench_capacity"])
                     ).colors_rgb_2d for v in views])
        del bench
    scene = T.GaussianScene.from_numpy(**train_start_arrays(arrays), device=dev)
    grid = make_mesh(STEP_MESH, ("data", "tiles"))
    options = T.RenderOptions(tile_entry_capacity=spec["step_capacity"])
    config = step_train_config(options, views)
    width, height = views[0].image_width, views[0].image_height
    step, _, h_pad = make_sharded_train_step(grid, width, height, scene.point_count, options,
                                             config.optimizer)
    cams = stack_cameras(views, device=dev)
    padded = torch.nn.functional.pad(targets, (0, 0, 0, 0, 0, h_pad - height))
    for kernel in kernels:  # the targets' renders are set-up, not the path
        kernel.launches = 0
    torch.cuda.synchronize()
    dist.barrier()
    start = time.perf_counter()
    got = step.loss_and_grads(scene, cams, padded)
    torch.cuda.synchronize()
    rec["step_gradients_seconds"] = time.perf_counter() - start
    rec["step_watermark"], rec["step_slab_capacity"] = int(got["max_total"]), step.capacity
    check(int(got["max_total"]) < step.capacity,
          f"a slab of the step overflowed: {int(got['max_total'])} >= {step.capacity}")
    if rank == 0:
        want = torch.load(out_dir / "reference.pt", weights_only=True)
        errors = {f: scaled_err(g, want["grads"][f].to(dev)) for f, g in got["grads"].items()}
        errors["grad_norm_sum"] = scaled_err(got["grad_norm"], want["grad_norm"].to(dev))
        rec["step"] = dict(loss=float(got["loss"]), loss_single=want["loss"],
                           loss_rel_err=abs(float(got["loss"]) - want["loss"]) / want["loss"],
                           scaled_err=errors, h_pad=h_pad)
        check(rec["step"]["loss_rel_err"] <= 2e-4 and max(errors.values()) <= GRAD_SCALED_ATOL,
              f"the sharded step differs from the single-device one: {rec['step']}")
    del got

    trainer = ShardedTrainer(scene, grid, width, height, config)
    dist.barrier()
    start = time.perf_counter()
    history = trainer.fit(cams, targets, 3)
    torch.cuda.synchronize()
    rec["fit_3_steps_seconds"] = time.perf_counter() - start
    rec["fit"] = dict(losses=[h["loss"] for h in history],
                      densify=[{k: h[k] for k in ("cloned", "split", "pruned", "point_count")}
                               for h in history if "point_count" in h],
                      tile_point_total=[int(h["tile_point_total"]) for h in history],
                      points=trainer.scene.point_count, digest=params_digest(trainer.scene))
    check(all(math.isfinite(x) for x in rec["fit"]["losses"]) and rec["fit"]["densify"],
          f"the sharded fit failed or ran no densify: {rec['fit']}")
    rec["launches"] = {k.entry: launches[k.entry] + k.launches for k in kernels}
    rec["wall_seconds"] = time.perf_counter() - begin
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec))


def slab_kernel_records(scene, view, slab, capacity, dev, tag) -> tuple[dict, dict]:
    """Kernels A, B and C on one slab of a tile-sharded frame (the camera
    shifted by the slab's first row; its own tile grid and capacity),
    each against its plain version (the tolerances of the full-size
    phases), timed beside it, with its bound. Returns the comparison record
    and the timings by kernel."""
    from gausplat_tpu_torch.ops.binning import make_point_orders
    from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD, RASTERIZE_FORWARD, rasterize_backward, rasterize_backward_torch,
        rasterize_forward, rasterize_forward_torch,
    )

    rows, ids, ranges, tcx, proj = raster_inputs(scene, view, capacity, True, dev, slab=slab)
    b_args, b_kw = expand_args(proj), dict(tile_count_x=tcx, capacity=capacity)
    b_rec = compare_expand(b_args, capacity, tcx)
    check(all(b_rec["bit_identical"]), f"{tag}: expansion kernel differs: {b_rec}")
    a_rec, a_out = compare_forward(rows, ids, ranges, tcx)
    check(forward_close_at_full_size(a_rec), f"{tag}: forward kernel differs: {a_rec}")
    grad = torch.randn((slab[1], view.image_width, 3), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(17))
    c_args = backward_inputs(rows, ids, ranges, tcx, grad)
    c_rec, _ = compare_backward(c_args, tcx, 256)
    check(backward_close(c_rec), f"{tag}: backward kernel differs: {c_rec}")
    blended = blended_pairs(rows, ids, ranges, a_out[2], tcx)
    runs = {
        "rasterize_forward": (lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx),
                              lambda: rasterize_forward_torch(rows, ids, ranges,
                                                              tile_count_x=tcx),
                              RASTERIZE_FORWARD,
                              bound(entry_bytes(rows, ids, ranges) + nbytes(*a_out),
                                    blended * PAIR_FLOPS_MIN),
                              max(a_rec["image_max_abs"], a_rec["transmittance_max_abs"])),
        "expand_point_orders": (lambda: fused_point_orders(*b_args, **b_kw),
                                lambda: make_point_orders(*b_args, **b_kw), EXPAND,
                                bound(nbytes(*b_args) + b_rec["out_bytes"], 0.0),
                                b_rec["max_abs"]),
        "rasterize_backward": (lambda: rasterize_backward(*c_args, tile_count_x=tcx),
                               lambda: rasterize_backward_torch(*c_args, tile_count_x=tcx),
                               RASTERIZE_BACKWARD,
                               bound(entry_bytes(rows, ids, ranges) + nbytes(*c_args[3:])
                                     + 9 * c_rec["valid_slots"] * 4, blended * PAIR_FLOPS_MIN),
                               c_rec["max_abs"]),
    }
    timings = {}
    for name, (run, plain, kernel, bnd, err) in runs.items():
        timings[name] = dict(ms=cuda_ms(run)[0], plain_ms=cuda_ms(plain)[0],
                             device_ms=kernel_device_ms(run, kernel)["device_ms"],
                             bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                             max_abs_err=err, kernel=kernel)
    rec = dict(slab=list(slab), capacity=capacity, entries=int(ranges[:, 1].max()),
               blended_pairs=blended, rasterize_forward=a_rec, expand_point_orders=b_rec,
               rasterize_backward=c_rec,
               valid_rows=min(slab[1], view.image_height - slab[0]))
    return rec, timings


def phase_parallel(ctx):
    """Multi-device render and training on torch.distributed: (a) one NCCL
    rank, (b) the 4K frame in 4 gloo slabs, (c) the (2, 2) sharded step and
    trainer, then A, B and C on slab 0 and the last slab of the step."""
    import tempfile

    import torch.distributed as dist

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT
    from gausplat_tpu_torch.parallel import make_mesh, render_tile_sharded
    from gausplat_tpu_torch.parallel.render import _shard_capacity, slab_rows
    from gausplat_tpu_torch.testing import free_port, spawn_ranks

    dev, arrays = ctx["device"], ctx["arrays"]
    kernels = all_kernels()
    result = {}

    # (a) One rank over NCCL: the tile-sharded render of the bench view is
    # the single render, bit for bit (the shift is 0), and so are its
    # gradients of mean(image ** 2).
    view = ctx["views"][0]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1,), ("tiles",))
        runs = {}
        for kernel in kernels:
            kernel.launches = 0
        for name in ("sharded", "single"):
            scene = T.GaussianScene.from_numpy(**arrays, device=dev)
            ref = torch.zeros(scene.point_count, device=dev, requires_grad=True)
            out = (render_tile_sharded(scene, view, mesh, "tiles", ctx["options"], ref)
                   if name == "sharded" else T.render(scene, view, ctx["options"], ref))
            torch.mean(out.colors_rgb_2d ** 2).backward()
            runs[name] = (out, {n: p.grad for n, p in scene.named_parameters()}, ref.grad)
            if name == "sharded":
                nccl_launches = {k.entry: k.launches for k in kernels}
        (got, got_grads, got_norm), (want, want_grads, want_norm) = runs["sharded"], runs["single"]
        same = {field: bool(torch.equal(a, b)) for field, a, b in zip(got._fields, got, want)}
        grads_same = {n: bool(torch.equal(g, want_grads[n])) for n, g in got_grads.items()}
        grads_same["norm"] = bool(torch.equal(got_norm, want_norm))
        result["nccl_world_1"] = dict(backend=dist.get_backend(), outputs_bit_identical=same,
                                      grads_bit_identical=grads_same, launches=nccl_launches)
        check(all(same.values()), f"one NCCL rank differs from render: {same}")
        check(all(grads_same.values()), f"one NCCL rank's gradients differ: {grads_same}")
        del runs, got, want, got_grads, want_grads, got_norm, want_norm, out, scene, ref
    finally:
        dist.destroy_process_group()

    # (c)'s single-device reference: the loss and gradients of the 4 orbit
    # views' mean photometric loss, on the card, before the ranks start.
    views = ctx["views"][1:]
    targets = ctx["targets"][1:]
    scene = T.GaussianScene.from_numpy(**train_start_arrays(arrays), device=dev)
    single_options = T.calibrate_options(scene, views)
    # Twice the calibrated budget, so that each of the two slabs gets it whole.
    step_capacity = 2 * single_options.tile_entry_capacity
    ref = torch.zeros(scene.point_count, device=dev, requires_grad=True)
    loss = sum(TT.photometric_loss(T.render(scene, v, single_options, ref).colors_rgb_2d, t)
               for v, t in zip(views, targets)) / len(views)
    params = list(scene.named_parameters())
    *grads, grad_norm = torch.autograd.grad(loss, [p for _, p in params] + [ref])
    reference = dict(loss=float(loss.detach()), grad_norm=grad_norm.cpu(),
                     grads={n: g.cpu() for (n, _), g in zip(params, grads)})
    del loss, grads, grad_norm, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) and (c) in four ranks on this card over gloo: NCCL refuses two
    # ranks on one GPU. The libraries are built (phase env), so no rank builds.
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(reference, pathlib.Path(tmp) / "reference.pt")
        emit("parallel_ranks_start", 0.0, ranks=4, backend="gloo", device="cuda:0")
        start = time.perf_counter()
        spec = dict(device=str(dev), bench_capacity=ctx["capacity"],
                    step_capacity=step_capacity)
        spawn_ranks(parallel_worker, 4, tmp, spec,
                    backend="gloo", timeout_s=600.0)
        spawn_seconds = time.perf_counter() - start
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(4)]
    digests = {r["fit"]["digest"] for r in ranks}
    check(len(digests) == 1, f"the ranks' scenes differ after the densify event: {digests}")
    check(all(r["backend"] == "gloo" for r in ranks), "a rank is not on gloo")
    launches = {k.entry: nccl_launches[k.entry] + sum(r["launches"][k.entry] for r in ranks)
                for k in kernels}
    path = ("gs_expand_point_orders", "gs_rasterize_forward", "gs_rasterize_backward")
    check(all(launches[k] > 0 for k in path), f"a kernel of the parallel path never ran: "
          f"{launches}")

    # A, B and C on slab 0 and on the last slab (its rows past 1080 padded)
    # of the step's first view, alone on the card.
    h_local, h_pad = slab_rows(views[0].image_height, STEP_MESH[1])
    capacity = _shard_capacity(step_capacity, STEP_MESH[1], 256)
    slabs = {}
    for tag, index in (("slab0", 0), ("last_slab", STEP_MESH[1] - 1)):
        rec, timings = slab_kernel_records(scene, views[0], (index * h_local, h_local),
                                           capacity, dev, tag)
        slabs[tag] = rec
        for name, t in timings.items():
            kernel = t.pop("kernel")
            ctx["kernels"].append(dict(
                name=f"{name}@{tag}", route="cuda",
                source=f"gausplat_tpu_torch/csrc/{kernel.source.name}",
                replaces=dict(rasterize_forward="gausplat_tpu/ops/rasterize.py:409",
                              expand_point_orders="gausplat_tpu/ops/expand.py:121",
                              rasterize_backward="gausplat_tpu/ops/rasterize.py:604")[name],
                path=(f"parallel: {tag} ({index * h_local}-{(index + 1) * h_local - 1} of "
                      f"{h_pad} rows) of the (2, 2) sharded step, 1920 x {h_local}"),
                launches=launches[kernel.entry], library_ms=None, **t))

    rank0 = ranks[0]
    return dict(
        card=ctx["card"], backend_ranks="gloo",
        **result, mesh4k=rank0["mesh4k"], step=rank0["step"], fit=rank0["fit"],
        bins=[r["bins"] for r in ranks], slab_watermarks=[r["slab_watermark"] for r in ranks],
        slab_capacity=rank0["slab_capacity"],
        step_watermarks=[r["step_watermark"] for r in ranks],
        step_slab_capacity=rank0["step_slab_capacity"], launches=launches,
        rank_wall_seconds=[r["wall_seconds"] for r in ranks],
        rank_render_4k_seconds=[r["render_4k_seconds"] for r in ranks],
        rank_step_gradients_seconds=[r["step_gradients_seconds"] for r in ranks],
        rank_fit_3_steps_seconds=[r["fit_3_steps_seconds"] for r in ranks],
        wall_note="four processes share one card: these are not scaling numbers",
        spawn_seconds=spawn_seconds, slabs=slabs,
    )


# --- phase 12: the user-facing tools --------------------------------------------

#: The JAX package's record of the same lego recipe (read as data).
LEGO_RECORD = ROOT / "train_long_r05_lego.json"
LEGO_STEPS = 2_000
TOY_STEPS = 400


def counted(fn):
    """Run ``fn`` with every kernel's count set to 0 just before and read
    just after; returns its result, the launches by entry point and the
    seconds."""
    kernels = all_kernels()
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, {k.entry: k.launches for k in kernels}, time.perf_counter() - start


def phase_tools(ctx):
    """(a) the native PLY codec against numpy on the serving scene, (b)
    ``render_ply`` at 1080p against the in-process render, (c) the toy fit,
    (d) 2,000 steps of the lego long fit beside the JAX record, then A, B
    and C at its shapes, (e) ``profiling.trace`` of one render."""
    import dataclasses
    import tempfile

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.examples.fit_toy_scene import fit_toy_scene
    from gausplat_tpu_torch.scene import ply
    from gausplat_tpu_torch.scripts import render_ply as RP
    from gausplat_tpu_torch.scripts.train_long import long_fit_setup, run_long_fit
    from gausplat_tpu_torch.utils import native, profiling

    dev, scene = ctx["device"], ctx["scene"]
    millions = scene.point_count / 1e6
    out = {}
    with tempfile.TemporaryDirectory(prefix="gausplat_tools_") as tmp:
        tmp = pathlib.Path(tmp)

        # (a) The codec: the payload through the C++ library and through
        # numpy (the same bytes, the arrays bit for bit), then the PLY
        # round trip through the user's calls (native, as it is available).
        check(native.available(), "no host C++ compiler: the native codec is unavailable")
        start = time.perf_counter()
        native.encode_payload(*(np.zeros((1, w), np.float32) for w in native.WIDTHS))
        codec = dict(build_or_load_seconds=time.perf_counter() - start)
        arrays = [getattr(scene, f).detach().cpu().numpy() for f in ply.FIELDS]
        payloads = {}
        for name, encode, decode in (
                ("native", native.encode_payload, native.decode_payload),
                ("numpy", ply.encode_payload_numpy, ply.decode_payload_numpy)):
            start = time.perf_counter()
            payloads[name] = encode(*arrays)
            encode_s = time.perf_counter() - start
            start = time.perf_counter()
            back = decode(payloads[name], scene.point_count)
            decode_s = time.perf_counter() - start
            for f, got, want in zip(ply.FIELDS, back, arrays):
                check(np.array_equal(got.view(np.int32), want.view(np.int32)),
                      f"{name} decode of {f} is not bit for bit")
            codec[name] = dict(encode_s_per_million=encode_s / millions,
                               decode_s_per_million=decode_s / millions)
        check(payloads["native"] == payloads["numpy"], "the native payload differs from numpy's")
        start = time.perf_counter()
        blob = T.encode_polygon(scene)
        encode_s = time.perf_counter() - start
        start = time.perf_counter()
        restored = T.decode_polygon(blob, device=dev)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - start
        check(blob.endswith(payloads["native"]), "encode_polygon's payload is not the codec's")
        for f in ply.FIELDS:
            check(torch.equal(getattr(restored, f).view(torch.int32),
                              getattr(scene, f).detach().view(torch.int32)),
                  f"the PLY round trip changed {f}")
        codec.update(points=scene.point_count, ply_bytes=len(blob),
                     polygon_encode_s_per_million=encode_s / millions,
                     polygon_decode_s_per_million=decode_s / millions)
        out["codec"] = codec

        # (b) render_ply at 1920x1080 on that PLY, A and B launched once each.
        ply_path, png = tmp / "scene.3dgs.ply", tmp / "out.png"
        ply_path.write_bytes(blob)
        argv = [str(ply_path), str(png), "--width", "1920", "--height", "1080", "--device", "cuda"]
        _, launches, cli_seconds = counted(lambda: RP.main(argv))
        check(launches["gs_rasterize_forward"] == 1 and launches["gs_expand_point_orders"] == 1
              and launches["gs_rasterize_backward"] == 0,
              f"render_ply launched {launches}, not A and B once each")
        image = RP.decode_png(png.read_bytes())
        view = RP.orbit_view(restored.positions.detach().cpu().numpy(), 1920, 1080)
        with torch.no_grad():
            rendered = T.render(restored, view, T.RenderOptions())
        want = RP.to_u8(rendered.colors_rgb_2d)
        check(image.shape == (1080, 1920, 3) and np.array_equal(image, want),
              "render_ply's PNG differs from the in-process render of its view")
        out["render_ply"] = dict(seconds=cli_seconds, launches=launches,
                                 png_bytes=png.stat().st_size,
                                 tile_point_total=int(rendered.tile_point_total),
                                 image_mean=float(image.mean()))

        # (c) The toy fit: finite, improving, a lossless PLY round trip.
        toy, launches, toy_seconds = counted(
            lambda: fit_toy_scene(TOY_STEPS, device=dev, log=lambda line: None))
        check(all(math.isfinite(x) for x in toy["losses"]), "toy fit: a non-finite loss")
        check(toy["last"]["psnr"] > toy["first"]["psnr"], f"toy fit did not improve: {toy}")
        check(toy["round_trip_identical"], "toy fit: the PLY round trip is not bit for bit")
        path = ("gs_expand_point_orders", "gs_rasterize_forward", "gs_rasterize_backward")
        check(all(launches[k] > 0 for k in path), f"toy fit: a kernel never ran: {launches}")
        out["toy_fit"] = dict(
            seconds=toy_seconds, launches=launches, first=toy["first"], last=toy["last"],
            points_start=toy["points_start"], points_end=toy["points_end"],
            ply_bytes=toy["ply_bytes"], round_trip_psnr=toy["round_trip_psnr"])

        # (d) The lego recipe for 2,000 steps beside the JAX record.
        start = time.perf_counter()
        setup = long_fit_setup(True, True, dev, iterations=LEGO_STEPS)
        setup_seconds = time.perf_counter() - start
        fit, launches, lego_seconds = counted(lambda: run_long_fit(
            setup, LEGO_STEPS, tmp / "lego.json", log=lambda line: None))
        records = fit["run"]["records"]
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["mean_loss"]) for r in records),
              "lego fit: a non-finite loss")
        check(records[-1]["mean_loss"] < records[0]["mean_loss"],
              "lego fit: the last chunk's mean loss is not below the first's")
        check(all(launches[k] > 0 for k in path), f"lego fit: a kernel never ran: {launches}")
        reference = {r["step"]: r for r in json.loads(LEGO_RECORD.read_text())}
        curve = [dict(step=r["step"], loss=r["loss"], psnr=r["psnr"], points=r["points"],
                      ref_loss=reference[r["step"]]["loss"], ref_psnr=reference[r["step"]]["psnr"],
                      ref_points=reference[r["step"]]["points"], ms_per_step=r["ms_per_step"],
                      max_total=r["max_total"], capacity=r["capacity"]) for r in records]
        trainer = fit["trainer"]
        out["lego_fit"] = dict(
            setup_seconds=setup_seconds, seconds=lego_seconds, launches=launches, curve=curve,
            ms_per_step=[r["ms_per_step"] for r in records],
            peak_memory_gb=fit["run"].get("peak_memory_gb"),
            max_total=max(r["max_total"] for r in records),
            capacity_final=trainer._entry_capacity,
            capacity_growths=fit["run"]["capacity_growths"],
            points_at_end=trainer.scene.point_count, record_points_at_end=reference[LEGO_STEPS]["points"],
            psnr_at_end=records[-1]["psnr"], record_psnr_at_end=reference[LEGO_STEPS]["psnr"])

        # A, B and C at the lego fit's shapes (its scene after the fit, view 0).
        lego_view = setup["views"][0]
        rec, timings = slab_kernel_records(trainer.scene, lego_view, (0, lego_view.image_height),
                                           trainer._entry_capacity, dev, "lego_fit")
        out["lego_fit"]["kernels"] = rec
        for name, t in timings.items():
            kernel = t.pop("kernel")
            ctx["kernels"].append(dict(
                name=f"{name}@lego_fit", route="cuda",
                source=f"gausplat_tpu_torch/csrc/{kernel.source.name}",
                replaces=dict(rasterize_forward="gausplat_tpu/ops/rasterize.py:409",
                              expand_point_orders="gausplat_tpu/ops/expand.py:121",
                              rasterize_backward="gausplat_tpu/ops/rasterize.py:604")[name],
                path=(f"tools (d): view 0 of the lego fit after {LEGO_STEPS} steps, "
                      f"{trainer.scene.point_count} points, 800 x 800"),
                launches=launches[kernel.entry], library_ms=None, **t))

        # A lego step with no host event (after the counts were read): its
        # time and where it goes.
        trainer.config = dataclasses.replace(trainer.config, densify_until=0,
                                             overflow_check_interval=10**9)
        target = setup["targets"][0]
        step_ms, step_all = cuda_ms(lambda: trainer.train_step(lego_view, target))
        try:
            breakdown = profile_device_time(lambda: trainer.train_step(lego_view, target))
        except RuntimeError as e:  # the profiler is a measurement, not the path
            breakdown = dict(device_busy_ms=f"not measured ({e})")
        out["lego_fit"].update(step_ms=step_ms, step_ms_all=step_all, step_profile=breakdown)

        # (e) A Chrome trace of one render holds the stages and the kernels.
        trace_dir = tmp / "trace"
        with torch.no_grad(), profiling.trace(str(trace_dir)):
            with profiling.stage("gausplat.tools.render"):
                traced = T.render(scene, ctx["views"][0], ctx["options"])
            with profiling.stage("gausplat.tools.readback"):
                float(traced.colors_rgb_2d.mean())
        (trace_file,) = trace_dir.glob("*.pt.trace.json")
        names = {e.get("name", "") for e in json.loads(trace_file.read_text())["traceEvents"]}
        wanted = ["gausplat.tools.render", "gausplat.tools.readback",
                  *DEVICE_KERNELS["expand.cu"][:2], *DEVICE_KERNELS["rasterize_forward.cu"]]
        missing = [w for w in wanted if not any(w in n for n in names)]
        check(not missing, f"the trace lacks {missing}")
        out["trace"] = dict(events=len(names), found=wanted,
                            trace_bytes=trace_file.stat().st_size)
    return dict(card=ctx["card"], **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import gausplat_tpu_torch as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    ctx = dict(device=device, card=nvidia_smi("name,power.limit"))

    phases = [("env", phase_env), ("expand", phase_expand), ("rasterize", phase_rasterize),
              ("fixture", phase_fixture), ("main_path", phase_main_path),
              ("rasterize_backward", phase_rasterize_backward),
              ("adversarial", phase_adversarial), ("grad", phase_grad),
              ("train", phase_train), ("colmap_bf16", phase_colmap_bf16),
              ("parallel", phase_parallel), ("tools", phase_tools)]
    for name, phase in phases:
        start = time.perf_counter()
        if name == "expand":
            arrays = bench_scene_arrays()
            ctx["arrays"] = arrays
            ctx["scene"] = T.GaussianScene.from_numpy(**arrays, device=device)
            ctx["views"] = bench_views(T)
            ctx["options"] = T.calibrate_options(ctx["scene"], ctx["views"])
            ctx["capacity"] = ctx["options"].tile_entry_capacity
        try:
            record = phase(ctx)
        except Exception:
            traceback.print_exc()
            emit(name, time.perf_counter() - start, ok=False)
            return 1
        emit(name, time.perf_counter() - start, ok=True, **record)

    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"kernels": ctx["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
