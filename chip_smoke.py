"""Drive the PyTorch + CUDA port's forward render on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It imports torch, numpy and ``gausplat_tpu_torch`` only (no JAX), builds
the hand-written kernels from ``gausplat_tpu_torch/csrc`` into
``build/gausplat_tpu_torch/``, and runs five phases, each printing one
JSON line:

1. env: versions, the card, the kernel build;
2. expand: the expansion kernel against its plain version, bit for bit,
   on small workloads and on the full-size projection output (and the
   CUDA projection's integer outputs against the CPU's);
3. rasterize: the forward kernel against its plain version on a small
   scene (image / transmittance atol 1e-4, counts exact) and at full size
   (image within 1e-3, >= 99.99% of rendered counts equal), plus the
   count flips of an FMA-contracting build of the same source;
4. fixture: the CUDA render against outputs stored by the JAX package
   (``tests/data/torch_xcheck.npz``), atol 1e-4, integers exact;
5. main_path: a 1M-point scene at 1920x1080 served for 5 views through
   ``render`` and once through ``render_views``, with both kernels'
   launch counts, then CUDA-event timings of the render and of each
   kernel beside its plain version, and a torch.profiler breakdown of
   the render's device time by kernel.

Then it prints the card's name and power limit, one JSON line of
per-kernel results, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero without the last line; so does a machine without
a CUDA device.
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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# --- inputs (numpy recipes from a seed) ----------------------------------------


def expand_workload(p, seed, vis_frac=0.8, max_wh=6):
    """The workloads of tests/test_expand.py::_workload."""
    rng = np.random.default_rng(seed)
    counts_w = rng.integers(1, max_wh, p).astype(np.int32)
    counts_h = rng.integers(1, max_wh, p).astype(np.int32)
    vis = rng.random(p) < vis_frac
    tx_min = rng.integers(0, 100, p).astype(np.int32)
    ty_min = rng.integers(0, 50, p).astype(np.int32)
    counts = np.where(vis, counts_w * counts_h, 0).astype(np.int32)
    depths = (0.3 + rng.random(p) * 1000).astype(np.float32)
    return depths, tx_min + counts_w, tx_min, ty_min, counts


def expand_workloads():
    yield "p1000_vis0.8", expand_workload(1000, 0, 0.8), 1 << 13
    yield "p1000_vis0.05", expand_workload(1000, 1, 0.05), 1 << 13
    yield "p257_vis1", expand_workload(257, 2, 1.0), 1 << 12
    yield "p64_vis0.5", expand_workload(64, 3, 0.5), 1 << 12
    over = expand_workload(2000, 7, 1.0, max_wh=8)
    yield "overflow", over, (int(over[4].sum()) // 2) // 128 * 128
    rng = np.random.default_rng(9)
    zeros = np.zeros(300, np.int32)
    yield "all_invisible", ((rng.random(300) + 0.5).astype(np.float32),) + (zeros,) * 4, 1 << 12
    counts = np.zeros(10, np.int32)
    counts[4] = 1000
    giant = (np.full(10, 2.0, np.float32), np.full(10, 25, np.int32),
             np.full(10, 5, np.int32), np.full(10, 3, np.int32), counts)
    yield "one_giant_span", giant, 1 << 11


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


# --- phases ---------------------------------------------------------------------


def phase_env(ctx):
    from gausplat_tpu_torch.ops.expand import EXPAND
    from gausplat_tpu_torch.ops.rasterize import RASTERIZE_FORWARD
    from gausplat_tpu_torch.utils.kernels import find_nvcc

    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    release = [line for line in version.splitlines() if "release" in line]
    try:
        import triton  # noqa: F401  (reported only; the port does not use it)

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    builds = {}
    for kernel in (EXPAND, RASTERIZE_FORWARD):
        kernel.load()
        builds[kernel.source.name] = round(kernel.build_seconds, 3)
    return dict(
        python=sys.version.split()[0], torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=release[0].strip() if release else version,
        triton=triton_version,
        device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(),
        nvidia_smi=ctx["card"], build_seconds=builds,
    )


def phase_expand(ctx):
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.binning import make_point_orders
    from gausplat_tpu_torch.ops.expand import fused_point_orders
    from gausplat_tpu_torch.ops.projection import Camera, project_gaussians

    dev = ctx["device"]
    out = {}

    def compare(args, capacity, tile_count_x):
        got = fused_point_orders(*args, tile_count_x=tile_count_x, capacity=capacity)
        ref = make_point_orders(*args, tile_count_x=tile_count_x, capacity=capacity)
        torch.cuda.synchronize()
        ctx["kernel_b_err"] = max(max_abs(a, b) for a, b in zip(got, ref))
        return [bool(torch.equal(a, b)) for a, b in zip(got, ref)]

    for name, arrays, capacity in expand_workloads():
        args = [torch.as_tensor(a, device=dev) for a in arrays]
        same = compare(args, capacity, 120)
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
    args = (proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min, proj.tile_counts)
    capacity = ctx["capacity"]
    same = compare(args, capacity, tcx)
    out["full_size"] = same
    out["full_size_max_abs_diff"] = ctx["kernel_b_err"]
    check(all(same), f"expansion kernel differs from its plain version at full size: {same}")
    ctx["proj"], ctx["tcx"], ctx["tcy"] = proj, tcx, tcy
    return dict(bit_identical=out, capacity=capacity,
                cuda_vs_cpu_projection_int_flips=flips,
                cuda_vs_cpu_projection_max_abs=float_err)


def phase_rasterize(ctx):
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.binning import bin_gaussians
    from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_FORWARD, pack_point_data, rasterize_forward, rasterize_forward_torch,
    )
    from gausplat_tpu_torch.utils.kernels import NVCC_FLAGS

    dev = ctx["device"]

    def inputs(scene, view, capacity, tight):
        tcx, tcy = -(-view.image_width // 16), -(-view.image_height // 16)
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
            Camera.from_view(view, device=dev), sh_degree=3,
            tile_count_x=tcx, tile_count_y=tcy, opacities=scene.opacities,
            tight_culling=tight,
        )
        binning = bin_gaussians(
            proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity,
        )
        rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
        return rows, binning.point_indices, binning.tile_ranges, tcx

    results = {}
    with torch.no_grad():
        small = T.GaussianScene.from_numpy(**small_scene_arrays(), device=dev)
        small_view = T.View(
            field_of_view_x=1.0, field_of_view_y=0.8, image_height=40, image_width=56,
            view_position=[0.0, 0.0, -4.0],
            view_transform=T.View.transform(np.eye(3), [0.0, 0.0, 4.0]),
        )
        for tight in (False, True):
            rows, ids, ranges, tcx = inputs(small, small_view, 1024, tight)
            got = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
            ref = rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx, block_size=64)
            torch.cuda.synchronize()
            rec = dict(image_max_abs=max_abs(got[0], ref[0]),
                       transmittance_max_abs=max_abs(got[1], ref[1]),
                       count_mismatches=int((got[2] != ref[2]).sum()))
            results[f"small_tight{int(tight)}"] = rec
            check(rec["image_max_abs"] <= 1e-4 and rec["transmittance_max_abs"] <= 1e-4
                  and rec["count_mismatches"] == 0,
                  f"forward kernel differs from its plain version on the small scene: {rec}")

        rows, ids, ranges, tcx = inputs(ctx["scene"], ctx["views"][0], ctx["capacity"], True)
        got = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
        ref = rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx)
        torch.cuda.synchronize()
        equal_counts = float((got[2] == ref[2]).double().mean())
        full = dict(image_max_abs=max_abs(got[0], ref[0]),
                    transmittance_max_abs=max_abs(got[1], ref[1]),
                    count_equal_fraction=equal_counts,
                    count_mismatches=int((got[2] != ref[2]).sum()))
        results["full_size"] = full
        check(full["image_max_abs"] <= 1e-3 and equal_counts >= 0.9999,
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
    ctx["kernel_a_err"] = full["image_max_abs"]
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
        sh_degree, tight, capacity, block = (int(x) for x in g["options"])
        options = T.RenderOptions(
            backend="cuda", colors_sh_degree_max=sh_degree, tight_culling=bool(tight),
            tile_entry_capacity=capacity, block_size=block,
        )
        got = T.render(scene, view, options)
        rec = dict(
            image_max_abs=max_abs(got.colors_rgb_2d.cpu(), torch.as_tensor(g["image"])),
            transmittance_max_abs=max_abs(got.transmittances.cpu(),
                                          torch.as_tensor(g["transmittance"])),
            count_mismatches=int((got.point_rendered_counts.cpu().numpy() != g["counts"]).sum()),
            radii_mismatches=int((got.radii.cpu().numpy() != g["radii"]).sum()),
            total=int(got.tile_point_total), jax_total=int(g["total"]),
        )
        out[case] = rec
        check(rec["image_max_abs"] <= 1e-4 and rec["transmittance_max_abs"] <= 1e-4
              and rec["count_mismatches"] == 0 and rec["radii_mismatches"] == 0
              and rec["total"] == rec["jax_total"],
              f"CUDA render differs from the JAX fixture on {case}: {rec}")
    return out


def phase_main_path(ctx):
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
    proj = ctx["proj"]
    expand_args = (proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
                   proj.tile_counts)
    kw = dict(tile_count_x=ctx["tcx"], capacity=capacity)
    b_ms, b_all = cuda_ms(lambda: fused_point_orders(*expand_args, **kw))
    b_plain_ms, b_plain_all = cuda_ms(lambda: make_point_orders(*expand_args, **kw))
    rows, ids, ranges, tcx = ctx["raster_inputs"]
    a_ms, a_all = cuda_ms(lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx))
    a_plain_ms, a_plain_all = cuda_ms(
        lambda: rasterize_forward_torch(rows, ids, ranges, tile_count_x=tcx)
    )
    try:
        breakdown = profile_device_time(lambda: T.render(scene, view, options))
    except RuntimeError as e:  # the profiler is a measurement, not the path
        breakdown = dict(device_busy_ms=f"not measured ({e})")
    ctx["kernels"] = [
        dict(name="rasterize_forward", route="cuda",
             source="gausplat_tpu_torch/csrc/rasterize_forward.cu",
             replaces="gausplat_tpu/ops/rasterize.py:409",
             launches=launches["rasterize_forward.cu"], max_abs_err=ctx["kernel_a_err"],
             ms=a_ms, plain_ms=a_plain_ms),
        dict(name="expand_point_orders", route="cuda",
             source="gausplat_tpu_torch/csrc/expand.cu",
             replaces="gausplat_tpu/ops/expand.py:121",
             launches=launches["expand.cu"], max_abs_err=ctx["kernel_b_err"],
             ms=b_ms, plain_ms=b_plain_ms),
    ]
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
        expand_ms=b_ms, expand_ms_all=b_all,
        expand_plain_ms=b_plain_ms, expand_plain_ms_all=b_plain_all,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        render_profile=breakdown,
    )


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
              ("fixture", phase_fixture), ("main_path", phase_main_path)]
    for name, phase in phases:
        start = time.perf_counter()
        if name == "expand":
            arrays = bench_scene_arrays()
            ctx["arrays"] = arrays
            ctx["scene"] = T.GaussianScene.from_numpy(**arrays, device=device)
            ctx["views"] = [orbit_view(T, 0.0, 0.0), orbit_view(T, 0.1, 0.0),
                            orbit_view(T, -0.1, 0.0), orbit_view(T, 0.0, 0.1),
                            orbit_view(T, 0.0, -0.1)]
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
