"""Inputs that stress the expansion and rasterize kernels, and the
comparison of packed gradient rows, for tests and ``chip_smoke.py``.

numpy and torch only: the card tests and the smoke run use it where neither
JAX nor pytest is installed.
"""

import numpy as np

from .ops.expand import CHUNK_POINTS


def expand_workload(p, seed, vis_frac=0.8, max_wh=6, y_range=(0, 50)):
    """tests/test_expand.py::_workload (tile rows from ``y_range``): the
    expansion's per-point inputs ``(depths, tile_x_max, tile_x_min,
    tile_y_min, tile_counts)``."""
    rng = np.random.default_rng(seed)
    counts_w = rng.integers(1, max_wh, p).astype(np.int32)
    counts_h = rng.integers(1, max_wh, p).astype(np.int32)
    vis = rng.random(p) < vis_frac
    tx_min = rng.integers(0, 100, p).astype(np.int32)
    ty_min = rng.integers(*y_range, p).astype(np.int32)
    counts = np.where(vis, counts_w * counts_h, 0).astype(np.int32)
    depths = (0.3 + rng.random(p) * 1000).astype(np.float32)
    return depths, tx_min + counts_w, tx_min, ty_min, counts


def _cut(args, point):
    """A capacity that ends inside the run of point ``point``."""
    ends = np.cumsum(args[4].astype(np.int64))
    return int(ends[point] - args[4][point] // 2 - 1)


def _overflow():
    args = expand_workload(2000, 7, 1.0, max_wh=8)
    return args, (int(args[4].sum()) // 2) // 128 * 128, 120


def _all_invisible():
    rng = np.random.default_rng(9)
    z = np.zeros(300, np.int32)
    return ((rng.random(300) + 0.5).astype(np.float32), z, z, z, z), 1 << 12, 120


def _giant_span():
    counts = np.zeros(10, np.int32)
    counts[4] = 1000
    return (np.full(10, 2.0, np.float32), np.full(10, 25, np.int32),
            np.full(10, 5, np.int32), np.full(10, 3, np.int32), counts), 1 << 11, 120


def _long_run_among_empty():
    """One 48x25-tile point (1,200 slots, more than a CTA's 256 threads
    cover in one stride) among 4,999 points that touch no tile, in the
    second chunk."""
    p, k = 5000, CHUNK_POINTS + 700
    counts = np.zeros(p, np.int32)
    counts[k] = 48 * 25
    x_min, y_min = np.full(p, 30, np.int32), np.full(p, 7, np.int32)
    return (np.linspace(0.5, 900.0, p).astype(np.float32), x_min + 48, x_min, y_min,
            counts), 1 << 11, 120


def _chunks_cut(at_chunk):
    """P = 3K + 5 for chunks of K points, cut inside a run in the middle of
    the second chunk (the third and fourth start past capacity), or exactly
    at the third chunk's first slot."""
    args = expand_workload(3 * CHUNK_POINTS + 5, 13, 0.8)
    if at_chunk:
        return args, int(args[4][:2 * CHUNK_POINTS].astype(np.int64).sum()), 120
    return args, _cut(args, CHUNK_POINTS + CHUNK_POINTS // 2), 120


def _high_tiles(cut):
    """Tile indices past 32768 (sign bit of the u32 key set): 256 tiles a
    row, rows 100-253, so both halves occur; truncated or not."""
    args = expand_workload(CHUNK_POINTS + 1000, 17, 0.9, y_range=(100, 249))
    return args, (_cut(args, CHUNK_POINTS + 300) if cut else 1 << 15), 256


#: The expansion's workloads (those of tests/test_expand.py, then the chunk
#: edges of ``csrc/expand.cu``): name -> () -> (arrays, capacity, tile_count_x).
EXPAND_WORKLOADS = {
    "p1000_vis0.8": lambda: (expand_workload(1000, 0, 0.8), 1 << 13, 120),
    "p1000_vis0.05": lambda: (expand_workload(1000, 1, 0.05), 1 << 13, 120),
    "p257_vis1": lambda: (expand_workload(257, 2, 1.0), 1 << 12, 120),
    "p64_vis0.5": lambda: (expand_workload(64, 3, 0.5), 1 << 12, 120),
    "overflow": _overflow,
    "all_invisible": _all_invisible,
    "one_giant_span": _giant_span,
    "p_chunk_minus_1": lambda: (expand_workload(CHUNK_POINTS - 1, 10), 1 << 15, 120),
    "p_chunk": lambda: (expand_workload(CHUNK_POINTS, 11), 1 << 15, 120),
    "p_chunk_plus_1": lambda: (expand_workload(CHUNK_POINTS + 1, 12), 1 << 15, 120),
    "p_3chunks_plus_5": lambda: (expand_workload(3 * CHUNK_POINTS + 5, 13), 1 << 16, 120),
    "chunks_cut_mid_chunk": lambda: _chunks_cut(False),
    "chunks_cut_at_chunk": lambda: _chunks_cut(True),
    "p0": lambda: ((np.zeros(0, np.float32),) + (np.zeros(0, np.int32),) * 4, 256, 120),
    "long_run_among_empty": _long_run_among_empty,
    "high_tiles": lambda: _high_tiles(False),
    "high_tiles_cut": lambda: _high_tiles(True),
}


def grazing_position(cxx, cxy, cyy, opacity, pixel, axis, sign, slack):
    """An entry position that puts ``pixel`` at the x (``axis`` 0) or y
    (``axis`` 1) extreme of the entry's alpha = 1/255 ellipse, pulled
    ``slack`` (relative) inside it: the pixel blends, and lies on the edge
    of any box around the ellipse."""
    q_max = 2.0 * np.log(opacity / np.float64(np.float32(1.0 / 255.0)))
    det = cxx * cyy - cxy * cxy
    if axis == 0:
        d = np.sqrt(q_max / (cyy * det)) * np.array([cyy, -cxy])
    else:
        d = np.sqrt(q_max / (cxx * det)) * np.array([-cxy, cxx])
    return tuple(np.asarray(pixel, np.float64) - sign * (1.0 - slack) * d)


def adversarial_entries(seed=0):
    """Entry rows that stress the rasterizers' footprint skip, and every one
    of them binned into every tile of a 64x48 image, in order.

    Near-singular conics, opacities at 1/255 (1 +- 1e-6) and above 252/255,
    huge and sub-pixel ellipses, positions on tile and strip edges, conics
    that are not positive definite, and NaN / inf values. Opaque entries
    are sub-pixel and apart, so no pixel's transmittance comes near its
    floor and the sequential and log-step products take the same
    decisions. Returns ``(rows [9, P + 1] f32, ids [capacity] int32,
    ranges [T, 2] int32, width, height, tile_count_x)`` as numpy arrays
    (capacity a multiple of 256).
    """
    rng = np.random.default_rng(seed)
    width, height = 64, 48
    tcx, tcy = width // 16, height // 16
    f32 = np.float32
    omin = f32(1.0 / 255.0)
    entries = []  # (cxx, cxy, cyy, opacity, px, py)

    def anywhere():
        return rng.uniform(-4.0, width + 4.0), rng.uniform(-4.0, height + 4.0)

    for delta in (1e-2, 1e-4, 1e-6, 1e-8):  # near-singular conics, both tilts
        for sign in (1.0, -1.0):
            s, r = rng.uniform(0.05, 0.5), rng.uniform(1.0, 2.0)
            entries.append((s, sign * s * np.sqrt(r) * (1 - delta), s * r, 0.3, *anywhere()))
    for op in (omin * (1 - 1e-6), omin, omin * (1 + 1e-6), np.nextafter(omin, f32(1))):
        for _ in range(2):  # centred on a pixel (density 1 there) and anywhere
            c = rng.uniform(0.1, 2.0)
            px, py = rng.integers(0, width), rng.integers(0, height)
            entries.append((c, 0.0, c, op, float(px), float(py)))
            entries.append((c, 0.1 * c, c, op, *anywhere()))
    for i, op in enumerate((0.99, 1.0, 0.995, 252 / 255)):  # opaque, sub-pixel, apart
        entries.append((4.0, 0.0, 4.0, op, 8.0 + 16 * i, 8.0 + 12 * (i % 3)))
    for c in (1e-6, 1e-4):  # huge
        entries.append((c, 0.2 * c, 1.5 * c, 0.05, *anywhere()))
    for c in (1e3, 1e6):  # sub-pixel, on a pixel and between pixels
        entries.append((c, 0.0, c, 0.9, 20.0, 30.0))
        entries.append((c, 0.3 * c, c, 0.9, 40.5, 10.25))
    for px, py in ((15.5, 1.5), (16.0, 2.0), (31.999, 15.99), (47.5, 17.0)):  # edges
        entries.append((1.0, 0.2, 0.8, 0.5, px, py))
    for conic in ((1.0, 2.0, 1.0), (-1.0, 0.0, 1.0), (0.0, 0.0, 0.0), (1.0, 0.0, -1.0)):
        entries.append((*conic, 0.5, *anywhere()))  # not positive definite
    nan, inf = float("nan"), float("inf")
    for row in ((1.0, 0.0, 1.0, 0.5, nan, 20.0), (nan, 0.0, 1.0, 0.5, 30.0, 20.0),
                (1.0, 0.0, inf, 0.5, 10.0, 10.0), (1.0, 0.0, 1.0, nan, 12.0, 30.0)):
        entries.append(row)

    # A pixel 1e-3 inside the ellipse's edge, alone in its warp strip (the
    # top row 2w + 1, the bottom row 2w) or its tile (column 15 or 0).
    for conic, pixel, axis, sign in (((0.3, 0.1, 0.2), (9, 5), 1, -1),
                                     ((0.3, 0.1, 0.2), (25, 22), 1, 1),
                                     ((0.05, -0.04, 0.04), (47, 30), 0, -1),
                                     ((2.0, 0.5, 0.5), (16, 40), 0, 1)):
        entries.append((*conic, 0.4, *grazing_position(*conic, 0.4, pixel, axis, sign, 1e-3)))

    p = len(entries)
    order = rng.permutation(p)
    rows = np.zeros((9, p + 1), f32)
    rows[0:3, :p] = rng.random((3, p))
    rows[3:9, :p] = np.asarray(entries, np.float64)[order].T.astype(f32)
    tiles = tcx * tcy
    capacity = -(-tiles * p // 256) * 256
    ids = np.full(capacity, p, np.int32)
    ids[: tiles * p] = np.tile(np.arange(p, dtype=np.int32), tiles)
    ranges = np.stack([np.arange(tiles) * p, np.arange(1, tiles + 1) * p], -1).astype(np.int32)
    return rows, ids, ranges, width, height, tcx


def compare_packed_grads(got, want) -> dict:
    """Packed gradient rows ``got`` against ``want`` (int32 ``[6, n]``, the
    layout of ``ops/blend.py::pack_rows``), decoded to nine f32 rows.

    An f32 difference of one ulp can flip a bf16 rounding, so each bf16
    element (rows 0-6) may differ by one bf16 ulp of the larger magnitude
    of the pair on top of the f32 tolerance. Returns ``row_scaled_err``:
    per row, the largest difference beyond that allowance (none for the
    position rows 7 and 8, which are f32) over the row's largest magnitude
    in ``want``; ``bf16_flips``, the bf16 elements that differ at all; and
    ``bf16_elements``, how many were compared.
    """
    import torch

    from .ops.blend import unpack_rows

    g = unpack_rows(got).double()
    w = unpack_rows(want).double()
    diff = (g - w).abs()
    larger = torch.maximum(g.abs(), w.abs()).float()
    # One bf16 ulp: 2^(exponent - 7), from the f32 exponent bits.
    ulp = (larger.view(torch.int32) & 0x7F800000).view(torch.float32).double() * 2.0 ** -7
    ulp[7:] = 0.0
    excess = (diff - ulp).clamp_min(0.0)
    errors = []
    for r in range(9):
        scale = float(w[r].abs().max()) if w.shape[1] else 0.0
        worst = float(excess[r].max()) if w.shape[1] else 0.0
        errors.append(worst / scale if scale > 0 else worst)
    return dict(row_scaled_err=errors, bf16_flips=int((g[:7] != w[:7]).sum()),
                bf16_elements=int(w[:7].numel()))


def assert_packed_grads_close(got, want, atol: float) -> dict:
    """:func:`compare_packed_grads` within ``atol`` on every row (a NaN
    error fails); returns the comparison."""
    rec = compare_packed_grads(got, want)
    if not all(e <= atol for e in rec["row_scaled_err"]):
        raise AssertionError(f"packed gradient rows differ beyond {atol}: {rec}")
    return rec


# --- ranks of torch.distributed, spawned -------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, timeout_s, worker, args):
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        # A card per rank, made current before the group exists: NCCL binds
        # it, and the kernels launch on the current device's stream.
        from .scripts import rank_device

        torch.cuda.set_device(rank_device("cuda", rank, backend))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        worker(rank, *args)
    except BaseException:
        # Printed before the group's teardown, which may wait on the peers
        # that this rank left inside a collective.
        import traceback

        traceback.print_exc()
        raise
    finally:
        # NCCL's communicator, when destroyed, waits for every graph that
        # captured its collectives: the entry points' graphs go first.
        from .render.views_graph import release_all

        if backend == "nccl":
            torch.cuda.synchronize()
        release_all()
        dist.destroy_process_group()


def spawn_ranks(worker, world_size: int, *args, backend: str = "gloo",
                timeout_s: float = 300.0) -> None:
    """Run ``worker(rank, *args)`` in ``world_size`` spawned processes that
    share one default process group (``backend``, over
    ``tcp://localhost``). Under NCCL rank ``r`` runs on card ``r``
    (``scripts.rank_device``), made its current device before the group
    is initialised; under gloo no device is set. ``worker`` must be
    importable by name, as a spawned child imports it afresh. A rank that
    raises ends the others, and the exception is raised here
    (``torch.multiprocessing``'s ``ProcessRaisedException``); a collective
    that waits longer than ``timeout_s`` fails."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world_size, free_port(), backend, timeout_s, worker, args),
             nprocs=world_size, join=True)


def _numpy(t):
    return t.detach().cpu().numpy()


def _grads(scene, ref) -> dict:
    out = {f"grad/{name}": _numpy(p.grad) for name, p in scene.named_parameters()}
    out["grad/norm"] = _numpy(ref.grad)
    return out


def _outputs(prefix: str, out) -> dict:
    return {f"{prefix}/{field}": _numpy(v) for field, v in zip(out._fields, out)}


def parallel_render_worker(rank, out_dir, arrays, views, options, tile_view, tile_options):
    """A rank of ``tests/test_torch_parallel.py`` on 4 gloo CPU ranks:
    ``make_mesh``, ``render_data_parallel`` over ``views`` and
    ``render_tile_sharded`` of ``tile_view``, each with the gradients of
    ``mean(image ** 2)`` (five parameters and the densification ref), and
    the single-device ``render`` of the same inputs. Writes
    ``out_dir/rank{rank}.npz``."""
    import pathlib

    import torch

    from . import GaussianScene, render, render_views
    from .parallel import make_mesh, render_data_parallel, render_tile_sharded, stack_cameras

    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh((4,), ("data",))
    out["mesh/data"] = np.array([mesh.shape["data"], mesh.coords["data"]])
    grid = make_mesh((2, 2), ("data", "tiles"))
    out["mesh/grid"] = np.array([grid.shape["data"], grid.shape["tiles"],
                                 grid.coords["data"], grid.coords["tiles"]])
    try:
        make_mesh((2, 4), ("data", "tiles"))
        out["mesh/too_few_raises"] = np.array(False)
    except ValueError:
        out["mesh/too_few_raises"] = np.array(True)

    def run(fn):
        scene = GaussianScene.from_numpy(**arrays, device="cpu")
        ref = torch.zeros(scene.point_count, requires_grad=True)
        result = fn(scene, ref)
        torch.mean(result.colors_rgb_2d ** 2).backward()
        return result, _grads(scene, ref)

    w, h = views[0].image_width, views[0].image_height
    cams = stack_cameras(views, device="cpu")
    got, grads = run(lambda s, r: render_data_parallel(s, cams, w, h, mesh, "data", options, r))
    out.update(_outputs("data_parallel", got), **{f"data_parallel/{k}": v
                                                   for k, v in grads.items()})
    with torch.no_grad():
        single = render_views(GaussianScene.from_numpy(**arrays, device="cpu"), views, options)
    out.update(_outputs("data_parallel_single", single))

    tiles = make_mesh((4,), ("tiles",))
    got, grads = run(lambda s, r: render_tile_sharded(s, tile_view, tiles, "tiles",
                                                      tile_options, r))
    out.update(_outputs("tile_sharded", got), **{f"tile_sharded/{k}": v
                                                  for k, v in grads.items()})
    single, grads = run(lambda s, r: render(s, tile_view, tile_options, r))
    out.update(_outputs("tile_sharded_single", single), **{f"tile_sharded_single/{k}": v
                                                           for k, v in grads.items()})
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def sharded_train_worker(rank, out_dir, arrays, views_by_height, targets_by_height, options,
                         cases, fit):
    """A rank of ``tests/test_torch_sharded_train.py`` on 4 gloo CPU ranks,
    a (2, 2) mesh of ``("data", "tiles")``: one ``make_sharded_train_step``
    step for each ``(name, height, ssim_weight)`` of ``cases`` from the
    scene ``arrays`` and a fresh Adam state (targets ``[V, H, W, 3]``
    padded with 7.7, which the step must mask), then
    ``ShardedTrainer.fit`` with ``fit = (arrays, height, config,
    iterations, max_chunk)``, and ``ShardedTrainer.fit_scan`` from the same
    start with ``max_chunk``, with its chunks as ``(first step, steps,
    points)``. Writes ``out_dir/rank{rank}.npz``."""
    import pathlib

    import torch

    from . import GaussianScene
    from .parallel import make_mesh, stack_cameras
    from .parallel.train_step import ShardedTrainer, make_sharded_train_step
    from .train.densify import zero_densify_acc

    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "tiles"))
    out = {}
    for name, height, ssim_weight in cases:
        scene = GaussianScene.from_numpy(**arrays, device="cpu")
        views = views_by_height[height]
        step, optimizer, h_pad = make_sharded_train_step(
            mesh, views[0].image_width, height, scene.point_count, options,
            ssim_weight=ssim_weight)
        targets = np.pad(targets_by_height[height], ((0, 0), (0, h_pad - height), (0, 0), (0, 0)),
                         constant_values=7.7)
        scene, _, acc, metrics = step(scene, optimizer.init(scene),
                                      zero_densify_acc(scene.point_count, "cpu"),
                                      stack_cameras(views, device="cpu"), targets)
        out[f"{name}/h_pad"] = np.array(h_pad)
        out.update({f"{name}/{k}": _numpy(v) for k, v in {**metrics, **acc}.items()})
        out.update({f"{name}/{k}": _numpy(p) for k, p in scene.named_parameters()})

    fit_arrays, height, config, iterations, max_chunk = fit
    views = views_by_height[height]
    for method in ("fit", "fit_scan"):
        trainer = ShardedTrainer(GaussianScene.from_numpy(**fit_arrays, device="cpu"), mesh,
                                 views[0].image_width, height, config)
        chunks, run = [], trainer._graph.run

        def recorded(step, key, tensors, steps, **kw):
            chunks.append((trainer.step_count, steps, trainer.scene.point_count))
            return run(step, key, tensors, steps, **kw)

        trainer._graph.run = recorded
        cameras, targets = stack_cameras(views, device="cpu"), targets_by_height[height]
        history = (trainer.fit(cameras, targets, iterations) if method == "fit"
                   else trainer.fit_scan(cameras, targets, iterations, max_chunk=max_chunk))
        out[f"{method}/loss"] = np.array([h["loss"] for h in history])
        out[f"{method}/tile_point_total"] = np.array([h["tile_point_total"] for h in history])
        out[f"{method}/point_count"] = np.array([h.get("point_count", -1) for h in history])
        out[f"{method}/chunks"] = np.array(chunks, dtype=np.int64).reshape(-1, 3)
        out[f"{method}/points"] = np.array(trainer.scene.point_count)
        out.update({f"{method}/{k}": _numpy(p) for k, p in trainer.scene.named_parameters()})

    # fit_scan's chunks on the default schedule from step 2,990, the steps
    # not run and the host events skipped.
    trainer = ShardedTrainer(GaussianScene.from_numpy(**fit_arrays, device="cpu"), mesh,
                             views[0].image_width, height)
    lengths = []
    trainer._graph.run = lambda step, key, tensors, steps, **kw: lengths.append(steps)
    trainer._host_events = dict
    trainer.step_count = 2_990
    trainer.fit_scan(cameras, targets, 1_210)
    out["fit_scan/default_chunks"] = np.array(lengths)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def scripts_worker(rank, out_dir, compare_iters):
    """A rank of ``tests/test_torch_scripts.py`` on 8 gloo CPU ranks: the
    ``mesh_scale`` parity step and dry run at n = 8, then
    ``train_sharded_compare``'s sharded side for ``compare_iters`` steps.
    Writes ``out_dir/rank{rank}.npz``."""
    import pathlib

    import torch

    from .scripts.mesh_scale import dryrun_toy, parity_rank
    from .scripts.train_sharded_compare import sharded_rank

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    parity = parity_rank(rank, 8, cpu)
    dryrun = dryrun_toy(8, cpu, log=lambda line: None)
    sharded = sharded_rank(rank, compare_iters, cpu, log=lambda line: None)
    out = {f"parity/{k}": np.asarray(v) for k, v in parity.items()
           if k not in ("scene", "errors", "launches")}
    out.update({f"parity/scene/{k}": v for k, v in parity["scene"].items()})
    out.update({f"parity/errors/{k}": np.asarray(v) for k, v in parity.get("errors", {}).items()})
    out.update({f"dryrun/{k}": np.asarray(v) for k, v in dryrun.items() if k != "launches"})
    out.update({f"sharded/{k}": np.asarray(v) for k, v in sharded.items()
                if k not in ("scene", "launches")})
    out.update({f"sharded/scene/{k}": v for k, v in sharded["scene"].items()})
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def sharded_grad_graph_worker(rank, out_dir, arrays, views, options, tile_views, tile_options):
    """A rank of ``tests/test_torch_sharded_grad_graph.py`` on 4 gloo CPU
    ranks: ``render_data_parallel`` of ``views`` (and of the same views in
    another order) on a 4-way ``data`` axis and ``render_tile_sharded`` of
    ``tile_views`` on a 4-way ``tiles`` axis, each through its graph pair
    (``_data_parallel_graphed``, ``_tile_sharded_graphed``; every replay
    eager on the CPU) and through its eager form, over one sequence of
    calls with the gradients of ``mean(image ** 2)``: the warm-up, the
    capture, a replay, new cameras, two calls before one backward,
    backwards in the reverse order, a dropped call, then calls with no ref
    (a miss: another warm-up and capture). Writes ``out_dir/rank{rank}.npz``:
    every output and gradient of each side in order (``<case>/<side>/<i>``),
    the replay's outputs and gradients (``<case>/replay/...``) and the
    pair's counts (``<case>/counts``: captures, forward and backward
    replays, moves)."""
    import pathlib

    import torch

    from . import GaussianScene
    from .parallel import make_mesh, stack_cameras
    from .parallel.render import (
        _data_parallel_eager, _data_parallel_graphed, _tile_sharded_eager,
        _tile_sharded_graphed,
    )
    from .render.grad_graph import grad_graph

    torch.set_num_threads(1)
    w, h = views[0].image_width, views[0].image_height
    cameras = (stack_cameras(views, device="cpu"),
               stack_cameras(views[1:] + views[:1], device="cpu"))
    data, tiles = make_mesh((4,), ("data",)), make_mesh((4,), ("tiles",))
    cases = {
        "data_parallel": ("parallel.render_data_parallel", _data_parallel_graphed,
                          _data_parallel_eager,
                          lambda fn, s, i, r: fn(s, cameras[i], w, h, data, "data", options, r)),
        "tile_sharded": ("parallel.render_tile_sharded", _tile_sharded_graphed,
                         _tile_sharded_eager,
                         lambda fn, s, i, r: fn(s, tile_views[i], tiles, "tiles", tile_options,
                                                r)),
    }
    out = {}
    for case, (name, graphed, eager, call) in cases.items():
        graph = grad_graph(name, torch.device("cpu"))
        graph.release()
        for side, fn in (("graph", graphed), ("eager", eager)):
            scene = GaussianScene.from_numpy(**arrays, device="cpu")
            record = []

            def render(i, ref=True):
                ref = torch.zeros(scene.point_count, requires_grad=True) if ref else None
                result = call(fn, scene, i, ref)
                record.extend(t.detach() for t in result)
                return result, ref

            def backward(*calls):
                scene.zero_grad(set_to_none=True)
                sum(torch.mean(result.colors_rgb_2d ** 2) for result, _ in calls).backward()
                record.extend(p.grad for p in scene.parameters())
                record.extend(ref.grad for _, ref in calls if ref is not None)

            for step in range(3):  # the warm-up, the capture, a replay
                if step == 2:
                    out[f"{case}/{side}/replay_at"] = np.array(len(record))
                backward(render(0))
            backward(render(1))
            backward(render(0), render(1))
            a, b = render(0), render(1)
            backward(b)
            backward(a)
            render(1)  # dropped
            backward(render(0))
            for _ in range(3):  # no ref: a miss, the warm-up, the capture, a replay
                backward(render(0, ref=False))
            out.update({f"{case}/{side}/{i}": _numpy(t) for i, t in enumerate(record)})
            if side == "graph":
                out[f"{case}/counts"] = np.array([graph.captures, graph.replays["forward"],
                                                  graph.replays["backward"], graph.moves])
            del scene, record, a, b
        graph.release()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
