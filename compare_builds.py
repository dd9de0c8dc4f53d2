"""Kernels A, B and C of this checkout against the same kernels built from
another source tree, timed in turns on one CUDA card.

    mkdir -p build/other
    git archive <commit> gausplat_tpu_torch/csrc | tar -x -C build/other
    python3 compare_builds.py build/other/gausplat_tpu_torch/csrc

The argument is another tree's ``gausplat_tpu_torch/csrc``. Both libraries
are built from source with the same nvcc flags and loaded side by side.

- A and C (their f32 entry points) take the inputs of chip_smoke.py's train
  phase at its first step with every SH degree (the bench scene with the
  train phase's seeded noise, 1M points, view 0 at 1920x1080, its
  calibrated capacity; kernel C takes the photometric loss's image
  cotangent against the bench scene's render).
- B takes the projection of view 0 at two shapes: serving (the bench
  scene, the capacity calibrated over the five bench views) and the train
  phase's step after its 10-step fit (``chip_smoke.fit_ten_steps``). If the
  other tree's B is the design before the int32 keys (its C entry takes
  ``offsets_inc``, as up to commit cdd0e68), it is bound with that argument
  list and fed by a ``torch.cumsum``, as its wrapper was; its int64 keys
  must equal this tree's keys under ``keys_to_u32``, and its ids, offsets
  and total must be bit-identical.

Each pair runs ``ROUNDS`` rounds of other, this, this, other
(``chip_smoke.in_turns``, ``REPS`` timed runs per turn after a warm-up). It
prints the card's name and power limit, then one JSON line per comparison:
each build's median over every run, each round's medians and their ratio
(this over other), every time (ms), whether the outputs agree, for A and C
each build's registers, static shared memory and resident CTAs per SM, and
for B each build's device time per call (torch.profiler: its own kernels,
and every kernel of the call). It exits non-zero on a machine without a
CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys

import torch

import chip_smoke as S

REPS = 20
ROUNDS = 5
#: The device kernels of B before the int32 keys, by name.
OLD_EXPAND_KERNELS = ("expand_entries", "fill_pads")


def turns(other, this) -> dict:
    """``ROUNDS`` rounds of other, this, this, other: medians, ratios, times."""
    rounds = [S.in_turns(other, this, reps=REPS) for _ in range(ROUNDS)]
    other_all = [t for r in rounds for t in r["first"][1]]
    this_all = [t for r in rounds for t in r["second"][1]]
    return dict(
        order="other, this, this, other", rounds=ROUNDS, reps_per_turn=REPS,
        other_ms=statistics.median(other_all), this_ms=statistics.median(this_all),
        this_over_other=statistics.median(this_all) / statistics.median(other_all),
        round_ms=[(r["first"][0], r["second"][0]) for r in rounds],
        round_this_over_other=[r["second"][0] / r["first"][0] for r in rounds],
        other_ms_all=other_all, this_ms_all=this_all,
    )


def old_expand(kernel):
    """B before the int32 keys, as its wrapper called it: a ``torch.cumsum``
    for the offsets, then one library call that took them (int64 keys)."""
    from gausplat_tpu_torch.constants import DEPTH_ORDER_OFFSET
    from gausplat_tpu_torch.utils.kernels import stream_of

    def run(depths, tile_x_max, tile_x_min, tile_y_min, tile_counts, *, tile_count_x,
            capacity):
        offsets_inc = torch.cumsum(tile_counts, 0, dtype=torch.int32)
        total = offsets_inc[-1]
        keys = torch.empty((capacity,), dtype=torch.int64, device=depths.device)
        src = torch.empty((capacity,), dtype=torch.int32, device=depths.device)
        kernel.launch(
            depths.data_ptr(), tile_x_max.data_ptr(), tile_x_min.data_ptr(),
            tile_y_min.data_ptr(), tile_counts.data_ptr(), offsets_inc.data_ptr(),
            total.data_ptr(), depths.shape[0], tile_count_x, capacity, DEPTH_ORDER_OFFSET,
            keys.data_ptr(), src.data_ptr(), stream_of(depths),
        )
        return keys, src, offsets_inc, total

    return run


def expand_builds(other_dir):
    """B of the other tree and B of this tree: ``{name: (kernel, call,
    device kernel names)}``."""
    from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders
    from gausplat_tpu_torch.utils.kernels import I32, I64, PTR, U32, CudaKernel

    def new(kernel):
        return lambda *a, **kw: fused_point_orders(*a, kernel=kernel, **kw)

    names = S.DEVICE_KERNELS["expand.cu"]
    source = (pathlib.Path(other_dir) / "expand.cu").read_text()
    if "const void* offsets_inc" in source:
        other = CudaKernel("expand.cu", EXPAND.entry,
                           [PTR] * 7 + [I32, I32, I64, U32, PTR, PTR, PTR])
        other = other.with_source_dir(other_dir)
        other_build = (other, old_expand(other), OLD_EXPAND_KERNELS)
    else:
        other = EXPAND.with_source_dir(other_dir)
        other_build = (other, new(other), names)
    return {"other": other_build, "this": (EXPAND, new(EXPAND), names)}


def same_orders(a, b) -> dict:
    """Two expansions' outputs: keys (either layout, as u32), ids, offsets
    and total, each bit for bit."""
    from gausplat_tpu_torch.ops.binning import keys_to_u32

    def u32(keys):
        return keys if keys.dtype == torch.int64 else keys_to_u32(keys)

    return dict(keys=bool(torch.equal(u32(a[0]), u32(b[0]))),
                **{name: bool(torch.equal(x, y))
                   for name, x, y in zip(("src", "offsets_inc", "total"), a[1:], b[1:])})


def expand_in_turns(builds, shape, proj, tcx, capacity) -> None:
    """B of the other tree against this tree's at one shape: one JSON line."""
    args = S.expand_args(proj)
    kw = dict(tile_count_x=tcx, capacity=capacity)
    outs = {name: call(*args, **kw) for name, (_, call, _) in builds.items()}
    torch.cuda.synchronize()
    call_other, call_this = builds["other"][1], builds["this"][1]

    def other():
        return call_other(*args, **kw)

    def this():
        return call_this(*args, **kw)

    record = dict(
        kernel="expand_point_orders", shape=shape, points=int(proj.depths.shape[0]),
        capacity=capacity, entries=int(outs["this"][3]),
        outputs_bit_identical=same_orders(outs["other"], outs["this"]),
        **turns(other, this),
        other_device=S.device_ms(other, builds["other"][2]),
        this_device=S.device_ms(this, builds["this"][2]),
    )
    print(json.dumps(record), flush=True)


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT
    from gausplat_tpu_torch.ops.rasterize import (
        RASTERIZE_BACKWARD, RASTERIZE_FORWARD, rasterize_backward, rasterize_forward,
        untile_image,
    )
    from gausplat_tpu_torch.utils.kernels import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    builds = {"this": (RASTERIZE_FORWARD, RASTERIZE_BACKWARD),
              "other": tuple(k.with_source_dir(argv[0])
                             for k in (RASTERIZE_FORWARD, RASTERIZE_BACKWARD))}
    b_builds = expand_builds(argv[0])
    build_all([k for pair in builds.values() for k in pair]
              + [k for k, _, _ in b_builds.values()])

    arrays = S.bench_scene_arrays()
    views = S.bench_views(T)
    view = views[0]
    print(S.nvidia_smi("name,power.limit"), flush=True)
    with torch.no_grad():
        bench = T.GaussianScene.from_numpy(**arrays, device=dev)
        options = T.calibrate_options(bench, views)
        targets = [T.render(bench, v, options).colors_rgb_2d for v in views]
        *_, tcx, proj = S.raster_inputs(bench, view, options.tile_entry_capacity,
                                        options.tight_culling, dev)
        expand_in_turns(b_builds, "serving", proj, tcx, options.tile_entry_capacity)
        del bench, proj
    target = targets[0]
    scene = T.GaussianScene.from_numpy(**S.train_start_arrays(arrays), device=dev)
    options = T.calibrate_options(scene, views)
    rows, ids, ranges, tcx, _ = S.raster_inputs(scene, view, options.tile_entry_capacity,
                                                options.tight_culling, dev)
    image_tiles = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)[0]
    image = untile_image(image_tiles, tcx, ranges.shape[0] // tcx, view.image_width,
                         view.image_height).requires_grad_()
    (cotangent,) = torch.autograd.grad(TT.photometric_loss(image, target), image)
    c_args = S.backward_inputs(rows, ids, ranges, tcx, cotangent.detach())
    valid = int(ranges[:, 1].max())

    def forward(kernel):
        return lambda: rasterize_forward(rows, ids, ranges, tile_count_x=tcx, kernel=kernel)

    def backward(kernel):
        return lambda: rasterize_backward(*c_args, tile_count_x=tcx, kernel=kernel)

    for index, (name, make, same) in enumerate((
        ("rasterize_forward", forward,
         lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))),
        ("rasterize_backward", backward,
         lambda a, b: bool(torch.equal(a[:, :valid], b[:, :valid]))),
    )):
        other, this = builds["other"][index], builds["this"][index]
        identical = same(make(other)(), make(this)())
        print(json.dumps(dict(
            kernel=name, capacity=options.tile_entry_capacity, valid_entries=valid,
            **turns(make(other), make(this)),
            other_launch=other.launch_info(), this_launch=this.launch_info(),
            outputs_bit_identical=identical,
        )), flush=True)
    del rows, ids, ranges, c_args, image, image_tiles

    # B at the train phase's step: its 10-step fit, then view 0's projection.
    trainer = TT.Trainer(scene, view.image_width, view.image_height,
                         S.train_config(options, views))
    S.fit_ten_steps(trainer, views, targets)
    opts = trainer._options()
    *_, tcx, proj = S.raster_inputs(trainer.scene, view, opts.tile_entry_capacity,
                                    opts.tight_culling, dev, sh_degree=opts.colors_sh_degree_max)
    expand_in_turns(b_builds, "train_step", proj, tcx, opts.tile_entry_capacity)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
