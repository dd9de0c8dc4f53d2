"""Kernels A and C (their f32 entry points) of this checkout against the
same kernels built from another source tree, timed in turns on one CUDA
card.

    mkdir -p build/other
    git archive <commit> gausplat_tpu_torch/csrc | tar -x -C build/other
    python3 compare_builds.py build/other/gausplat_tpu_torch/csrc

The argument is another tree's ``gausplat_tpu_torch/csrc``. Both libraries
are built from source with the same nvcc flags and loaded side by side, and
take the same inputs: those of chip_smoke.py's train phase at its first step
with every SH degree (the bench scene with the train phase's seeded noise,
1M points, view 0 at 1920x1080, its calibrated capacity; kernel C takes the
photometric loss's image cotangent against the bench scene's render). Each
kernel runs ``ROUNDS`` rounds of other, this, this, other
(``chip_smoke.in_turns``, ``REPS`` timed runs per turn after a warm-up). It
prints the card's name and power limit, then one JSON line per kernel:
each build's median over every run, each round's medians and their ratio
(this over other), every time (ms), each build's registers, static shared
memory and resident CTAs per SM, and whether the two builds' outputs are
bit-identical. It exits non-zero on a machine without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

import chip_smoke as S

REPS = 20
ROUNDS = 5


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
    dev = torch.device("cuda", 0)
    builds = {"this": (RASTERIZE_FORWARD, RASTERIZE_BACKWARD),
              "other": tuple(k.with_source_dir(argv[0])
                             for k in (RASTERIZE_FORWARD, RASTERIZE_BACKWARD))}
    build_all([k for pair in builds.values() for k in pair])

    arrays = S.bench_scene_arrays()
    views = S.bench_views(T)
    view = views[0]
    with torch.no_grad():
        bench = T.GaussianScene.from_numpy(**arrays, device=dev)
        target = T.render(bench, view, T.calibrate_options(bench, views)).colors_rgb_2d
        del bench
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

    print(S.nvidia_smi("name,power.limit"), flush=True)
    for index, (name, make, same) in enumerate((
        ("rasterize_forward", forward,
         lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))),
        ("rasterize_backward", backward,
         lambda a, b: bool(torch.equal(a[:, :valid], b[:, :valid]))),
    )):
        other, this = builds["other"][index], builds["this"][index]
        identical = same(make(other)(), make(this)())
        rounds = [S.in_turns(make(other), make(this), reps=REPS) for _ in range(ROUNDS)]
        other_all = [t for r in rounds for t in r["first"][1]]
        this_all = [t for r in rounds for t in r["second"][1]]
        print(json.dumps(dict(
            kernel=name, capacity=options.tile_entry_capacity, valid_entries=valid,
            order="other, this, this, other", rounds=ROUNDS, reps_per_turn=REPS,
            other_ms=statistics.median(other_all), this_ms=statistics.median(this_all),
            this_over_other=statistics.median(this_all) / statistics.median(other_all),
            round_ms=[(r["first"][0], r["second"][0]) for r in rounds],
            round_this_over_other=[r["second"][0] / r["first"][0] for r in rounds],
            other_ms_all=other_all, this_ms_all=this_all,
            other_launch=other.launch_info(), this_launch=this.launch_info(),
            outputs_bit_identical=identical,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
