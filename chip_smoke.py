"""Drive the PyTorch + CUDA port on one NVIDIA GPU: serving and training.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # every phase on card 0
    python3 chip_smoke.py --cards 4  # the parallel path, one NCCL rank per card

It imports torch, numpy and ``gausplat_tpu_torch`` only (no JAX, and
nothing of ``tests/``), builds the three hand-written kernel libraries from
``gausplat_tpu_torch/csrc`` into ``build/gausplat_tpu_torch/`` (one nvcc
each, all at once; the rasterize libraries hold an entry point for f32
rows and one for packed bf16-pair rows), and runs fifteen phases, each
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
   1920x1080 rendered for 5 views through ``render``, one replay of its
   CUDA graph a call after the warm-up and the capture (a new view only
   copies its camera in), every call bit for bit the eager render in all
   five fields, and once through ``render_views``, with the launch counts
   of both forward kernels (by replay too); the per-call entry points
   against their eager forms: ``render`` and ``count_tile_entries``
   (every count equal), each with its miss cost (the warm-up's and the
   capture's host ms against an eager call's), ms a call, busy ms and
   host calls (a steady call: one graph launch, no kernel launch, at most
   10 host calls), ``render`` also with a new view every call; then
   CUDA-event timings of the render and of both forward kernels beside
   their plain versions at the serving shapes, with each kernel's own
   device time (profiler, by kernel name), the share of (entry, warp)
   pairs that the rasterizers' footprint keeps, ``torch.sort`` on B's
   int32 keys in turns with the same keys as int64, ``bin_gaussians`` as a
   whole, and a torch.profiler breakdown of the render; then the slice's
   main path, ``render_views`` through its CUDA graph at the 5 views in
   both modes (the warm-up, the capture and a replay, each bit for bit the
   5 renders in all five fields; A's and B's launches, by replay too; the
   static buffers and each mode's pool) and the eager loop against the
   graph at 1 and 5 views a call (ms a view, busy ms, idle share, host
   launches; a steady-state call makes one graph launch and no kernel
   launch from the host);
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
   full-size scene (every SH degree, a densify, an opacity reset), each
   step one replay of ``train_step``'s CUDA graph after its capture, with
   the launch counts of all three kernels (by replay too), bit for bit
   the same fit with the step launched op by op (``_fit_eager``) from the
   same start; then, at the step's shapes,
   each kernel against its plain version (tolerances as in phases 2, 3
   and 6) and timed beside it (CUDA events around the wrapper, and the
   device time of its own kernels; B's call must launch nothing else), A
   and C also built without their footprint skip (bit-identical outputs
   required) and timed; the sorts and the binning as at serving; timings
   of a step (eager and through its graph) and of forward + backward, the
   peak memory, and a profile of a step;
10. colmap_bf16: the bf16 training path from a COLMAP capture. A synthetic
   sparse model of the bench scene (1,000,000 SfM points, the 5 views as
   PINHOLE 1920x1080 images, no image files) is written to a temporary
   directory, loaded with ``load_sparse_model`` (views and points must
   round-trip), initialised with ``GaussianScene.from_points`` on the card
   and fitted with ``Trainer.fit_scan`` (as ``train_from_colmap`` fits:
   packed A and C inside the captured step) for 10 steps with phase 9's
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
   ``render_tile_sharded``, bit for bit ``render``, gradients too, and
   serves through the graphs of ``render_data_parallel`` (the 4 orbit
   views) and ``render_tile_sharded`` (the bench view), each bit for bit
   its eager call over three calls (warm-up, capture, replay) and timed
   beside it; then four
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
   ``train_long``'s lego recipe for 2,000 steps at the record's densify
   interval of 500, through ``Trainer.fit_scan`` (losses finite, no step's
   entries over its capacity, the last 200-step chunk's mean loss below the
   first's, A, B and C launched), its curve printed beside the JAX
   package's record ``train_long_r05_lego.json`` (read as data) with the
   wall ms per step and the peak memory, then A, B and C at its shapes
   (view 0 of the fitted scene) against their plain versions and timed;
   (e) one render inside ``profiling.trace`` and two ``profiling.stage``
   scopes: the Chrome trace must name both stages and the kernels of A
   and B.
13. scripts: the last three scripts, each through its own function, with
   a JSON line before each: (a) ``train_convergence`` at 1,500 steps
   (every loss finite, the last of its five printed PSNRs above the first,
   the points grown, A, B and C launched; ms per step); (b)
   ``train_sharded_compare`` at 300 steps (cut from the JAX script's 600
   to keep the phase near 5 minutes; the cut is printed): the single side
   here, the (2, 4) ``ShardedTrainer`` side in 8 gloo ranks on this card,
   ``delta_db`` at most 0.5, A, B and C launched on both sides; (c)
   ``mesh_scale`` at 8, 16 and 32 gloo ranks on this card: each n's
   sharded step within the JAX script's tolerances of the single-device
   step, its loss within 2e-4 relative of the JAX record
   ``MESH_SCALE_r05.json`` (read as data), the toy dry run finite with
   entries, and A, B and C launched, also on the ranks whose slab lies
   wholly in the padding. A, B and C are then held to their plain
   versions at each part's own shapes, timed: view 0 of (a)'s fitted scene
   (256 x 256), slab 0 of view 0 of (b)'s sharded scene (128 x 32), and
   at n = 8 slab 0 of (c)'s step (rows 0-31, live) and its slab wholly in
   the padding (rows 96-127 of an 80-row frame; the entry total and every
   rendered count exact). The live ones must compare entries that blend.
14. fit_scan: the training step captured as a CUDA graph. (a) phase 9's
   configuration at full size (1,000,000 points, SH 0-3, a densify, an
   opacity reset): 10 steps of the eager fit (``Trainer._fit_eager``)
   twice from one start, whose largest parameter difference is the card's
   spread, then 10 steps of ``Trainer.fit`` through its graphs and of
   ``Trainer.fit_scan`` (chunks break at every host event; A, B and C
   counted at 10 launches each, replays included), their parameters within
   the spread of the first fit's (and ``fit`` bit for bit where the spread
   is 0) and their point counts equal; (b) the steady state at those
   shapes (20 steps, SH 3, no host event) three ways: the eager fit,
   ``fit`` through its graph and ``fit_scan``, each with ms a step (median
   of 5 CUDA-event timings), the profiler's device-busy ms, idle share,
   kernels and host launches a step, A's, B's and C's device ms a step by
   name and the peak memory, the memory each graph's pool keeps, and one
   replay of each graph under ``torch.cuda.set_sync_debug_mode("error")``,
   after A, B and C at the captured shapes against their plain versions,
   timed; (c) phase 12's lego prefix, which ran through ``fit_scan``: its
   points (PR 8's eager prefix's 4,114, exactly where (a)'s spread is 0)
   and PSNR beside PR 8's, its ms a step, and the steady state at its
   shapes as in (b); (d) ``ShardedTrainer`` on a (1, 1) ("data",
   "tiles") mesh over one NCCL rank in this process, the 4 orbit views at
   1920x1080 from phase 9's start: the eager fit twice, ``fit`` through
   its graphs once and ``fit_scan`` once, 10 steps across a densify event
   (``fit_scan``'s chunks of 4, 1, 3 and 2 steps), the sharded step
   captured with its NCCL collectives inside: the point counts equal, the
   parameters within the spread, the captures, the replays and A, B and C
   at 40 launches each (replays counted); then the steady state at those
   shapes as in (b) (3 timings each), with the host ms of the ranks' miss
   decision;
15. render_grad: the differentiable ``render`` and its backward through
   their forward and backward CUDA graphs (``render/grad_graph.py``), as a
   user's loop calls them (a fresh ref that requires grad each call, an L1
   loss against a target, ``loss.backward()``), at the serving shapes (the
   1M-point scene at 1920x1080, SH 3, the calibrated capacity; each view's
   target another view's render) and at the lego fit's (phase 12's fitted
   4,114-point scene, 800x800): the warm-up, the capture, a replay, a new
   view, two renders before one backward, backwards in the reverse order,
   a dropped forward, then a scene of another point count from
   ``from_numpy`` (a miss: its warm-up, capture and a replay), every output,
   parameter gradient and ref gradient bit for bit the same sequence through
   ``_render_eager`` and its backward, the pair's captures, replays and
   moved states checked after each step, A, B and C counted (by replay
   too); then the miss cost (host ms of the warm-up and the capture calls
   against an eager call and a replay), the pool's bytes and the saved
   state a move copies, a call through the graphs and eager in turns (ms,
   median of 5 CUDA-event timings twice over, with every timing), two views
   before one backward likewise, the profiler's busy ms, idle share and
   host calls of a call and of the render with its backward alone (two
   graph launches a call), one replay of each graph with the host's sync
   checks set to raise, and A, B and C at the call's shapes against their
   plain versions, timed. Its views part: ``render_views`` of the 5 views a
   call on the serving scene (call ``i`` from the ``i``-th view on, an L1
   loss of the stack against the targets in the same order), in both
   modes, through its graph pair against ``_render_views_eager`` over the
   same sequence (every output and parameter gradient bit for bit, A, B
   and C 5 each a replay), then (one pair serves both modes) the miss
   cost, pool and saved state, ms, busy, idle and host calls both ways,
   the render and its backward alone (two graph launches, no kernel launch
   from the host) and the strict replays; then A, B and C at its shapes. Its NCCL part: a (1, 1) mesh
   over one NCCL rank in this process, ``render_data_parallel`` of the 4
   orbit views and ``render_tile_sharded`` of the bench view under grad,
   each through its graph pair against its eager form over the warm-up,
   the capture, two replays and two calls before one backward (every
   output and gradient bit for bit, one capture), timed both ways, the
   render and its backward alone making no kernel launch from the host but
   the ranks' miss decision's.

With ``--cards 4`` (a machine with four cards; it exits non-zero before
any work where fewer are visible, and never runs on fewer ranks or over
gloo) it runs env, then one phase, nccl_cards: the single 4K render and
the (2, 2) step's single-device reference on card 0, then four ranks
spawned over NCCL, rank r on card r, each printing (rank 0) a JSON line
before each part: (a) the 4K frame of phase 11 (b) in 4 slabs of 544
rows, against the single render (phase 11's gates), with each rank's ms
(median of 5, CUDA events) beside the single render's, then the same
frame through ``render_tile_sharded``'s graph, bit for bit the eager slabs
on every rank, and 8 orbit views of the bench scene through
``render_data_parallel``'s graph, 2 a rank, bit for bit its eager call,
both timed beside the eager calls; (b) the (2, 2)
step against the single-device loss (2e-4) and gradients (1e-3 scaled);
(c) ``ShardedTrainer``: the eager fit twice, ``fit`` through its graphs
once and ``fit_scan`` once from one start, 10 steps across a densify
event: the ranks' scene digests equal (each run's), the point counts
equal, and each graphed run bit for bit the eager fit, or else (the first
step and fields that differ printed) losses within 1e-5 relative and
parameters within 1e-4; (d) the steady state on each rank as in phase 14
(b); (e) under grad (``mean(image ** 2)``), the 4K frame through
``render_tile_sharded``'s graph pair and the 8 orbit views through
``render_data_parallel``'s, each bit for bit its eager form on every rank
as phase 15's NCCL part holds them, timed both ways with the ranks' miss
decision, and on rank 0 within the multi-device gates (the image within
1e-4, the 4K frame's on all but 1e-3 of its pixels; gradients within
1e-3 scaled) of the single-device differentiable render the parent
computed. Then A, B and C on rank 0's slab 0 of (b)
(``<kernel>@nccl_slab0``) and on slab 0 of the 4K frame
(``<kernel>@nccl_grad_slab0``, (e)'s launches) against their plain
versions, launches summed over the ranks. Its last line's ``count`` is
the cards it drove.

Then it prints the card's name and power limit, one JSON line of
per-kernel results: phase 5 for A and B at the serving shapes,
``<kernel>@render_graph``, whose launches are those of the main path's
renders through ``render``'s graph, and ``<kernel>@render_views_graph``,
whose launches are those of ``render_views`` through its graph (replays
counted, and ``launches_by_replay``), and a training path for the rest
(phase 9 for the f32 entry points of A, B and C, phase 10 for the packed
``rasterize_forward_bf16`` and ``rasterize_backward_bf16``, phase 11 for
A, B and C on the slabs, ``<kernel>@slab0`` and ``@last_slab``, whose
launches are the parallel path's summed over its ranks, phase 12 for A, B
and C at the lego fit's shapes, ``<kernel>@lego_fit``, whose launches are
its 2,000 steps', phase 13 for A, B and C at each script's shapes,
``<kernel>@convergence`` (launches: (a)'s 1,500 steps),
``@sharded_compare_slab0`` ((b)'s sharded steps on the ranks of slab 0),
``@mesh_scale_slab0`` and ``@pad_slab`` (``mesh_scale``'s step at 8 ranks
on the ranks of that slab), phase 14 for A, B and C at the captured
step's shapes, ``<kernel>@fit_scan``, whose launches are (a)'s fit_scan's,
replays included, phase 15 for A, B and C at the differentiable render's
shapes, ``<kernel>@render_grad`` (serving) and ``@render_grad_lego``, whose
launches are those of its sequence through the graphs (replays counted, and
``launches_by_replay``), and ``<kernel>@render_views_grad``, whose launches
are those of its views part's sequences in both modes (with ``--cards 4``:
only ``<kernel>@nccl_slab0`` and ``@nccl_grad_slab0``): their
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
import types

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
#: The TPU kernel each kernel's entry of the kernels line replaces.
REPLACES = dict(rasterize_forward="gausplat_tpu/ops/rasterize.py:409",
                expand_point_orders="gausplat_tpu/ops/expand.py:121",
                rasterize_backward="gausplat_tpu/ops/rasterize.py:604")


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


#: The host's calls that put work on the card, as the profiler names them.
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemsetAsync", "cudaMemcpyAsync")


def profile_device_time(fn, reps: int = 3, top: int = 12, names=()) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler,
    CUPTI), the device-busy time per call against the host clock, the idle
    share of the window, the kernels the card ran per call and the host's
    calls that put work on the card per call (``host_launches``: kernel
    and graph launches, memsets and copies; by name in ``host_calls``);
    ``named``: the device ms per call of the kernels whose names contain
    each of ``names``.
    NCCL's kernels (``collective_ms``) run on their own stream beside the
    compute and spin while a peer rank is late, so their time can overlap
    the rest and exceed the work: ``compute_idle_share`` is the share of
    the window in which no other kernel ran. The profiler's ``nccl:*``
    ranges, which span those kernels again, are left out. The profiler
    drops device records (see :func:`device_ms`), so each kernel's time
    is the mean over the records it holds times its launches a call
    (:func:`launches_a_call`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = counted_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / reps
    counted = {k: n - before[k] for k, n in counted_launches().items()}
    events = prof.key_averages()
    kernels, host = [], {}
    for event in events:
        if event.device_type != torch.autograd.DeviceType.CUDA:
            if event.key.startswith(HOST_LAUNCH_CALLS):
                host[event.key] = event.count / reps
            continue
        if event.key.startswith("nccl:") or not event.count:
            continue
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = event.cuda_time_total
        per_call = launches_a_call(event, events, reps, counted)
        kernels.append((device_us / 1e3 / event.count * per_call, per_call, event.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms == 0.0:  # the host's calls are the host's records, kept
        return dict(device_busy_ms="not measured (the profiler saw no device time)",
                    wall_ms=wall_ms, host_launches=sum(host.values()), host_calls=host)
    collective_ms = sum(k[0] for k in kernels if k[2].startswith("ncclDevKernel"))
    named = {name: sum(k[0] for k in kernels if name in k[2]) for name in names}
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
        collective_ms=collective_ms, named=named,
        compute_idle_share=1.0 - (busy_ms - collective_ms) / wall_ms,
        kernel_launches=sum(k[1] for k in kernels), host_launches=sum(host.values()),
        host_calls=host,
        top=[dict(ms=ms, calls=n, name=name) for ms, n, name in kernels[:top]],
    )


#: The device kernels of each kernel library, by the names the profiler
#: reports them under (a memset that a library issues shows as "Memset").
DEVICE_KERNELS = {
    "expand.cu": ("expand_chunk_sums", "expand_slots", "Memset"),
    "rasterize_forward.cu": ("rasterize_forward_kernel",),
    "rasterize_backward.cu": ("rasterize_backward_kernel",),
}


def counted_launches() -> dict:
    """The port's kernel wrappers' launch counts (replays included), by
    the device kernels each launch runs once (``DEVICE_KERNELS``, without
    the memsets, whose name PyTorch's share)."""
    counts = {}
    for kernel in all_kernels():
        for name in DEVICE_KERNELS[kernel.source.name]:
            if name != "Memset":
                counts[name] = counts.get(name, 0) + kernel.launches
    return counts


def launches_a_call(event, events, reps: int, counted: dict) -> float:
    """A device kernel's launches a call in a profiled window of ``reps``
    calls (``event`` one of the window's ``events``). For a kernel of the
    port, the wrappers' count over the window (``counted``, from
    :func:`counted_launches`) over ``reps``, where no other event of the
    window shares its name (the f32 and packed variants of one kernel
    do); else the records held over ``reps``, rounded (at least 1), which
    reads low where the profiler dropped records of a kernel launched more
    than once a call."""
    for name, n in counted.items():
        if name in event.key and n:
            if sum(1 for e in events if name in e.key
                   and e.device_type == torch.autograd.DeviceType.CUDA) == 1:
                return n / reps
            break
    return max(1, round(event.count / reps))


#: Host seconds of idle profiler window on each side of a :func:`device_ms`
#: reading, and the readings it takes before it gives up.
PROFILE_PAD_S = 0.05
PROFILE_ATTEMPTS = 3


def _profiled_device_ms(fn, names, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    before = counted_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    counted = {k: n - before[k] for k, n in counted_launches().items()}
    events = prof.key_averages()
    every = 0.0
    mine, records, others = {}, {}, []
    for event in events:
        if event.device_type != torch.autograd.DeviceType.CUDA or not event.count:
            continue
        us = getattr(event, "device_time_total", None)
        us = event.cuda_time_total if us is None else us
        # The mean over the records held, times the launches a call.
        ms = us / 1e3 / event.count * launches_a_call(event, events, reps, counted)
        every += ms
        found = ([event.key[:90]] if names is None
                 else [name for name in names if name in event.key])
        if found:
            mine[found[0]] = mine.get(found[0], 0.0) + ms
            records[found[0]] = records.get(found[0], 0) + event.count
        else:
            others.append(event.key[:90])
    return dict(device_ms=sum(mine.values()), device_all_ms=every, kernels=mine,
                records=records, other_kernels=others)


def device_ms(fn, names=None, reps: int = 20) -> dict:
    """Device time per call of ``fn`` (torch.profiler, CUPTI) over ``reps``
    calls after a warm-up: ``device_ms`` of the kernels whose names contain
    one of ``names``, or of every kernel where ``names`` is None
    (``kernels``: by name), ``device_all_ms`` of every kernel, and the names
    of the others that ran. The profiler drops device records: a reading
    of 20 calls has held 10-19 records of a kernel, and some readings of A
    none. So each kernel's time is the mean over the records
    it holds times its launches a call (``records``: how many it held), the
    window is padded with ``PROFILE_PAD_S`` of idle host time on each side,
    and a reading that holds no record of one of ``names`` is taken again,
    up to ``PROFILE_ATTEMPTS`` times, then is "not measured"
    (``profiler_misses``: the readings dropped)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        rec = _profiled_device_ms(fn, names, reps)
        if rec["kernels"] and (names is None or all(n in rec["kernels"] for n in names)):
            return dict(rec, profiler_misses=attempt)
    return dict(rec, profiler_misses=PROFILE_ATTEMPTS,
                device_ms=f"not measured (the profiler held {rec['records']} records of "
                          f"{reps} calls, {PROFILE_ATTEMPTS} readings)")


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


def fit_ten_steps(trainer, views, targets, method="fit") -> tuple[list, list, dict, float]:
    """The training path: ``Trainer.fit`` (or ``method``, e.g.
    ``fit_scan``; or a ``ShardedTrainer``'s, ``views`` then stacked cameras
    and ``targets`` a stack) for 10 steps, in three calls (4, 4 and 2
    steps) so that every step's entry total is checked against the capacity
    it ran with. Every kernel's count is set to 0 just before and read just
    after. Returns the history, the segments, the launches and the
    seconds."""
    kernels = all_kernels()
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    start_time = time.perf_counter()
    history, segments = [], []
    for steps in (4, 4, 2):
        # A sharded trainer's totals are a slab's, held to the slab's capacity.
        capacity = (trainer._get_step().capacity if hasattr(trainer, "mesh")
                    else trainer._entry_capacity)
        points = trainer.scene.point_count
        part = getattr(trainer, method)(views, targets, steps)
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
    ctx["proj"], ctx["tcx"], ctx["tcy"], ctx["expand_full"] = proj, tcx, tcy, full
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
    ctx["raster_inputs"], ctx["raster_full"] = (rows, ids, ranges, tcx), full
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


#: Views a call in the serving comparisons: one, and the five bench views.
SERVING_VIEW_COUNTS = (1, 5)


def serving_graph(ctx, outs) -> dict:
    """``render_views`` through the graph, the slice's main path: the five
    bench views in both modes, three calls each (the warm-up, the capture
    and a replay), every call bit for bit the eager ``render`` outputs
    ``outs`` in all five fields, one capture and two replays, A's and B's
    launches (``launches``; ``by_replay`` of them), and the memory each
    mode keeps: ``static_bytes`` (the camera buffer, the ref and the static
    outputs, made by the warm-up) and ``graph_pool_bytes`` (what the
    capture adds to ``torch.cuda.memory_reserved`` after ``empty_cache``).
    Then the eager loop against the graph at 1 and 5 views a call: ms a
    view (median of 5 CUDA-event timings of a call), and the
    profiler's wall and device-busy ms a call, idle share, kernels and host
    launches a call; a steady-state call must make one graph launch and
    launch no kernel from the host."""
    import gc

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.ops.expand import EXPAND
    from gausplat_tpu_torch.ops.rasterize import RASTERIZE_FORWARD
    from gausplat_tpu_torch.render.pipeline import _render_views_eager
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options, dev = ctx["scene"], ctx["views"], ctx["options"], ctx["device"]
    kernels = (EXPAND, RASTERIZE_FORWARD)
    graph = views_graph("render_views", dev)
    want = [torch.stack([getattr(o, f) for o in outs]) for f in T.RenderOutput._fields]

    def settle() -> int:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    out = dict(launches={k.entry: 0 for k in kernels}, by_replay={k.entry: 0 for k in kernels})
    for mode in ("vmap", "map"):
        graph.release()
        reserved = [settle()]
        for kernel in kernels:
            kernel.launches = 0
        for call in ("warm_up", "capture", "replay"):
            got = T.render_views(scene, views, options, mode=mode)
            same = {f: bool(torch.equal(a, b)) for f, a, b in zip(got._fields, got, want)}
            check(all(same.values()), f"render_views ({mode}, {call}) through the graph "
                  f"differs from render: {same}")
            del got
            reserved.append(settle())
        for kernel in kernels:
            out["launches"][kernel.entry] += kernel.launches
            out["by_replay"][kernel.entry] += graph.graph.replays * graph.graph.launches[kernel]
        counts = (graph.graph.captures, graph.graph.replays)
        check(counts == (1, 2), f"render_views ({mode}): captures and replays {counts}")
        out[mode] = dict(bit_for_bit=True, captures=counts[0], replays=counts[1],
                         static_bytes=nbytes(graph.rows, graph.ref, *graph.outputs),
                         warm_up_reserved_bytes=reserved[1] - reserved[0],
                         graph_pool_bytes=reserved[2] - reserved[1],
                         replay_reserved_bytes=reserved[3] - reserved[2])
    check(all(out["by_replay"][k.entry] == 2 * 2 * len(views) for k in kernels),
          f"A and B by replay: {out['by_replay']}")

    # The eager loop against the graph, at 1 and 5 views a call.
    timing = {}
    for count in SERVING_VIEW_COUNTS:
        some = views[:count]
        runs = {"eager": lambda: _render_views_eager(scene, some, options, "vmap", None)}
        for mode in ("vmap", "map") if count > 1 else ("vmap",):
            runs[f"graph_{mode}"] = (
                lambda mode=mode: T.render_views(scene, some, options, mode=mode))
        for name, run in runs.items():
            run()
            run()  # a graph's key changed with the count: the warm-up, then the capture
            ms, ms_all = cuda_ms(run)
            try:
                prof = profile_device_time(run)
            except RuntimeError as e:  # the profiler is a measurement, not the path
                prof = dict(device_busy_ms=f"not measured ({e})")
            rec = dict(ms_per_view=ms / count, ms_all=ms_all, **{
                k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                         "kernel_launches", "host_launches", "host_calls")})
            timing[f"{name}_{count}_views"] = rec
            if name.startswith("graph") and "host_calls" in prof:
                calls = prof["host_calls"]
                graphs = sum(n for k, n in calls.items() if "GraphLaunch" in k)
                check(graphs == 1 and kernel_calls(prof) == 0,
                      f"a steady-state {name} call of {count} views: {calls}")
    out["timing"] = timing
    return out


#: Host calls that a steady-state call of a per-call entry point through
#: its graph may make: the graph launch, the copies in and the copies out.
ENTRY_HOST_CALLS_MAX = 10


def host_wall_ms(fn) -> float:
    """Host wall ms of one call of ``fn``, the device drained before and
    after it."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def kernel_calls(prof) -> float:
    """The host's kernel launches a call in a :func:`profile_device_time`
    record (graph launches and copies not counted)."""
    return sum(n for k, n in prof.get("host_calls", {}).items() if "LaunchKernel" in k)


def check_steady_call(prof, what) -> None:
    """A steady-state call through a graph (the profile of it): one graph
    launch, no kernel launched from the host, at most
    ``ENTRY_HOST_CALLS_MAX`` host calls."""
    if "host_calls" not in prof:  # the profiler is a measurement, not the path
        return
    calls = prof["host_calls"]
    graphs = sum(n for k, n in calls.items() if "GraphLaunch" in k)
    check(graphs == 1 and kernel_calls(prof) == 0
          and prof["host_launches"] <= ENTRY_HOST_CALLS_MAX,
          f"a steady-state call of {what}: {calls}")


def timed_calls(runs, graph_names, reps: int = REPS) -> dict:
    """Each of ``runs`` (name: call) timed: ms a call (median of ``reps``
    CUDA-event timings) and the profiler's wall and busy ms, idle share,
    kernels and host calls a call; the runs named in ``graph_names`` must
    be steady-state graph calls (:func:`check_steady_call`)."""
    timing = {}
    for name, run in runs.items():
        ms, ms_all = cuda_ms(run, reps)
        try:
            prof = profile_device_time(run)
        except RuntimeError as e:  # the profiler is a measurement, not the path
            prof = dict(device_busy_ms=f"not measured ({e})")
        timing[name] = dict(ms=ms, ms_all=ms_all, **{
            k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                     "kernel_launches", "host_launches", "host_calls")})
        if name in graph_names:
            check_steady_call(prof, name)
    return timing


def miss_cost(graph, call, eager_call) -> dict:
    """The cost of a graph's miss: host wall ms (device drained around
    each) of the warm-up call and of the capture call after ``graph`` (a
    ViewsGraph) is released, against an eager call's and a replay's
    (medians of 3)."""
    eager_ms = statistics.median(host_wall_ms(eager_call) for _ in range(3))
    graph.release()
    warm_up_ms = host_wall_ms(call)
    capture_ms = host_wall_ms(call)
    replay_ms = statistics.median(host_wall_ms(call) for _ in range(3))
    check((graph.graph.captures, graph.graph.replays) == (1, 4),
          f"the miss cost's calls: captures and replays "
          f"{(graph.graph.captures, graph.graph.replays)}")
    return dict(eager_call_ms=eager_ms, warm_up_ms=warm_up_ms, capture_ms=capture_ms,
                replay_call_ms=replay_ms)


@torch.no_grad()
def entry_graphs(ctx) -> dict:
    """The per-call serving entry points through their graphs against their
    eager forms, on the serving scene: ``render`` of the bench view and
    ``count_tile_entries`` of the 5 views. For each, the miss cost
    (:func:`miss_cost`); ms a call through the graph and eager, and for
    ``render`` also a new view every call (the cameras cycle over the 5
    views: replays, one capture), with the profiler's busy ms, idle share
    and host calls (:func:`timed_calls`); every count through the graph
    equal to the eager count."""
    import itertools

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.render.pipeline import _count_tile_entries_eager, _render_eager
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options, dev = ctx["scene"], ctx["views"], ctx["options"], ctx["device"]
    view = views[0]
    out = {}
    graph = views_graph("render", dev)
    out["render_miss"] = miss_cost(graph, lambda: T.render(scene, view, options),
                                   lambda: _render_eager(scene, view, options))
    cycle = itertools.cycle(views)
    out["render_timing"] = timed_calls(
        {"eager": lambda: _render_eager(scene, view, options),
         "graph": lambda: T.render(scene, view, options),
         "graph_new_view": lambda: T.render(scene, next(cycle), options)},
        ("graph", "graph_new_view"))
    check(graph.graph.captures == 1, f"a change of view recaptured: {graph.graph.captures}")
    out["render_graph"] = dict(captures=graph.graph.captures, replays=graph.graph.replays)

    graph = views_graph("count_tile_entries", dev)
    graph.release()
    counts = [T.count_tile_entries(scene, v, options) for v in views]
    eager = [_count_tile_entries_eager(scene, v, options) for v in views]
    check(counts == eager, f"count_tile_entries through its graph {counts}, eager {eager}")
    check((graph.graph.captures, graph.graph.replays) == (1, len(views) - 1),
          f"count_tile_entries: captures and replays "
          f"{(graph.graph.captures, graph.graph.replays)}")
    out["count_tile_entries"] = dict(counts=counts, eager_counts=eager, bit_for_bit=True)
    out["count_miss"] = miss_cost(graph, lambda: T.count_tile_entries(scene, view, options),
                                  lambda: _count_tile_entries_eager(scene, view, options))
    out["count_timing"] = timed_calls(
        {"eager": lambda: _count_tile_entries_eager(scene, view, options),
         "graph": lambda: T.count_tile_entries(scene, view, options)}, ("graph",))
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
    from gausplat_tpu_torch.render.pipeline import _render_eager
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options = ctx["scene"], ctx["views"], ctx["options"]
    kernels = (EXPAND, RASTERIZE_FORWARD)
    graph = views_graph("render", ctx["device"])
    graph.release()

    # The main path: render through its graph (the warm-up, the capture,
    # then a replay for each new view), then render_views.
    for kernel in kernels:
        kernel.launches = 0
    start = time.perf_counter()
    outs = [T.render(scene, view, options) for view in views]
    torch.cuda.synchronize()
    render_launches = {k.entry: k.launches for k in kernels}
    batched = T.render_views(scene, views, options)
    torch.cuda.synchronize()
    serve_seconds = time.perf_counter() - start
    launches = {kernel.source.name: kernel.launches for kernel in kernels}
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")
    check(all(n == len(views) for n in render_launches.values()),
          f"render through its graph: A and B launched {render_launches}, not once a view")
    render_graph = dict(captures=graph.graph.captures, replays=graph.graph.replays,
                        launches=render_launches,
                        by_replay={k.entry: graph.graph.by_replay.get(k, 0) for k in kernels})
    check((render_graph["captures"], render_graph["replays"]) == (1, len(views) - 1),
          f"render through its graph: {render_graph}")
    eager_outs = [_render_eager(scene, view, options) for view in views]
    for i, (o, e) in enumerate(zip(outs, eager_outs)):
        same = {f: bool(torch.equal(a, b)) for f, a, b in zip(o._fields, o, e)}
        check(all(same.values()),
              f"render through its graph (call {i}) differs from the eager render: {same}")
    render_graph["bit_for_bit"] = True
    del eager_outs

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

    # Timings at the main path's shapes (these launches are not counted
    # above); the render's is its eager form's.
    view = views[0]
    render_ms, render_all = cuda_ms(lambda: _render_eager(scene, view, options))
    plain_options = T.RenderOptions(tile_entry_capacity=capacity, backend="torch")
    plain_render_ms, plain_render_all = cuda_ms(
        lambda: _render_eager(scene, view, plain_options))
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
        breakdown = profile_device_time(lambda: _render_eager(scene, view, options))
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

    # render_views through the graph, its counts zeroed in serving_graph;
    # the per-call entry points through theirs. A and B join the kernels
    # line at the serving shapes, held to their plain versions on the bench
    # view by phases 2 and 3, with the launches of the main path's renders
    # and of serving_graph's calls.
    serving = serving_graph(ctx, outs)
    entry = entry_graphs(ctx)
    paths = (
        ("render_graph", f"main_path: render through its graph, {len(views)} views of the "
                         f"serving scene at 1920 x 1080 (the warm-up, then one capture "
                         f"and {len(views) - 1} replays)",
         render_graph["launches"], render_graph["by_replay"]),
        ("render_views_graph", f"main_path: render_views through the graph, {len(views)} "
                               f"views of the serving scene at 1920 x 1080, both modes, "
                               f"3 calls each", serving["launches"], serving["by_replay"]))
    for tag, path, path_launches, by_replay in paths:
        for name, kernel, ms, plain, device, bnd, err in (
                ("rasterize_forward", RASTERIZE_FORWARD, a_ms, a_plain_ms, a_device, a_bound,
                 max(ctx["raster_full"]["image_max_abs"],
                     ctx["raster_full"]["transmittance_max_abs"])),
                ("expand_point_orders", EXPAND, b_ms, b_plain_ms, b_device, b_bound,
                 ctx["expand_full"]["max_abs"])):
            ctx["kernels"].append(dict(
                name=f"{name}@{tag}", route="cuda",
                source=f"gausplat_tpu_torch/csrc/{kernel.source.name}", replaces=REPLACES[name],
                path=path, launches=path_launches[kernel.entry],
                launches_by_replay=by_replay[kernel.entry], max_abs_err=err, ms=ms,
                plain_ms=plain, device_ms=device["device_ms"], bound_ms=bnd["bound_ms"],
                bound_by=bnd["bound_by"], library_ms=None))
    return dict(
        card=ctx["card"], views=len(views), capacity=capacity, launches=launches,
        render_graph=render_graph, entry_graphs=entry, render_views_graph=serving,
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
    start = train_start_arrays(ctx["arrays"])
    scene = T.GaussianScene.from_numpy(**start, device=dev)
    options = T.calibrate_options(scene, views)
    config = train_config(options, views)
    extent = config.densify.scene_extent
    width, height = views[0].image_width, views[0].image_height

    # The eager baseline from the same start: the step launched op by op.
    eager = TT.Trainer(T.GaussianScene.from_numpy(**start, device=dev), width, height, config)
    eager_history, _, eager_launches, eager_seconds = fit_ten_steps(eager, views, targets,
                                                                    "_fit_eager")
    eager_params = params_of(eager.scene)
    del eager

    # The main path: Trainer.fit, each step one replay of its graph.
    trainer = TT.Trainer(scene, width, height, config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history, segments, all_launches, fit_seconds = fit_ten_steps(trainer, views, targets)
    launches = {kernel.source.name: all_launches[kernel.entry]
                for kernel in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_graph = trainer._step_graph
    fields = [name for name, _ in trainer.scene.named_parameters()]
    fit_graph = dict(
        captures=step_graph.captures, replays=step_graph.replays,
        launches_by_replay={k.entry: step_graph.by_replay.get(k, 0)
                            for k in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)},
        eager_launches=eager_launches, eager_seconds=eager_seconds,
        differing_fields=[f for f, a, b in zip(fields, params_of(trainer.scene), eager_params)
                          if not torch.equal(a, b)],
        differing_steps=[i for i, (a, b) in enumerate(zip(history, eager_history)) if a != b])
    del eager_params
    check(step_graph.captures >= 1 and step_graph.replays > 0,
          f"fit replayed no captured step: {fit_graph}")
    check(all_launches == eager_launches, f"fit's launches {all_launches}, eager {eager_launches}")
    check(not fit_graph["differing_fields"] and not fit_graph["differing_steps"],
          f"fit through its graphs differs from the eager fit: {fit_graph}")
    fit_graph["bit_for_bit"] = True

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
    by_replay = {k.source.name: fit_graph["launches_by_replay"][k.entry]
                 for k in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)}
    ctx["kernels"] += [
        dict(name=name, route="cuda", source=f"gausplat_tpu_torch/csrc/{source}",
             replaces=replaces, launches=launches[source],
             launches_by_replay=by_replay[source], max_abs_err=errors[name],
             ms=times[name][0][0], plain_ms=times[name][1][0],
             device_ms=devices[name]["device_ms"],
             bound_ms=bounds[name]["bound_ms"], bound_by=bounds[name]["bound_by"],
             library_ms=None, **extra.get(name, {}))
        for name, source, replaces in kernel_rows
    ]

    # A step with no host event (no densify, no overflow read), eager and
    # through its graph.
    trainer.config = dataclasses.replace(trainer.config, densify_until=0,
                                         overflow_check_interval=10**9)
    step_ms, step_all = cuda_ms(lambda: trainer._train_step_eager(view, target))
    try:
        breakdown = profile_device_time(lambda: trainer._train_step_eager(view, target))
    except RuntimeError as e:  # the profiler is a measurement, not the path
        breakdown = dict(device_busy_ms=f"not measured ({e})")
    graph_step = timed_calls({"graph": lambda: trainer.train_step(view, target)}, ("graph",))

    return dict(
        card=ctx["card"], steps=len(history), launches=launches, losses=losses,
        psnr=[h["psnr"] for h in history], tile_point_total=[int(h["tile_point_total"])
                                                          for h in history],
        segments=segments, densify=densify, start_capacity=options.tile_entry_capacity,
        scene_extent=extent, loss_first=losses[0], loss_before_reset=losses[reset - 1],
        loss_last=losses[-1],
        fit_10_steps_seconds=fit_seconds, peak_memory_gb=peak_gb, fit_graph=fit_graph,
        forward_backward_ms=fwd_bwd_ms, forward_backward_ms_all=fwd_bwd_all,
        step_ms=step_ms, step_ms_all=step_all, graph_step=graph_step["graph"],
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
    ``GaussianScene.from_points`` and ``Trainer.fit_scan`` (the fit of
    ``train_from_colmap``) with packed bf16 entry rows, so packed A and C
    run inside the captured step; then the packed kernels A and C at the
    step's shapes."""
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
    history, segments, launches, fit_seconds = fit_ten_steps(trainer, loaded, targets,
                                                             "fit_scan")
    graph = dict(captures=trainer._graph.captures, replays=trainer._graph.replays)
    check(graph["replays"] > 0, f"the bf16 fit replayed no captured step: {graph}")

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
        steps=len(history), launches=launches, graph=graph, losses=losses,
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


def params_digest(params) -> str:
    """SHA-256 of a scene's parameter tensors, in order."""
    import hashlib

    digest = hashlib.sha256()
    for p in params:
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


def mesh4k_record(out, single) -> dict:
    """The 4K frame put together from its slabs (``out``) against the
    single-device render (``single``), with the gates of the parallel
    phase's part (b): finite, the radii equal, at most
    ``MESH4K_PIXEL_SHARE`` of the pixels beyond 1e-4, the frame's entries
    within the capacity."""
    diff = (out.colors_rgb_2d - single.colors_rgb_2d).abs().amax(dim=-1)
    m = dict(
        image=[MESH4K_WIDTH, MESH4K_HEIGHT], points=MESH4K_POINTS, slabs=MESH4K_SLABS,
        visible_points=int((single.radii > 0).sum()),
        total_entries=int(single.tile_point_total), capacity=MESH4K_CAPACITY,
        max_abs_diff=float(diff.max()), share_beyond_1e4=float((diff > 1e-4).double().mean()),
        pixels_differing=int((diff > 0).sum()),
        transmittance_max_abs=max_abs(out.transmittances, single.transmittances),
        count_mismatches=int((out.point_rendered_counts != single.point_rendered_counts).sum()),
        radii_equal=bool(torch.equal(out.radii, single.radii)),
        finite=bool(torch.isfinite(out.colors_rgb_2d).all()),
        image_mean=float(out.colors_rgb_2d.mean()))
    check(m["finite"] and m["radii_equal"] and m["share_beyond_1e4"] <= MESH4K_PIXEL_SHARE
          and m["total_entries"] <= MESH4K_CAPACITY,
          f"the 4K slabs differ from the single-device render: {m}")
    return m


def step_reference(T, scene, views, targets) -> tuple[dict, int]:
    """The single-device reference of the (2, 2) step: the loss and the
    gradients of the views' mean photometric loss on the card (on the host,
    to be saved), and the step's capacity: twice the calibrated budget, so
    that each of the two slabs gets it whole."""
    from gausplat_tpu_torch import train as TT

    single_options = T.calibrate_options(scene, views)
    ref = torch.zeros(scene.point_count, device=scene.device, requires_grad=True)
    loss = sum(TT.photometric_loss(T.render(scene, v, single_options, ref).colors_rgb_2d, t)
               for v, t in zip(views, targets)) / len(views)
    params = list(scene.named_parameters())
    *grads, grad_norm = torch.autograd.grad(loss, [p for _, p in params] + [ref])
    reference = dict(loss=float(loss.detach()), grad_norm=grad_norm.cpu(),
                     grads={n: g.cpu() for (n, _), g in zip(params, grads)})
    return reference, 2 * single_options.tile_entry_capacity


def step_record(got, want, h_pad) -> dict:
    """The (2, 2) step's loss and gradients (``loss_and_grads``) against
    the single-device ``want`` of :func:`step_reference`: the loss within
    2e-4 relative, every gradient within ``GRAD_SCALED_ATOL`` scaled."""
    dev = got["loss"].device
    errors = {f: scaled_err(g, want["grads"][f].to(dev)) for f, g in got["grads"].items()}
    errors["grad_norm_sum"] = scaled_err(got["grad_norm"], want["grad_norm"].to(dev))
    rec = dict(loss=float(got["loss"]), loss_single=want["loss"],
               loss_rel_err=abs(float(got["loss"]) - want["loss"]) / want["loss"],
               scaled_err=errors, h_pad=h_pad)
    check(rec["loss_rel_err"] <= 2e-4 and max(errors.values()) <= GRAD_SCALED_ATOL,
          f"the sharded step differs from the single-device one: {rec}")
    return rec


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
    from gausplat_tpu_torch.parallel import (
        make_mesh, render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.parallel.render import _data_parallel_eager, _tile_sharded_eager
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
        rec["mesh4k"] = mesh4k_record(out, single)
        del single
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
        rec["step"] = step_record(got, torch.load(out_dir / "reference.pt", weights_only=True),
                                  h_pad)
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
                      points=trainer.scene.point_count,
                      digest=params_digest(trainer.scene.parameters()))
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
        device = kernel_device_ms(run, kernel)
        timings[name] = dict(ms=cuda_ms(run)[0], plain_ms=cuda_ms(plain)[0],
                             device_ms=device["device_ms"],
                             device_records=device["records"],
                             profiler_misses=device["profiler_misses"],
                             bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                             max_abs_err=err, kernel=kernel)
    rec = dict(slab=list(slab), capacity=capacity, entries=int(ranges[:, 1].max()),
               blended_pairs=blended, rasterize_forward=a_rec, expand_point_orders=b_rec,
               rasterize_backward=c_rec,
               valid_rows=max(0, min(slab[1], view.image_height - slab[0])))
    return rec, timings


def add_kernel_rows(ctx, timings, tag, path, launches) -> None:
    """Append one row of the kernels line per kernel of ``timings`` (as
    :func:`slab_kernel_records` returns them), named ``<kernel>@<tag>``,
    with ``launches`` (by entry point) from the run of the path they stand
    for."""
    for name, t in timings.items():
        kernel = t.pop("kernel")
        ctx["kernels"].append(dict(
            name=f"{name}@{tag}", route="cuda",
            source=f"gausplat_tpu_torch/csrc/{kernel.source.name}", replaces=REPLACES[name],
            path=path, launches=launches[kernel.entry], library_ms=None, **t))


def check_live(rec, tag) -> None:
    """A comparison of :func:`slab_kernel_records` held A, B and C to their
    plain versions on entries that blend, not on an empty frame only."""
    check(rec["entries"] > 0 and rec["blended_pairs"] > 0
          and rec["rasterize_backward"]["valid_slots"] > 0,
          f"{tag}: the kernels were compared on no blending entry: entries {rec['entries']}, "
          f"blended pairs {rec['blended_pairs']}")


def graph_against_eager(name, graph_call, eager_call, reps: int = REPS) -> dict:
    """A sharded serving call through its graph (``graph_call``: the public
    entry point under no grad, views_graph ``name``) against the same call's
    eager form (``eager_call``) on this rank: three graph calls (the
    warm-up, the capture, a replay), each bit for bit the eager outputs in
    all five fields, one capture and two replays, A's and B's launches of
    those calls, then both timed (median of ``reps`` CUDA-event timings of
    a call). Every rank of the mesh makes the same calls in the same order.
    Returns the record and the eager outputs."""
    from gausplat_tpu_torch.render.views_graph import views_graph

    kernels = all_kernels()
    graph = views_graph(name, torch.device("cuda", torch.cuda.current_device()))
    graph.release()
    with torch.no_grad():
        want = eager_call()
        for kernel in kernels:
            kernel.launches = 0
        same = []
        for _ in range(3):
            got = graph_call()
            same.append({f: bool(torch.equal(a, b)) for f, a, b in zip(got._fields, got, want)})
        torch.cuda.synchronize()
        launches = {k.entry: k.launches for k in kernels}
        counts = (graph.graph.captures, graph.graph.replays)
        check(all(all(x.values()) for x in same),
              f"{name} through its graph differs from the eager call: {same}")
        check(counts == (1, 2), f"{name}: captures and replays {counts}")
        check(all(launches[k] > 0 for k in PATH[:2]), f"{name}: A or B never ran: {launches}")
        by_replay = {k.entry: 2 * graph.graph.launches.get(k, 0) for k in kernels}
        eager_ms, eager_all = cuda_ms(eager_call, reps)
        graph_ms, graph_all = cuda_ms(graph_call, reps)
    graph.release()  # before its process group goes
    return dict(bit_for_bit=True, captures=counts[0], replays=counts[1], launches=launches,
                launches_by_replay=by_replay,
                eager_ms=eager_ms, eager_ms_all=eager_all, graph_ms=graph_ms,
                graph_ms_all=graph_all), want


def phase_parallel(ctx):
    """Multi-device render and training on torch.distributed: (a) one NCCL
    rank, (b) the 4K frame in 4 gloo slabs, (c) the (2, 2) sharded step and
    trainer, then A, B and C on slab 0 and the last slab of the step."""
    import tempfile

    import torch.distributed as dist

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel import (
        make_mesh, render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.parallel.render import (
        _data_parallel_eager, _shard_capacity, _tile_sharded_eager, slab_rows,
    )
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

        # Serving on the NCCL rank: render_data_parallel of the 4 orbit views
        # and render_tile_sharded of the bench view, each captured with its
        # collectives, bit for bit the eager call.
        grid = make_mesh((1, 1), ("data", "tiles"))
        scene, options = ctx["scene"], ctx["options"]
        cams = stack_cameras(ctx["views"][1:], device=dev)
        w, h = view.image_width, view.image_height
        result["nccl_world_1_graph"] = {
            "render_data_parallel": graph_against_eager(
                "parallel.render_data_parallel",
                lambda: render_data_parallel(scene, cams, w, h, grid, "data", options),
                lambda: _data_parallel_eager(scene, cams, w, h, grid, "data", options, None))[0],
            "render_tile_sharded": graph_against_eager(
                "parallel.render_tile_sharded",
                lambda: render_tile_sharded(scene, view, grid, "tiles", options),
                lambda: _tile_sharded_eager(scene, view, grid, "tiles", options, None))[0],
        }
    finally:
        dist.destroy_process_group()

    # (c)'s single-device reference: the loss and gradients of the 4 orbit
    # views' mean photometric loss, on the card, before the ranks start.
    views = ctx["views"][1:]
    targets = ctx["targets"][1:]
    scene = T.GaussianScene.from_numpy(**train_start_arrays(arrays), device=dev)
    reference, step_capacity = step_reference(T, scene, views, targets)
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
        add_kernel_rows(ctx, timings, tag,
                        f"parallel: {tag} ({index * h_local}-{(index + 1) * h_local - 1} of "
                        f"{h_pad} rows) of the (2, 2) sharded step, 1920 x {h_local}", launches)

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
#: The record's own densify interval (its point count changes only in
#: chunks that hold a multiple of 500).
LEGO_DENSIFY_INTERVAL = 500
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
    from gausplat_tpu_torch.scene.gaussian_3d import PARAM_DIMS
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
        setup = long_fit_setup(True, True, dev, iterations=LEGO_STEPS,
                               densify_interval=LEGO_DENSIFY_INTERVAL)
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
            setup_seconds=setup_seconds, seconds=lego_seconds, launches=launches,
            densify_interval=LEGO_DENSIFY_INTERVAL, curve=curve,
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
        add_kernel_rows(ctx, timings, "lego_fit",
                        f"tools (d): view 0 of the lego fit after {LEGO_STEPS} steps, "
                        f"{trainer.scene.point_count} points, 800 x 800", launches)

        # A lego step with no host event (after the counts were read): its
        # time and where it goes.
        trainer.config = dataclasses.replace(trainer.config, densify_until=0,
                                             overflow_check_interval=10**9)
        target = setup["targets"][0]
        step_ms, step_all = cuda_ms(lambda: trainer._train_step_eager(lego_view, target))
        try:
            breakdown = profile_device_time(lambda: trainer._train_step_eager(lego_view, target))
        except RuntimeError as e:  # the profiler is a measurement, not the path
            breakdown = dict(device_busy_ms=f"not measured ({e})")
        out["lego_fit"].update(step_ms=step_ms, step_ms_all=step_all, step_profile=breakdown)
        ctx["lego"] = dict(trainer=trainer, views=setup["views"], targets=setup["targets"],
                           record=out["lego_fit"])
        ctx["lego_grad"] = dict(  # the fitted scene, for phase render_grad
            arrays={f: getattr(trainer.scene, f).detach().cpu().numpy() for f in PARAM_DIMS},
            views=setup["views"], targets=setup["targets"], options=trainer._options())

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


# --- phase 13: the scripts ---------------------------------------------------------

CONVERGENCE_STEPS = 1_500
#: Cut from the JAX script's 600: at 600 the phase ran 351 s on an NVIDIA
#: H100 80GB HBM3 (700 W), past its 5-minute budget (8 ranks share the card
#: over gloo).
SHARDED_COMPARE_STEPS = 300
PATH = ("gs_expand_point_orders", "gs_rasterize_forward", "gs_rasterize_backward")


def mesh_scale_slab_records(ctx, n, index, launches) -> dict:
    """A, B and C on slab ``index`` of ``mesh_scale``'s step at n ranks, from
    the step's start scene and its first view, against their plain versions
    (as at full size; on a slab wholly below the image, besides, the entry
    total and every rendered count exact, and elsewhere entries that
    blend), timed; appended to the kernels line as ``<kernel>@pad_slab`` or
    ``<kernel>@mesh_scale_slab<index>`` with ``launches``, the step's on
    the ranks of that slab."""
    from gausplat_tpu_torch.parallel.render import _shard_capacity, slab_rows
    from gausplat_tpu_torch.render.pipeline import _capacity
    from gausplat_tpu_torch.scripts import mesh_scale as MS

    dev = ctx["device"]
    d_tiles = n // MS.D_DATA
    height = MS.parity_height(n)
    options = MS.PARITY_OPTIONS
    scene = MS.parity_scene(dev)
    view = MS.parity_views(height)[0]
    h_local, h_pad = slab_rows(height, d_tiles)
    slab = (index * h_local, h_local)
    pad = slab[0] >= height
    tag = "pad_slab" if pad else f"mesh_scale_slab{index}"
    capacity = _shard_capacity(_capacity(scene.point_count, options), d_tiles,
                               options.block_size)
    rec, timings = slab_kernel_records(scene, view, slab, capacity, dev, tag)
    if pad:
        check(all(rec["expand_point_orders"]["bit_identical"])
              and rec["rasterize_forward"]["count_mismatches"] == 0,
              f"pad slab: the entry total or a rendered count differs: {rec}")
    else:
        check_live(rec, tag)
    add_kernel_rows(ctx, timings, tag,
                    f"scripts (c): slab {index} (rows {slab[0]}-{slab[0] + h_local - 1} of "
                    f"{h_pad}, the image {height} rows) of mesh_scale's step at {n} ranks, "
                    f"{view.image_width} x {h_local}", launches)
    return rec


def phase_scripts(ctx):
    """(a) ``train_convergence`` at 1,500 steps, (b) ``train_sharded_compare``
    at 300 steps (cut from the script's 600; 8 gloo ranks on this card),
    (c) ``mesh_scale`` at 8, 16 and 32 ranks. Kernels A, B and C are held
    to their plain versions at each part's shapes: view 0 of (a)'s fitted
    scene, slab 0 of (b)'s sharded scene, and at 8 ranks slab 0 of (c)'s
    step and its slab that lies wholly in the padding."""
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel.render import _shard_capacity, slab_rows
    from gausplat_tpu_torch.render.pipeline import _capacity
    from gausplat_tpu_torch.scripts import mesh_scale as MS
    from gausplat_tpu_torch.scripts import train_sharded_compare as SC
    from gausplat_tpu_torch.scripts.train_convergence import train_convergence

    dev = ctx["device"]
    out = {}

    def log(line):
        print(line, flush=True)

    # (a) The convergence fit: finite, improving, growing, through A, B and
    # C. Its launches are the fit's, not the target renders'.
    emit("scripts_train_convergence_start", 0.0, steps=CONVERGENCE_STEPS)
    conv, _, seconds = counted(lambda: train_convergence(CONVERGENCE_STEPS, dev, log))
    launches = conv["launches"]
    losses = [h["loss"] for h in conv["history"]]
    check(all(math.isfinite(x) for x in losses), "train_convergence: a non-finite loss")
    check(conv["curve"][-1]["psnr"] > conv["curve"][0]["psnr"],
          f"train_convergence did not improve: {conv['curve']}")
    check(conv["points_end"] > conv["points_start"],
          f"train_convergence: no growth ({conv['points_start']} -> {conv['points_end']})")
    check(all(launches[k] > 0 for k in PATH), f"train_convergence: a kernel never ran: {launches}")
    trainer, view = conv["trainer"], conv["views"][0]
    rec, timings = slab_kernel_records(trainer.scene, view, (0, view.image_height),
                                       trainer._entry_capacity, dev, "convergence")
    check_live(rec, "convergence")
    add_kernel_rows(ctx, timings, "convergence",
                    f"scripts (a): view 0 of train_convergence after {CONVERGENCE_STEPS} steps, "
                    f"{trainer.scene.point_count} points, {view.image_width} x "
                    f"{view.image_height}", launches)
    out["train_convergence"] = dict(
        steps=CONVERGENCE_STEPS, seconds=seconds, fit_seconds=conv["fit_seconds"],
        ms_per_step=conv["fit_seconds"] * 1e3 / CONVERGENCE_STEPS, launches=launches,
        curve=conv["curve"], points_start=conv["points_start"], points_end=conv["points_end"],
        kernels=rec)
    del conv, trainer

    # (b) Sharded against single-device training, the JAX script's claim.
    emit("scripts_train_sharded_compare_start", 0.0, steps=SHARDED_COMPARE_STEPS,
         ranks=SC.RANKS, mesh=list(SC.MESH), backend="gloo", device=str(dev))
    result, _, seconds = counted(lambda: SC.compare(SHARDED_COMPARE_STEPS, dev, log))
    single, sharded = result["single"], result["sharded"]
    check(result["delta_db"] <= SC.MAX_DELTA_DB,
          f"train_sharded_compare: delta_db {result['delta_db']} > {SC.MAX_DELTA_DB}")
    check(all(math.isfinite(x) for x in single["losses"] + sharded["losses"]),
          "train_sharded_compare: a non-finite loss")
    check(all(single["launches"][k] > 0 and sharded["launches"][k] > 0 for k in PATH),
          f"train_sharded_compare: a kernel never ran: {single['launches']}, "
          f"{sharded['launches']}")
    scene = T.GaussianScene.from_numpy(**sharded["scene"], device=dev)
    view = SC.compare_views()[0]
    h_local, h_pad = slab_rows(SC.SIZE, SC.MESH[1])
    capacity = _shard_capacity(_capacity(scene.point_count, SC.OPTIONS), SC.MESH[1],
                               SC.OPTIONS.block_size)
    rec, timings = slab_kernel_records(scene, view, (0, h_local), capacity, dev,
                                       "sharded_compare_slab0")
    check_live(rec, "sharded_compare_slab0")
    add_kernel_rows(ctx, timings, "sharded_compare_slab0",
                    f"scripts (b): slab 0 (rows 0-{h_local - 1} of {h_pad}) of view 0 of "
                    f"train_sharded_compare's sharded scene after {SHARDED_COMPARE_STEPS} steps, "
                    f"{scene.point_count} points, {SC.SIZE} x {h_local}",
                    sharded["slab_launches"][0])
    out["train_sharded_compare"] = dict(
        steps=SHARDED_COMPARE_STEPS,
        steps_note=("the JAX script's default" if SHARDED_COMPARE_STEPS == 600
                    else f"cut from the JAX script's 600 to {SHARDED_COMPARE_STEPS}"),
        seconds=seconds, delta_db=result["delta_db"], single_batched_psnr=single["psnr"],
        sharded_psnr=sharded["psnr"], points=[single["points"], sharded["points"]],
        single_ms_per_step=single["seconds"] * 1e3 / SHARDED_COMPARE_STEPS,
        sharded_rank_ms_per_step=[t * 1e3 / SHARDED_COMPARE_STEPS
                                  for t in sharded["rank_seconds"]],
        first_losses=[single["losses"][:3], sharded["losses"][:3]],
        last_losses=[single["losses"][-1], sharded["losses"][-1]],
        single_launches=single["launches"], sharded_launches=sharded["launches"],
        sharded_slab_launches=sharded["slab_launches"], kernels=rec,
        wall_note="8 ranks share one card over gloo: not scaling numbers")
    del result, single, sharded, scene

    # (c) The mesh-scale sweep, each n's ranks on this card over gloo.
    emit("scripts_mesh_scale_start", 0.0, ranks=list(MS.SWEEP), backend="gloo",
         device=str(dev))
    sweep, _, seconds = counted(lambda: MS.sweep(dev, log=log))
    for rec in sweep:
        check(all(rec["launches"][k] > 0 and rec["dryrun_launches"][k] > 0
                  and all(rec["slab_launches"][i][k] > 0 for i in rec["pad_slabs"])
                  for k in PATH),
              f"mesh_scale at {rec['n']}: a kernel never ran: {rec}")
    out["mesh_scale"] = dict(seconds=seconds, sweep=sweep)
    n, (pad,) = sweep[0]["n"], sweep[0]["pad_slabs"]
    out["mesh_scale_slab0"] = mesh_scale_slab_records(ctx, n, 0, sweep[0]["slab_launches"][0])
    out["pad_slab"] = mesh_scale_slab_records(ctx, n, pad, sweep[0]["slab_launches"][pad])
    return dict(card=ctx["card"], **out)


# --- phase 14: the training step as a CUDA graph ------------------------------------

#: PR 8's eager 2,000-step lego prefix at interval 500 (its chip runs 1 and
#: 3-5, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
LEGO_EAGER_POINTS, LEGO_EAGER_PSNR = 4_114, 16.56
#: Steps of the steady-state comparison, and where they start: the SH
#: warm-up interval is raised to STEADY_SH_INTERVAL and the step count set to
#: three times it, so the steps run at SH degree 3 with no host event (a
#: smaller interval would put one at each of its multiples).
STEADY_STEPS = 20
STEADY_SH_INTERVAL = 1_000_000


def params_of(scene) -> list:
    return [p.detach().clone() for p in scene.parameters()]


def params_max_diff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


#: The steady state's three ways of running the same steps: the step
#: launched op by op, ``fit`` (each step one replay of train_step's graph)
#: and ``fit_scan`` (each step one replay of the chunk's graph).
STEADY_WAYS = (("eager", "_fit_eager"), ("fit", "fit"), ("fit_scan", "fit_scan"))


def steady_state(trainer, views, targets, reps: int = REPS, profile_steps: int = STEADY_STEPS,
                 profile_reps: int = 2) -> dict:
    """``STEADY_STEPS`` steps with no host event three ways
    (``STEADY_WAYS``): ms a step (median of ``reps`` CUDA-event timings of
    the whole call, the history's read included), the profiler's
    device-busy ms, idle share, kernels and host launches a step and the
    device ms a step of A, B and C by name (over ``profile_reps`` calls of
    ``profile_steps`` steps: the profiler's own processing grows with the
    kernels it saw), the peak memory of each, and the memory each graph's
    pool keeps. Then one replay of each graph with the host's sync checks
    set to raise. ``trainer`` is a ``Trainer`` (``views`` a list) or a
    ``ShardedTrainer`` (``views`` stacked cameras; then also the host ms of
    the ranks' miss decision, ``any_miss_ms``, which each ``fit`` step makes
    and each ``fit_scan`` chunk once); every rank of a sharded trainer
    makes the same calls in the same order."""
    import dataclasses
    import gc

    n = STEADY_STEPS
    trainer.config = dataclasses.replace(
        trainer.config, densify_until=0, overflow_check_interval=10**9,
        sh_warmup_interval=STEADY_SH_INTERVAL)
    trainer.step_count = 3 * STEADY_SH_INTERVAL
    check(trainer._sh_degree() == min(3, trainer.config.render.colors_sh_degree_max),
          "the steady state is not at the full SH degree")
    out = dict(steps=n, points=trainer.scene.point_count)
    for name, graph in (("fit_scan", trainer._graph), ("fit", trainer._step_graph)):
        graph.invalidate()
    for name, graph in (("fit_scan", trainer._graph), ("fit", trainer._step_graph)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        getattr(trainer, name)(views, targets, 2)  # the warm-up, then the capture
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out[f"{name}_graph_pool_gb"] = (torch.cuda.memory_reserved() - reserved) / 1e9
    names = [k for source in ("expand.cu", "rasterize_forward.cu", "rasterize_backward.cu")
             for k in DEVICE_KERNELS[source] if k != "Memset"]
    for name, method in STEADY_WAYS:
        run = lambda: getattr(trainer, method)(views, targets, n)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        ms, ms_all = cuda_ms(run, reps)
        try:
            prof = profile_device_time(
                lambda: getattr(trainer, method)(views, targets, profile_steps),
                reps=profile_reps, names=names)
        except RuntimeError as e:  # the profiler is a measurement, not the path
            prof = dict(device_busy_ms=f"not measured ({e})")
        per_step = {k: (v / profile_steps if isinstance(v, (int, float)) else v)
                    for k, v in prof.items()
                    if k in ("wall_ms", "device_busy_ms", "collective_ms", "kernel_launches",
                             "host_launches")}
        out[name] = dict(ms_per_step=ms / n, ms_all=ms_all, per_step=per_step,
                         profile_steps=profile_steps,
                         kernels_ms_per_step={k: v / profile_steps
                                              for k, v in prof.get("named", {}).items()},
                         device_idle_share=prof.get("device_idle_share"),
                         compute_idle_share=prof.get("compute_idle_share"),
                         host_calls=prof.get("host_calls"), top=prof.get("top"),
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if hasattr(trainer, "mesh"):
        torch.cuda.synchronize()
        out["any_miss_ms"] = statistics.median(
            host_wall_ms(lambda: trainer._any_rank_missed(False)) for _ in range(REPS))
    for name, graph in (("fit_scan", trainer._graph), ("fit", trainer._step_graph)):
        check(graph.graph is not None, f"{name} left no captured step")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    out["strict_replay"] = "no host read, either graph"
    return out


def phase_fit_scan(ctx):
    """``Trainer.fit_scan``: (a) the train phase's configuration at full
    size, 10 steps of the eager fit twice from one start (the card's
    spread), of ``fit`` through its graphs and of ``fit_scan`` (the path:
    its launches), the parameters held to the spread; A, B and C at the
    captured shapes against their plain versions (``<kernel>@fit_scan``,
    with their device time in fit's graph); (b) the steady state at those
    shapes three ways; (c) the tools phase's lego prefix, which ran through
    ``fit_scan``, beside the eager prefix's record (``LEGO_EAGER_POINTS``),
    and its steady state; (d) ``ShardedTrainer.fit_scan`` on one NCCL rank
    (:func:`sharded_nccl_fit_scan`)."""
    import gc

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT

    dev, views, targets = ctx["device"], ctx["views"], ctx["targets"]
    start = train_start_arrays(ctx["arrays"])
    width, height = views[0].image_width, views[0].image_height
    out = {}

    def trainer():
        scene = T.GaussianScene.from_numpy(**start, device=dev)
        return TT.Trainer(scene, width, height,
                          train_config(T.calibrate_options(scene, views), views))

    # (a) Two eager fits, then fit through its graphs and the captured
    # fit_scan, from the same start.
    finals, eager_seconds = [], []
    for _ in range(2):
        tr = trainer()
        history, _, _, seconds = fit_ten_steps(tr, views, targets, "_fit_eager")
        finals.append((params_of(tr.scene), tr.scene.point_count, history))
        eager_seconds.append(seconds)
        del tr
        gc.collect()
    graphed = trainer()
    fit_history, _, fit_launches, fit_seconds = fit_ten_steps(graphed, views, targets)
    fit_params = params_of(graphed.scene)
    fit_graph = dict(captures=graphed._step_graph.captures, replays=graphed._step_graph.replays,
                     points=graphed.scene.point_count)
    del graphed
    gc.collect()
    scan = trainer()
    history, segments, launches, scan_seconds = fit_ten_steps(scan, views, targets, "fit_scan")
    scan_by_replay = {k.source.name: scan._graph.by_replay.get(k, 0) for k in all_kernels()[:3]}
    spread = params_max_diff(finals[0][0], finals[1][0])
    diff = params_max_diff(params_of(scan.scene), finals[0][0])
    fit_diff = params_max_diff(fit_params, finals[0][0])
    points = [finals[0][1], finals[1][1], fit_graph["points"], scan.scene.point_count]
    graph = dict(captures=scan._graph.captures, replays=scan._graph.replays)
    check(len(set(points)) == 1, f"the point counts differ: {points}")
    check(diff <= spread, f"fit_scan's parameters differ by {diff}, beyond the spread {spread}")
    check(fit_diff <= spread and (spread > 0 or fit_history == finals[0][2]),
          f"fit through its graphs differs from the eager fit by {fit_diff} (spread {spread})")
    check(all(launches[k] == 10 for k in PATH), f"fit_scan's launches: {launches}")
    check(fit_launches == launches, f"fit's launches {fit_launches}, fit_scan's {launches}")
    check(graph["replays"] > 0 and fit_graph["replays"] > 0,
          f"fit_scan or fit replayed no captured step: {graph}, {fit_graph}")
    check(all(seg["max_total"] <= seg["capacity"] for seg in segments),
          f"entry overflow: {segments}")
    check(all(math.isfinite(h["loss"]) for h in history), "fit_scan: a non-finite loss")
    out["train_config"] = dict(
        points=points, spread=spread, max_abs_diff_from_fit=diff, launches=launches,
        graph=graph, losses=[h["loss"] for h in history], segments=segments,
        eager_seconds=eager_seconds, scan_seconds=scan_seconds,
        fit_graph=dict(fit_graph, max_abs_diff_from_eager=fit_diff, seconds=fit_seconds,
                       bit_for_bit=fit_diff == 0.0 and fit_history == finals[0][2]))
    del finals, fit_params
    gc.collect()

    # A, B and C at the captured shapes, then (b) the steady state there.
    opts = scan._options()
    rec, timings = slab_kernel_records(scan.scene, views[0], (0, height),
                                       opts.tile_entry_capacity, dev, "fit_scan")
    check_live(rec, "fit_scan")
    out["kernels"] = rec
    add_kernel_rows(ctx, timings, "fit_scan",
                    f"fit_scan (a): 10 steps of the train phase's configuration, "
                    f"{scan.scene.point_count} points, {width} x {height}, captured", launches)
    out["steady"] = steady_state(scan, views, targets)
    # A's, B's and C's launches by replay in (a), and their device time in
    # the captured step, from fit's graph in (b).
    for row in ctx["kernels"]:
        if row["name"].endswith("@fit_scan"):
            source = row["source"].rsplit("/", 1)[1]
            row["launches_by_replay"] = scan_by_replay[source]
            row["device_ms_in_graph"] = sum(
                out["steady"]["fit"]["kernels_ms_per_step"].get(k, 0.0)
                for k in DEVICE_KERNELS[source])
    del scan
    gc.collect()

    # (c) The lego prefix of the tools phase, run through fit_scan.
    lego = ctx["lego"]
    record = lego["record"]
    lego_points = record["points_at_end"]
    tolerance = 0 if out["train_config"]["spread"] == 0.0 else 0.2 * LEGO_EAGER_POINTS
    check(abs(lego_points - LEGO_EAGER_POINTS) <= tolerance,
          f"the lego prefix reached {lego_points} points, PR 8's eager prefix "
          f"{LEGO_EAGER_POINTS} (spread {out['train_config']['spread']})")
    out["lego_prefix"] = dict(
        points=lego_points, eager_points=LEGO_EAGER_POINTS, psnr=record["psnr_at_end"],
        eager_psnr=LEGO_EAGER_PSNR, ms_per_step=record["ms_per_step"],
        median_ms_per_step=statistics.median(record["ms_per_step"]),
        seconds=record["seconds"], launches=record["launches"])
    out["lego_steady"] = steady_state(lego["trainer"], lego["views"], lego["targets"])
    del lego, ctx["lego"]
    gc.collect()
    torch.cuda.empty_cache()

    # (d) ShardedTrainer.fit_scan on a (1, 1) mesh over one NCCL rank: the
    # sharded step captured with its collectives inside.
    out["sharded_nccl"] = sharded_nccl_fit_scan(ctx)
    return dict(card=ctx["card"], **out)


#: The sharded steady states' profiled window: one call of this many steps
#: (a sharded step launches about 1,460 kernels a view).
SHARDED_PROFILE_STEPS = 5


def sharded_fit_config(options, views):
    """The sharded fits' 10-step schedule: SH degrees 0-2 (warm-up every 4
    steps), a densify after step 5, an overflow check every 5 steps, so
    ``fit_scan`` runs chunks of 4, 1, 3 and 2 steps (the one-step chunk
    eager, the others captured and replayed)."""
    from gausplat_tpu_torch import train as TT

    extent = TT.camera_extent(views)
    return TT.TrainConfig(
        sh_warmup_interval=4, densify_from=5, densify_interval=5, densify_until=6,
        opacity_reset_interval=10**9, overflow_check_interval=5, render=options,
        optimizer=TT.OptimizerConfig(scene_extent=extent),
        densify=TT.DensifyConfig(scene_extent=extent))


def sharded_fits(make, cameras, targets) -> dict:
    """The eager ``fit`` (the step launched op by op) twice, ``fit`` through
    its graphs once and ``fit_scan`` once, 10 steps each, from one start
    (``make()`` builds the trainer), in the segments of
    :func:`fit_ten_steps` (every count set to 0 before each run): the
    card's spread (the eager fits' largest parameter difference), and for
    ``fit_scan`` (at the top level) and ``fit`` (``graph_fit``) the
    difference from the first eager fit, the first step and the fields
    where they differ, the launches, the graph's captures and replays and
    the digest. Returns the record and the fit_scan trainer."""
    import gc

    runs = []
    for method in ("_fit_eager", "_fit_eager", "fit", "fit_scan"):
        trainer = make()
        history, segments, launches, seconds = fit_ten_steps(trainer, cameras, targets, method)
        graph = trainer._graph if method == "fit_scan" else trainer._step_graph
        runs.append(dict(trainer=trainer, history=history, segments=segments,
                         launches=launches, seconds=seconds, params=params_of(trainer.scene),
                         points=trainer.scene.point_count,
                         graph=dict(captures=graph.captures, replays=graph.replays)))
        if method != "fit_scan":
            del trainer, runs[-1]["trainer"]
            gc.collect()
    first, second, graphed, scan = runs
    fields = [name for name, _ in scan["trainer"].scene.named_parameters()]

    def against_eager(run) -> dict:
        differ = [f for f, a, b in zip(fields, run["params"], first["params"])
                  if not torch.equal(a, b)]
        steps = [i for i, (a, b) in enumerate(zip(run["history"], first["history"]))
                 if (a["loss"], a["tile_point_total"]) != (b["loss"], b["tile_point_total"])]
        return dict(
            max_abs_diff_from_fit=params_max_diff(run["params"], first["params"]),
            bit_for_bit=not differ and not steps, first_differing_step=steps[0] if steps else None,
            differing_fields=differ,
            losses=[h["loss"] for h in run["history"]],
            loss_max_rel_diff=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                  for a, b in zip(run["history"], first["history"])),
            tile_point_total=[int(h["tile_point_total"]) for h in run["history"]],
            segments=run["segments"], launches=run["launches"], graph=run["graph"],
            digest=params_digest(run["params"]))

    graph_fit = against_eager(graphed)
    graph_fit.update(seconds=graphed["seconds"], spread=0.0)
    return dict(
        record=dict(
            points=[r["points"] for r in runs],
            spread=params_max_diff(first["params"], second["params"]),
            **against_eager(scan),
            fit_losses=[h["loss"] for h in first["history"]],
            fit_launches=first["launches"], launches_by_run=[r["launches"] for r in runs],
            fit_seconds=[first["seconds"], second["seconds"]], scan_seconds=scan["seconds"],
            fit_digest=params_digest(first["params"]), graph_fit=graph_fit,
            graph_fit_digest=graph_fit["digest"]),
        trainer=scan["trainer"])


#: fit_scan against fit where the two are not bit for bit: the CPU tests'
#: bounds of the sharded fit (tests/test_torch_sharded_train.py).
FIT_LOSS_RTOL, FIT_PARAMS_ATOL = 1e-5, 1e-4


def check_sharded_fits(rec, views_a_step, tag, within_spread: bool = True) -> None:
    """The gates of a fit_scan and of a fit through its graphs against the
    eager fits: the same point counts; the parameters within the card's
    spread (0 where the eager fits agree bit for bit), or, with
    ``within_spread`` false, bit for bit or else within the CPU tests'
    bounds (losses ``FIT_LOSS_RTOL``, parameters ``FIT_PARAMS_ATOL``); every
    step's entries within its slab capacity; the path's kernels launched
    once a view a step; replays by each graph."""
    check(len(set(rec["points"])) == 1, f"{tag}: the point counts differ: {rec['points']}")
    for name, run in (("fit_scan", rec), ("fit through its graphs", rec["graph_fit"])):
        close = (run["max_abs_diff_from_fit"] <= rec["spread"] if within_spread else
                 run["bit_for_bit"] or (run["loss_max_rel_diff"] <= FIT_LOSS_RTOL
                                        and run["max_abs_diff_from_fit"] <= FIT_PARAMS_ATOL))
        check(close, f"{tag}: {name} differs from the eager fit by "
                     f"{run['max_abs_diff_from_fit']} (spread {rec['spread']}; losses "
                     f"{run['loss_max_rel_diff']} relative; first step "
                     f"{run['first_differing_step']}, fields {run['differing_fields']})")
        check(all(seg["max_total"] <= seg["capacity"] for seg in run["segments"]),
              f"{tag}: {name}: entry overflow: {run['segments']}")
        check(all(math.isfinite(x) for x in run["losses"]), f"{tag}: {name}: a non-finite loss")
        check(all(run["launches"][k] == 10 * views_a_step for k in PATH)
              and run["launches"] == rec["fit_launches"],
              f"{tag}: {name}: launches {run['launches']} (eager: {rec['fit_launches']})")
        check(run["graph"]["captures"] >= 1 and run["graph"]["replays"] > 0,
              f"{tag}: {name} replayed no captured step: {run['graph']}")


def sharded_nccl_fit_scan(ctx) -> dict:
    """fit_scan (d): ``ShardedTrainer`` on a (1, 1) ("data", "tiles") mesh
    over one NCCL rank in this process, on the bench scene's 4 orbit views
    at 1920x1080 from the train phase's start: the eager fit twice, ``fit``
    through its graphs and ``fit_scan`` once across a densify event
    (:func:`sharded_fits`), then the steady state three ways, with one
    replay of each graph under ``set_sync_debug_mode("error")``."""
    import torch.distributed as dist

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel import make_mesh, stack_cameras
    from gausplat_tpu_torch.parallel.train_step import ShardedTrainer
    from gausplat_tpu_torch.testing import free_port

    dev = ctx["device"]
    views, targets = ctx["views"][1:], torch.stack(ctx["targets"][1:])
    start = train_start_arrays(ctx["arrays"])
    width, height = views[0].image_width, views[0].image_height
    cameras = stack_cameras(views, device=dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "tiles"))
        scene = T.GaussianScene.from_numpy(**start, device=dev)
        config = sharded_fit_config(T.calibrate_options(scene, views), views)
        del scene

        def make():
            return ShardedTrainer(T.GaussianScene.from_numpy(**start, device=dev), mesh,
                                  width, height, config)

        fits = sharded_fits(make, cameras, targets)
        rec = fits["record"]
        check_sharded_fits(rec, len(views), "sharded (1, 1) NCCL")
        steady = steady_state(fits["trainer"], cameras, targets, reps=3,
                              profile_steps=SHARDED_PROFILE_STEPS, profile_reps=1)
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    return dict(mesh=[1, 1], backend=backend, views=len(views), image=[width, height],
                **rec, steady=steady)


# --- the four-card mode: one NCCL rank per card -----------------------------------

#: Ranks of the four-card mode, one per card.
CARDS = 4
#: Seconds a rank of ``--cards 4`` may spend in one part or stage, and in
#: the group's teardown, before it prints every thread's stack and exits
#: (``faulthandler``), which ends the run.
RANK_STALL_S = 240.0
TEARDOWN_STALL_S = 60.0
#: The yaws (rad) of the four-card mode's served orbit views of the bench
#: scene: 8 views, 2 a rank.
SERVE_YAWS = (-0.2, -0.15, -0.1, -0.05, 0.0, 0.05, 0.1, 0.15)


def grad_call_record(out, scene, ref) -> list:
    """A differentiable call's outputs and gradients in the order of
    :func:`sharded_grad_against_eager`'s records, on the host: the five
    outputs, the five parameter gradients, the ref's."""
    return [t.detach().cpu() for t in out] + [p.grad.cpu() for p in scene.parameters()] + [
        ref.grad.cpu()]


def against_single(got, want, names, tiled, what) -> dict:
    """A sharded differentiable call (:func:`grad_call_record`'s layout)
    against the single-device render's, within the multi-device gates: the
    image within 1e-4 (for the tile-sharded frame, on all but
    ``MESH4K_PIXEL_SHARE`` of its pixels), the radii equal, each gradient
    (the five parameters' and the ref's) within ``GRAD_SCALED_ATOL``
    scaled by its largest magnitude."""
    dev = got[0].device
    diff = (got[0] - want[0].to(dev)).abs().amax(dim=-1)
    share = float((diff > 1e-4).double().mean())
    grads = {name: scaled_err(g, w.to(dev))
             for name, g, w in zip(list(names) + ["norm"], got[5:], want[5:])}
    rec = dict(image_max_abs=float(diff.max()), share_beyond_1e4=share,
               radii_equal=bool(torch.equal(got[1], want[1].to(dev))), grad_scaled_err=grads,
               finite=all(bool(torch.isfinite(t).all()) for t in got if t.is_floating_point()))
    check(rec["finite"] and rec["radii_equal"]
          and share <= (MESH4K_PIXEL_SHARE if tiled else 0.0)
          and all(e <= GRAD_SCALED_ATOL for e in grads.values()),
          f"{what}: the sharded call under grad against the single-device render: {rec}")
    return rec


def nccl_cards_worker(rank, out_dir, spec):
    """One of the ranks of ``--cards 4``, on its own card (``cuda:rank``,
    made current by ``spawn_ranks`` before the NCCL group), printing a JSON
    line (rank 0) before each part: (a) the 4K frame of ``mesh4k_scene`` in
    4 slabs of 544 rows, rank 0 against the single render the parent saved
    (``single4k.pt``), and the render's ms (median of 5, CUDA events);
    (b) the (2, 2) step on the bench scene's 4 orbit views, rank 0 against
    ``reference.pt``; (c) ``ShardedTrainer``: the eager fit twice,
    ``fit`` through its graphs and ``fit_scan`` once, 10 steps from one
    start across a densify event; (d) the steady state three ways; (e)
    under grad, the 4K frame through ``render_tile_sharded``'s graph pair
    and the 8 orbit views through ``render_data_parallel``'s, each bit for
    bit its eager form (:func:`sharded_grad_against_eager`) and, on rank 0,
    within the multi-device gates of the single-device differentiable render
    (``single4k_grad.pt``, ``single8_grad.pt``). Writes ``rank{rank}.json``:
    its device and backend, times, checks, digests and the path's launches
    ((a)-(c), the targets' renders and the timings left out; (e)'s in
    ``grad_launches``)."""
    import faulthandler
    import gc

    import torch.distributed as dist

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel import (
        make_mesh, render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.parallel.render import _data_parallel_eager, _tile_sharded_eager
    from gausplat_tpu_torch.parallel.train_step import ShardedTrainer, make_sharded_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    began = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    out_dir = pathlib.Path(out_dir)
    kernels = all_kernels()
    rec = dict(rank=rank, backend=dist.get_backend(), device=str(dev),
               current_device=torch.cuda.current_device(),
               device_name=torch.cuda.get_device_name(dev))
    check(rec["backend"] == "nccl" and dev.index == rank,
          f"rank {rank} is not on its own card over NCCL: {rec}")
    launches = {k.entry: 0 for k in kernels}

    def part(name, what):
        faulthandler.dump_traceback_later(RANK_STALL_S, exit=True)
        if rank == 0:
            print(json.dumps({"phase": "nccl_cards", "part": name, "what": what}), flush=True)

    def zero():
        for kernel in kernels:
            kernel.launches = 0

    def take(counts):
        for entry, n in counts.items():
            launches[entry] += n

    # (a) The 4K frame in 4 slabs, one card each.
    part("a", "the 4K frame (2M points, 3840x2176) in 4 slabs of 544 rows, a card each")
    scene = mesh4k_scene(T, dev)
    view = mesh4k_view(T)
    options = T.RenderOptions(tile_entry_capacity=MESH4K_CAPACITY, block_size=128)
    mesh = make_mesh((MESH4K_SLABS,), ("tiles",))

    def render_4k():  # the eager slabs
        with torch.no_grad():
            return _tile_sharded_eager(scene, view, mesh, "tiles", options, None)

    zero()
    torch.cuda.synchronize()
    dist.barrier(device_ids=[rank])
    out = render_4k()
    torch.cuda.synchronize()
    take({k.entry: k.launches for k in kernels})
    rec["render_4k_ms"], rec["render_4k_ms_all"] = cuda_ms(render_4k)
    slab_capacity = MESH4K_CAPACITY // MESH4K_SLABS
    rec["slab_watermark"], rec["slab_capacity"] = int(out.tile_point_total), slab_capacity
    check(int(out.tile_point_total) < slab_capacity,
          f"a slab overflowed: {int(out.tile_point_total)} >= {slab_capacity}")
    # (a') The same frame through the captured render_tile_sharded: bit for
    # bit the eager slabs on every rank.
    part("a'", "the 4K frame through render_tile_sharded's graph against the eager slabs")
    rec["render_4k_graph"], _ = graph_against_eager(
        "parallel.render_tile_sharded",
        lambda: render_tile_sharded(scene, view, mesh, "tiles", options), render_4k)
    take(rec["render_4k_graph"]["launches"])
    if rank == 0:
        want = torch.load(out_dir / "single4k.pt", weights_only=True)
        single = type(out)(**{f: want[f].to(dev) for f in out._fields})
        rec["mesh4k"] = mesh4k_record(out, single)
        del single, want
    del scene, out
    torch.cuda.empty_cache()

    # (a'') 8 orbit views of the bench scene through the captured
    # render_data_parallel, 2 a rank, bit for bit the eager call.
    part("a''", f"render_data_parallel's graph: {len(SERVE_YAWS)} orbit views, "
                f"{len(SERVE_YAWS) // CARDS} a rank")
    with torch.no_grad():
        bench = T.GaussianScene.from_numpy(**bench_scene_arrays(), device=dev)
    serve_views = [orbit_view(T, yaw, 0.0) for yaw in SERVE_YAWS]
    serve_cams = stack_cameras(serve_views, device=dev)
    serve_options = T.RenderOptions(tile_entry_capacity=spec["serve_capacity"])
    data_mesh = make_mesh((CARDS,), ("data",))
    w, h = serve_views[0].image_width, serve_views[0].image_height
    rec["serve_data_parallel"], served = graph_against_eager(
        "parallel.render_data_parallel",
        lambda: render_data_parallel(bench, serve_cams, w, h, data_mesh, "data", serve_options),
        lambda: _data_parallel_eager(bench, serve_cams, w, h, data_mesh, "data", serve_options,
                                     None))
    take(rec["serve_data_parallel"]["launches"])
    totals = [int(t) for t in served.tile_point_total]
    rec["serve_data_parallel"]["tile_point_total"] = totals
    check(max(totals) <= spec["serve_capacity"], f"entry overflow: {totals}")
    del bench, served, serve_cams
    torch.cuda.empty_cache()

    # (b) The (2, 2) sharded step against the single-device reference.
    part("b", "the (2, 2) (data, tiles) step on the bench scene's 4 orbit views at 1920x1080")
    arrays = bench_scene_arrays()
    views = bench_views(T)[1:]
    with torch.no_grad():
        bench = T.GaussianScene.from_numpy(**arrays, device=dev)
        targets = torch.stack([
            T.render(bench, v, T.RenderOptions(tile_entry_capacity=spec["bench_capacity"])
                     ).colors_rgb_2d for v in views])
        del bench
    start = train_start_arrays(arrays)
    scene = T.GaussianScene.from_numpy(**start, device=dev)
    grid = make_mesh(STEP_MESH, ("data", "tiles"))
    config = sharded_fit_config(T.RenderOptions(tile_entry_capacity=spec["step_capacity"]),
                                views)
    width, height = views[0].image_width, views[0].image_height
    step, _, h_pad = make_sharded_train_step(grid, width, height, scene.point_count,
                                             config.render, config.optimizer)
    cams = stack_cameras(views, device=dev)
    padded = torch.nn.functional.pad(targets, (0, 0, 0, 0, 0, h_pad - height))
    zero()
    torch.cuda.synchronize()
    dist.barrier(device_ids=[rank])
    got = step.loss_and_grads(scene, cams, padded)
    torch.cuda.synchronize()
    take({k.entry: k.launches for k in kernels})
    rec["step_watermark"], rec["step_slab_capacity"] = int(got["max_total"]), step.capacity
    check(int(got["max_total"]) < step.capacity,
          f"a slab of the step overflowed: {int(got['max_total'])} >= {step.capacity}")
    if rank == 0:
        rec["step"] = step_record(got, torch.load(out_dir / "reference.pt", weights_only=True),
                                  h_pad)
    del got, scene, step

    # (c) ShardedTrainer: the eager fit twice, fit through its graphs and
    # fit_scan once from one start.
    part("c", "ShardedTrainer: the eager fit twice, fit through its graphs and fit_scan once, "
              "10 steps across a densify event")
    fits = sharded_fits(lambda: ShardedTrainer(T.GaussianScene.from_numpy(**start, device=dev),
                                               grid, width, height, config), cams, targets)
    rec["fits"] = fits["record"]
    for counts in rec["fits"]["launches_by_run"]:
        take(counts)
    check_sharded_fits(rec["fits"], len(views) // STEP_MESH[0], f"rank {rank}",
                       within_spread=False)
    rec["launches"] = launches

    # (d) The steady state on each rank.
    part("d", f"the steady state: {STEADY_STEPS} steps with no host event, eager, fit through "
              f"its graphs and fit_scan")
    rec["steady"] = steady_state(fits["trainer"], cams, targets, reps=3,
                                 profile_steps=SHARDED_PROFILE_STEPS, profile_reps=1)
    del fits
    torch.cuda.empty_cache()

    # (e) Under grad: each through its graph pair against its eager form,
    # and (rank 0) against the single-device differentiable render the
    # parent saved.
    part("e", "under grad: the 4K frame through render_tile_sharded's graph pair, the 8 "
              "orbit views through render_data_parallel's, each against its eager form")

    def progress(stage, stall_s=RANK_STALL_S):
        faulthandler.dump_traceback_later(stall_s, exit=True)
        print(f"nccl_cards (e), rank {rank}, {time.perf_counter() - began:.1f} s: {stage}",
              file=sys.stderr, flush=True)

    progress("the miss decision")
    rec["grad_miss_decision"] = miss_decision(mesh, dev)
    miss_launches = rec["grad_miss_decision"]["kernel_launches"]
    scene = mesh4k_scene(T, dev)
    names = [n for n, _ in scene.named_parameters()]
    grad = {"render_tile_sharded_4k": sharded_grad_against_eager(
        "parallel.render_tile_sharded", scene,
        lambda ref: render_tile_sharded(scene, view, mesh, "tiles", options, ref),
        lambda ref: _tile_sharded_eager(scene, view, mesh, "tiles", options, ref),
        lambda o: torch.mean(o.colors_rgb_2d ** 2), 1, miss_launches, progress)}
    del scene
    torch.cuda.empty_cache()
    bench = T.GaussianScene.from_numpy(**bench_scene_arrays(), device=dev)
    serve_cams = stack_cameras(serve_views, device=dev)
    grad["render_data_parallel_8"] = sharded_grad_against_eager(
        "parallel.render_data_parallel", bench,
        lambda ref: render_data_parallel(bench, serve_cams, w, h, data_mesh, "data",
                                         serve_options, ref),
        lambda ref: _data_parallel_eager(bench, serve_cams, w, h, data_mesh, "data",
                                         serve_options, ref),
        lambda o: torch.mean(o.colors_rgb_2d ** 2), len(SERVE_YAWS) // CARDS, miss_launches,
        progress)
    del bench, serve_cams
    for key, file, tiled in (("render_tile_sharded_4k", "single4k_grad.pt", True),
                             ("render_data_parallel_8", "single8_grad.pt", False)):
        call = grad[key].pop("replay_call")
        progress(f"{key}: against the single-device render")
        if rank == 0:
            grad[key]["against_single"] = against_single(
                call, torch.load(out_dir / file, weights_only=True), names, tiled, key)
        del call
        torch.cuda.empty_cache()
    rec["grad"] = grad
    rec["grad_launches"] = {k.entry: sum(g["launches"].get(k.entry, 0) for g in grad.values())
                            for k in kernels}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec))
    # Every rank frees what it captured and meets the others before the
    # group's teardown (``testing._rank_main`` releases the entry points'
    # graphs again before it destroys the group).
    progress("the barrier")
    gc.collect()
    torch.cuda.synchronize()
    dist.barrier(device_ids=[rank])
    progress("the teardown", TEARDOWN_STALL_S)


def phase_nccl_cards(ctx):
    """The parallel path with one card per rank: the single 4K render, the
    (2, 2) step's single-device reference and part (e)'s differentiable
    references on card 0, then four NCCL ranks on cards 0-3
    (:func:`nccl_cards_worker`); then A, B and C on rank 0's slab 0 of the
    step (``<kernel>@nccl_slab0``) and on slab 0 of the 4K frame
    (``<kernel>@nccl_grad_slab0``, part (e)'s launches) against their plain
    versions, the launches summed over the ranks."""
    import tempfile

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.parallel.render import _shard_capacity, slab_rows
    from gausplat_tpu_torch.render.pipeline import _render_eager
    from gausplat_tpu_torch.render.views_graph import views_graph
    from gausplat_tpu_torch.testing import spawn_ranks

    dev = ctx["device"]
    kernels = all_kernels()
    ctx.setdefault("kernels", [])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # The single 4K render on card 0, and its time.
        scene = mesh4k_scene(T, dev)
        view = mesh4k_view(T)
        options = T.RenderOptions(tile_entry_capacity=MESH4K_CAPACITY, block_size=128)

        def render_4k():
            with torch.no_grad():
                return _render_eager(scene, view, options)

        single = render_4k()
        torch.save({f: v.cpu() for f, v in single._asdict().items()}, tmp / "single4k.pt")
        single_ms, single_ms_all = cuda_ms(render_4k)
        with torch.no_grad():
            single_graph_ms, single_graph_ms_all = cuda_ms(lambda: T.render(scene, view, options))
        views_graph("render", dev).release()
        del single
        # Part (e)'s single-device references: the differentiable render of
        # the 4K frame and of the 8 orbit views (one ref), with the
        # gradients of mean(image ** 2).
        ref = torch.zeros(scene.point_count, device=dev, requires_grad=True)
        out = _render_eager(scene, view, options, ref)
        torch.mean(out.colors_rgb_2d ** 2).backward()
        torch.save(grad_call_record(out, scene, ref), tmp / "single4k_grad.pt")
        del scene, out, ref
        # The (2, 2) step's single-device reference.
        arrays = bench_scene_arrays()
        all_views = bench_views(T)
        with torch.no_grad():
            bench = T.GaussianScene.from_numpy(**arrays, device=dev)
            bench_capacity = T.calibrate_options(bench, all_views).tile_entry_capacity
            serve_capacity = T.calibrate_options(
                bench, [orbit_view(T, yaw, 0.0) for yaw in SERVE_YAWS]).tile_entry_capacity
            views = all_views[1:]
            targets = [T.render(bench, v, T.RenderOptions(tile_entry_capacity=bench_capacity)
                                ).colors_rgb_2d for v in views]
            del bench
        bench = T.GaussianScene.from_numpy(**arrays, device=dev)
        ref = torch.zeros(bench.point_count, device=dev, requires_grad=True)
        serve_options = T.RenderOptions(tile_entry_capacity=serve_capacity)
        outs = [_render_eager(bench, orbit_view(T, yaw, 0.0), serve_options, ref)
                for yaw in SERVE_YAWS]
        out = T.RenderOutput(*(torch.stack(field) for field in zip(*outs)))
        torch.mean(out.colors_rgb_2d ** 2).backward()
        torch.save(grad_call_record(out, bench, ref), tmp / "single8_grad.pt")
        del bench, ref, outs, out
        torch.cuda.empty_cache()
        scene = T.GaussianScene.from_numpy(**train_start_arrays(arrays), device=dev)
        reference, step_capacity = step_reference(T, scene, views, targets)
        torch.save(reference, tmp / "reference.pt")
        del reference, targets
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        emit("nccl_cards_ranks_start", 0.0, ranks=CARDS, backend="nccl",
             devices=[f"cuda:{r}" for r in range(CARDS)])
        start = time.perf_counter()
        spawn_ranks(nccl_cards_worker, CARDS, str(tmp),
                    dict(bench_capacity=bench_capacity, step_capacity=step_capacity,
                         serve_capacity=serve_capacity),
                    backend="nccl", timeout_s=600.0)
        spawn_seconds = time.perf_counter() - start
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(CARDS)]

    check([(r["backend"], r["device"], r["current_device"]) for r in ranks]
          == [("nccl", f"cuda:{r}", r) for r in range(CARDS)],
          f"the ranks are not one NCCL rank per card: "
          f"{[(r['backend'], r['device']) for r in ranks]}")
    for key in ("digest", "fit_digest", "graph_fit_digest"):
        digests = {r["fits"][key] for r in ranks}
        check(len(digests) == 1, f"the ranks' scenes differ ({key}): {digests}")
    launches = {k.entry: sum(r["launches"][k.entry] for r in ranks) for k in kernels}
    check(all(launches[k] > 0 for k in PATH), f"a kernel of the path never ran: {launches}")

    # A, B and C on rank 0's slab 0 of the step (view 0, rows 0-543), here
    # on card 0, from the same start.
    h_local, h_pad = slab_rows(views[0].image_height, STEP_MESH[1])
    capacity = _shard_capacity(step_capacity, STEP_MESH[1], 256)
    rec, timings = slab_kernel_records(scene, views[0], (0, h_local), capacity, dev,
                                       "nccl_slab0")
    check_live(rec, "nccl_slab0")
    add_kernel_rows(ctx, timings, "nccl_slab0",
                    f"nccl_cards: slab 0 (0-{h_local - 1} of {h_pad} rows) of the (2, 2) step "
                    f"on {CARDS} cards over NCCL, 1920 x {h_local}", launches)
    # A, B and C on slab 0 of part (e)'s 4K frame under grad, with (e)'s
    # launches summed over the ranks.
    grad_launches = {k.entry: sum(r["grad_launches"][k.entry] for r in ranks) for k in kernels}
    check(all(grad_launches[k] > 0 for k in PATH),
          f"a kernel of the path under grad never ran: {grad_launches}")
    del scene
    torch.cuda.empty_cache()
    scene = mesh4k_scene(T, dev)
    h4k = slab_rows(MESH4K_HEIGHT, MESH4K_SLABS)[0]
    grad_rec, timings = slab_kernel_records(
        scene, mesh4k_view(T), (0, h4k), _shard_capacity(MESH4K_CAPACITY, MESH4K_SLABS, 128),
        dev, "nccl_grad_slab0")
    check_live(grad_rec, "nccl_grad_slab0")
    add_kernel_rows(ctx, timings, "nccl_grad_slab0",
                    f"nccl_cards (e): slab 0 (0-{h4k - 1} of {MESH4K_HEIGHT} rows) of the 4K "
                    f"frame under grad through render_tile_sharded's graph pair, and the 8 "
                    f"orbit views through render_data_parallel's, on {CARDS} cards over NCCL, "
                    f"{MESH4K_WIDTH} x {h4k}", grad_launches)
    grad = {key: dict(
        rank_bit_for_bit=[r["grad"][key]["bit_for_bit"] for r in ranks],
        rank_timing=[{w: {k: r["grad"][key]["timing"][w].get(k) for k in (
            "ms", "ms_all", "device_busy_ms", "device_idle_share", "compute_idle_share",
            "collective_ms", "host_launches")} for w in ("graph", "eager")} for r in ranks],
        rank_graph_render_only=[r["grad"][key]["timing"]["graph_render_only"] for r in ranks],
        launches_a_replay=ranks[0]["grad"][key]["launches_a_replay"],
        against_single=ranks[0]["grad"][key]["against_single"])
        for key in ("render_tile_sharded_4k", "render_data_parallel_8")}
    grad["rank_miss_decision"] = [r["grad_miss_decision"] for r in ranks]
    grad["launches"] = grad_launches
    grad["slab0"] = grad_rec
    rank0 = ranks[0]
    steady = {name: [{k: r["steady"][name][k] for k in (
        "ms_per_step", "per_step", "device_idle_share", "compute_idle_share")}
        for r in ranks] for name, _ in STEADY_WAYS}
    steady["any_miss_ms"] = [r["steady"]["any_miss_ms"] for r in ranks]
    return dict(
        cards=nvidia_smi_all("name,power.limit"), backend="nccl",
        devices=[dict(rank=r["rank"], device=r["device"], name=r["device_name"])
                 for r in ranks],
        mesh4k=rank0["mesh4k"], render_4k_single_ms=single_ms,
        render_4k_single_ms_all=single_ms_all, render_4k_single_graph_ms=single_graph_ms,
        render_4k_single_graph_ms_all=single_graph_ms_all,
        rank_render_4k_ms=[r["render_4k_ms"] for r in ranks],
        rank_render_4k_ms_all=[r["render_4k_ms_all"] for r in ranks],
        rank_render_4k_graph=[r["render_4k_graph"] for r in ranks],
        rank_serve_data_parallel=[r["serve_data_parallel"] for r in ranks],
        slab_watermarks=[r["slab_watermark"] for r in ranks], slab_capacity=rank0["slab_capacity"],
        step=rank0["step"], step_watermarks=[r["step_watermark"] for r in ranks],
        step_slab_capacity=rank0["step_slab_capacity"],
        fits={k: v for k, v in rank0["fits"].items() if k != "launches_by_run"},
        rank_fits_bit_for_bit=[r["fits"]["bit_for_bit"] for r in ranks],
        rank_graph_fits_bit_for_bit=[r["fits"]["graph_fit"]["bit_for_bit"] for r in ranks],
        steady=steady, steady_rank0=rank0["steady"], launches=launches,
        rank_launches=[r["launches"] for r in ranks], spawn_seconds=spawn_seconds,
        slab0=rec, grad=grad)


# --- phase 15: the differentiable render as a forward and a backward graph ----------


def settled_reserved(dev) -> int:
    """The caching allocator's reserved bytes on ``dev`` after a collection,
    a drain and an ``empty_cache``: what graphs' pools and live tensors hold."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


class UserLoop:
    """A user's loop around the differentiable ``render``: a fresh ref that
    requires grad each call, ``loss = mean |image - target|`` and
    ``loss.backward()``, through ``render_fn`` (``render``, or
    ``_render_eager``, the same render launched op by op). With ``keep``,
    ``record`` holds every output and gradient, in order."""

    def __init__(self, scene, views, targets, options, render_fn, keep=True):
        self.scene, self.views, self.targets = scene, views, targets
        self.options, self.render_fn, self.keep = options, render_fn, keep
        self.record = []

    def render(self, i):
        ref = torch.zeros((self.scene.point_count,), device=self.scene.device,
                          requires_grad=True)
        out = self.render_fn(self.scene, self.views[i], self.options, ref)
        if self.keep:
            self.record.append([t.detach() for t in out])
        return out, ref, i

    def backward(self, *calls):
        self.scene.zero_grad(set_to_none=True)
        sum(torch.mean(torch.abs(out.colors_rgb_2d - self.targets[i]))
            for out, _, i in calls).backward()
        if self.keep:
            self.record.append([p.grad for p in self.scene.parameters()]
                               + [ref.grad for _, ref, _ in calls])

    def step(self, i=0):
        self.backward(self.render(i))


def _reverse_order(loop):
    a, b = loop.render(0), loop.render(1)
    loop.backward(b)
    loop.backward(a)


def _dropped_forward(loop):
    loop.render(4)  # an evaluation render under grad, its output dropped
    loop.step(0)


#: The render_grad phase's sequence on one scene: (name, step, the pair's
#: captures, forward replays, backward replays and moved states after it).
GRAD_SEQUENCE = (
    ("warm_up", lambda loop: loop.step(0), (0, 0, 0, 0)),
    ("capture", lambda loop: loop.step(0), (1, 1, 1, 0)),
    ("replay", lambda loop: loop.step(0), (1, 2, 2, 0)),
    ("new_view", lambda loop: loop.step(1), (1, 3, 3, 0)),
    ("two_renders_one_backward", lambda loop: loop.backward(loop.render(2), loop.render(3)),
     (1, 5, 5, 1)),
    ("reverse_order", _reverse_order, (1, 7, 7, 2)),
    ("dropped_forward", _dropped_forward, (1, 9, 8, 2)),
)
#: Then on a scene of another point count (from ``from_numpy``): a miss.
GRAD_NEW_P = (
    ("new_p_warm_up", lambda loop: loop.step(0), (1, 9, 8, 2)),
    ("new_p_capture", lambda loop: loop.step(0), (2, 10, 9, 2)),
    ("new_p_replay", lambda loop: loop.step(1), (2, 11, 10, 2)),
)


def grad_sequence(scenes, views, targets, options, render_fn, graph=None,
                  loop_type=None) -> tuple:
    """:data:`GRAD_SEQUENCE` on ``scenes[0]`` and :data:`GRAD_NEW_P` on
    ``scenes[1]`` through ``render_fn`` in a ``loop_type`` loop
    (:class:`UserLoop` by default), with every kernel's count set to 0
    just before and read just after. With ``graph`` (the entry point's
    ``GradGraph``), each step's counts of the pair are checked. Returns the
    record (one entry per render and per backward) and the launches."""
    kernels = all_kernels()
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    record = []
    for scene, steps in zip(scenes, (GRAD_SEQUENCE, GRAD_NEW_P)):
        loop = (loop_type or UserLoop)(scene, views, targets, options, render_fn)
        for name, step, counts in steps:
            step(loop)
            if graph is not None:
                got = (graph.captures, graph.replays["forward"], graph.replays["backward"],
                       graph.moves)
                check(got == counts, f"render_grad, {name}: the pair's captures, forward "
                                     f"and backward replays and moves {got}, not {counts}")
        record += loop.record
        scene.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return record, {kernel.entry: kernel.launches for kernel in kernels}


def pair_costs(graph, call_loop, eager_loop, render_only, what, pairs=None, profiled=None,
               kernels_allowed=0) -> dict:
    """A graph pair's costs in one configuration (``graph`` its entry
    point's ``GradGraph``, released first and after): the miss (host ms of
    the warm-up and the capture calls of ``call_loop.step``, against a
    replay's and ``eager_loop.step``'s, medians of 3), the memory the pair
    keeps (its pool, the saved state a move copies, the static tensors), a
    call both ways in turns (ms, CUDA events) and ``pairs`` (prefix: (through
    the pair, eager)) likewise, the profiler's figures of a call both ways,
    of ``render_only`` (the render and its backward alone through the pair:
    two graph launches and at most ``kernels_allowed`` kernels launched from
    the host) and of ``profiled`` (name: call), then each graph replayed
    with the host's sync checks set to raise."""
    dev = graph.device
    graph.release()
    reserved = [settled_reserved(dev)]
    warm_up_ms = host_wall_ms(call_loop.step)
    reserved.append(settled_reserved(dev))
    capture_ms = host_wall_ms(call_loop.step)
    reserved.append(settled_reserved(dev))
    pair = graph.pair
    out = dict(
        miss=dict(warm_up_ms=warm_up_ms, capture_ms=capture_ms,
                  replay_call_ms=statistics.median(host_wall_ms(call_loop.step)
                                                   for _ in range(3)),
                  eager_call_ms=statistics.median(host_wall_ms(eager_loop.step)
                                                  for _ in range(3)),
                  forward_only=dict(graph.miss_ms)),
        memory=dict(graph_pool_bytes=reserved[2] - reserved[1],
                    saved_state_bytes=sum(b.numel() for b in pair.state),
                    static_bytes=nbytes(*pair.inputs, pair.ref, pair.cot),
                    saved_tensors=len(pair.saved)))
    timing = {}
    for prefix, (first, second) in {"": (call_loop.step, eager_loop.step),
                                    **(pairs or {})}.items():
        turns = in_turns(first, second)
        timing[f"{prefix}graph"] = dict(ms=turns["first"][0], ms_all=turns["first"][1])
        timing[f"{prefix}eager"] = dict(ms=turns["second"][0], ms_all=turns["second"][1])
    for name, run in {"graph": call_loop.step, "eager": eager_loop.step,
                      "graph_render_only": render_only, **(profiled or {})}.items():
        try:
            prof = profile_device_time(run)
        except RuntimeError as e:  # the profiler is a measurement, not the path
            prof = dict(device_busy_ms=f"not measured ({e})")
        timing.setdefault(name, {}).update({
            k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                     "collective_ms", "compute_idle_share", "kernel_launches",
                                     "host_launches", "host_calls")})
        if name.startswith("graph") and "host_calls" in prof:
            graphs = sum(n for k, n in prof["host_calls"].items() if "GraphLaunch" in k)
            check(graphs == 2, f"{what}: a {name} call made {graphs} graph launches, not 2")
        if name == "graph_render_only" and "host_calls" in prof:
            check(kernel_calls(prof) <= kernels_allowed,
                  f"{what}: the render and its backward alone launched kernels from the host: "
                  f"{prof['host_calls']} ({kernels_allowed} allowed)")
    out["timing"] = timing
    check(graph.captures == 1, f"{what}: the timed calls recaptured ({graph.captures})")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pair.forward.replay()
        pair.backward.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out["strict_replay"] = "no host read, either graph"
    graph.release()
    return out


def render_grad_config(ctx, tag, scene, views, targets, options) -> dict:
    """One configuration of phase render_grad: the user's loop through the
    graph pair against ``_render_eager`` and its backward (every output,
    parameter gradient and ref gradient bit for bit over the sequence, one
    capture per key, A, B and C launched from the graphs and counted), the
    miss cost, the pool, the wall, busy and host figures of a call both
    ways, and A, B and C at the call's shapes (``<kernel>@<tag>``)."""
    import gc

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.render.grad_graph import grad_graph
    from gausplat_tpu_torch.render.pipeline import _render_eager
    from gausplat_tpu_torch.scene.gaussian_3d import PARAM_DIMS

    dev = ctx["device"]
    graph = grad_graph("render", dev)
    cut = scene.point_count - scene.point_count // 16
    other = T.GaussianScene.from_numpy(
        **{f: getattr(scene, f).detach().cpu().numpy()[:cut] for f in PARAM_DIMS}, device=dev)
    width, height = views[0].image_width, views[0].image_height
    out = dict(points=scene.point_count, new_p_points=other.point_count, width=width,
               height=height, capacity=options.tile_entry_capacity,
               sh_degree=options.colors_sh_degree_max)

    # The sequence through the graph pair, then op by op; compared bit for bit.
    graph.release()
    got, launches = grad_sequence((scene, other), views, targets, options, T.render, graph)
    by_replay = {k.entry: n for k, n in graph.by_replay.items()}
    graph_captures = graph.captures
    want, eager_launches = grad_sequence((scene, other), views, targets, options,
                                         _render_eager)
    compare_records(got, want, tag)
    # Each capture call also runs the render and its backward once on a
    # side stream before it captures.
    check(all(launches[k] == eager_launches[k] + graph_captures for k in PATH),
          f"{tag}: launches {launches}, eager {eager_launches}, captures {graph_captures}")
    check(all(launches[k] > 0 for k in PATH) and all(by_replay.get(k, 0) > 0 for k in PATH),
          f"{tag}: a kernel of the path was not launched from the graphs: {launches}, "
          f"by replay {by_replay}")
    out.update(bit_for_bit=True, records=len(got), launches=launches,
               launches_by_replay=by_replay, steps=[name for name, _, _ in GRAD_SEQUENCE
                                                     + GRAD_NEW_P])
    del got, want, other
    gc.collect()

    # The miss cost, the memory the pair keeps, a call both ways.
    call_loop = UserLoop(scene, views, targets, options, T.render, keep=False)
    eager_loop = UserLoop(scene, views, targets, options, _render_eager, keep=False)
    cot = torch.randn((height, width, 3), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(19))
    ref = torch.zeros((scene.point_count,), device=dev, requires_grad=True)

    def render_only(render_fn):
        def call():
            scene.zero_grad(set_to_none=True)
            ref.grad = None
            render_fn(scene, views[0], options, ref).colors_rgb_2d.backward(cot)
        return call

    out.update(pair_costs(
        graph, call_loop, eager_loop, render_only(T.render), tag,
        pairs={"two_views_": (
            lambda: call_loop.backward(call_loop.render(1), call_loop.render(2)),
            lambda: eager_loop.backward(eager_loop.render(1), eager_loop.render(2)))},
        profiled={"eager_render_only": render_only(_render_eager)}))
    scene.zero_grad(set_to_none=True)
    del call_loop, eager_loop, ref
    gc.collect()

    # A, B and C at the call's shapes, with the sequence's launches.
    rec, timings = slab_kernel_records(scene, views[0], (0, height),
                                       options.tile_entry_capacity, dev, tag)
    check_live(rec, tag)
    out["kernels"] = rec
    for t in timings.values():
        t["launches_by_replay"] = by_replay.get(t["kernel"].entry, 0)
    add_kernel_rows(ctx, timings, tag,
                    f"render_grad: the differentiable render and its backward through the "
                    f"graph pair, {scene.point_count} points at {width} x {height}, "
                    f"{len(GRAD_SEQUENCE) + len(GRAD_NEW_P)} steps of a user's loop",
                    launches)
    return out


class ViewsLoop(UserLoop):
    """A user's loop around the differentiable ``render_views``: call ``i``
    renders every view from the ``i``-th on (wrapping round), ``loss = mean
    |images - targets|`` over the stacked images and ``targets`` (``[V, H,
    W, 3]``) in the same order, and ``loss.backward()``, through
    ``render_fn(scene, views, options)``. It passes no ref: ``render_views``
    takes none. With ``keep``, ``record`` holds every output and gradient."""

    def render(self, i):
        order = [(i + k) % len(self.views) for k in range(len(self.views))]
        out = self.render_fn(self.scene, [self.views[k] for k in order], self.options)
        if self.keep:
            self.record.append([t.detach() for t in out])
        return out, None, order

    def backward(self, *calls):
        self.scene.zero_grad(set_to_none=True)
        sum(torch.mean(torch.abs(out.colors_rgb_2d - self.targets[order]))
            for out, _, order in calls).backward()
        if self.keep:
            self.record.append([p.grad for p in self.scene.parameters()])


def compare_records(got, want, what) -> None:
    """Two records of a loop (:class:`UserLoop`) bit for bit, and finite."""
    check(len(got) == len(want), f"{what}: {len(got)} records through the graphs, "
                                 f"{len(want)} eager")
    differ = [(i, j) for i, (g, w) in enumerate(zip(got, want)) for j, (a, b) in
              enumerate(zip(g, w)) if a.shape != b.shape or not torch.equal(a, b)]
    check(not differ, f"{what}: the graphed call differs from the eager call "
                      f"(record, tensor): {differ[:10]}")
    finite = all(bool(torch.isfinite(t).all()) for r in got for t in r
                 if t.is_floating_point())
    check(finite, f"{what}: a non-finite output or gradient")


def check_per_replay(pair, count, what) -> dict:
    """A and B launched ``count`` times (once a view or slab) by a forward
    replay of ``pair``, C ``count`` times by a backward replay, nothing
    else. Returns the launches a replay of each graph, by entry point."""
    got = {"forward": {k.entry: n for k, n in pair.forward.launches.items()},
           "backward": {k.entry: n for k, n in pair.backward.launches.items()}}
    want = {"forward": {PATH[0]: count, PATH[1]: count}, "backward": {PATH[2]: count}}
    check(got == want, f"{what}: launches a replay {got}, not {want}")
    return got


def render_views_grad_config(ctx, scene, views, targets, options) -> dict:
    """Phase render_grad's views part: a user's loop around the
    differentiable ``render_views`` of the 5 views a call, in both modes,
    through its graph pair against ``_render_views_eager`` and its backward
    over :data:`GRAD_SEQUENCE` and :data:`GRAD_NEW_P` (every output and
    parameter gradient bit for bit, one capture per key, A, B and C launched
    from the graphs, 5 of each a replay; the pair released between the
    modes, so each runs the whole sequence); then, in the ``map`` mode, the
    pair's costs (:func:`pair_costs`: the miss, the pool and the saved
    state, a call both ways, the render and its backward alone with no
    kernel launch from the host, the strict replays)."""
    import gc

    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.render.grad_graph import grad_graph
    from gausplat_tpu_torch.render.pipeline import _render_views_eager
    from gausplat_tpu_torch.scene.gaussian_3d import PARAM_DIMS

    dev = ctx["device"]
    graph = grad_graph("render_views", dev)
    count = len(views)
    stacked = torch.stack(targets)
    cut = scene.point_count - scene.point_count // 16
    other = T.GaussianScene.from_numpy(
        **{f: getattr(scene, f).detach().cpu().numpy()[:cut] for f in PARAM_DIMS}, device=dev)
    width, height = views[0].image_width, views[0].image_height
    out = dict(points=scene.point_count, new_p_points=other.point_count, views=count,
               width=width, height=height, capacity=options.tile_entry_capacity)
    launches_all, by_replay_all = {}, {}
    cot = torch.randn((count, height, width, 3), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(23))
    for mode in ("vmap", "map"):
        def pair_fn(s, vs, o, mode=mode):
            return T.render_views(s, vs, o, mode=mode)

        def eager_fn(s, vs, o, mode=mode):
            return _render_views_eager(s, vs, o, mode, None)

        graph.release()
        got, launches = grad_sequence((scene, other), views, stacked, options, pair_fn, graph,
                                      ViewsLoop)
        by_replay = {k.entry: n for k, n in graph.by_replay.items()}
        captures, moves = graph.captures, graph.moves
        a_replay = check_per_replay(graph.pair, count, f"render_views ({mode})")
        want, eager_launches = grad_sequence((scene, other), views, stacked, options, eager_fn,
                                             loop_type=ViewsLoop)
        compare_records(got, want, f"render_views ({mode})")
        # Each capture call also runs every view's render and backward once
        # on a side stream before it captures.
        check(all(launches[k] == eager_launches[k] + count * captures for k in PATH),
              f"render_views ({mode}): launches {launches}, eager {eager_launches}, "
              f"captures {captures}")
        check(by_replay.get(PATH[0]) == count * graph.replays["forward"]
              and by_replay.get(PATH[2]) == count * graph.replays["backward"],
              f"render_views ({mode}): by replay {by_replay}, replays {graph.replays}")
        rec = dict(bit_for_bit=True, records=len(got), captures=captures, moves=moves,
                   replays=dict(graph.replays), launches=launches,
                   launches_by_replay=by_replay, launches_a_replay=a_replay,
                   eager_launches=eager_launches)
        for k in PATH:
            launches_all[k] = launches_all.get(k, 0) + launches[k]
            by_replay_all[k] = by_replay_all.get(k, 0) + by_replay.get(k, 0)
        del got, want
        gc.collect()
        out[mode] = rec
    # The costs, once: one pair serves both modes (its views are rendered
    # one after another in either), and only the warm-up's eager loop
    # differs.
    call_loop = ViewsLoop(scene, views, stacked, options, pair_fn, keep=False)
    eager_loop = ViewsLoop(scene, views, stacked, options, eager_fn, keep=False)

    def render_only():
        scene.zero_grad(set_to_none=True)
        T.render_views(scene, views, options, mode="map").colors_rgb_2d.backward(cot)

    out["map"].update(pair_costs(graph, call_loop, eager_loop, render_only,
                                 "render_views (map)"))
    scene.zero_grad(set_to_none=True)
    del call_loop, eager_loop
    out["launches"], out["launches_by_replay"] = launches_all, by_replay_all
    del other
    gc.collect()

    # A, B and C at a call's shapes (its first view), with both modes'
    # sequences' launches.
    rec, timings = slab_kernel_records(scene, views[0], (0, height),
                                       options.tile_entry_capacity, dev, "render_views_grad")
    check_live(rec, "render_views_grad")
    out["kernels"] = rec
    for t in timings.values():
        t["launches_by_replay"] = by_replay_all.get(t["kernel"].entry, 0)
    add_kernel_rows(ctx, timings, "render_views_grad",
                    f"render_grad (views): the differentiable render_views of {count} views a "
                    f"call and its backward through the graph pair, {scene.point_count} points "
                    f"at {width} x {height}, {len(GRAD_SEQUENCE) + len(GRAD_NEW_P)} steps of a "
                    f"user's loop in each mode", launches_all)
    return out


#: The sharded grad parts' sequence: (name, calls before one backward).
SHARDED_GRAD_STEPS = (("warm_up", 1), ("capture", 1), ("replay", 1), ("replay", 1),
                      ("two_calls_one_backward", 2))


def sharded_grad_against_eager(name, scene, pair_call, eager_call, loss, count,
                               miss_launches, progress=lambda stage: None) -> dict:
    """A sharded render under grad (``pair_call(ref)``: the public entry
    point, graph pair ``name``) against its eager form (``eager_call(ref)``)
    on this rank, each call with a fresh ref and ``loss(output).backward()``:
    :data:`SHARDED_GRAD_STEPS`, every output, parameter gradient and ref
    gradient bit for bit, one capture, ``count`` launches of A, B and C a
    replay (views or slabs on this rank); then the pair's costs
    (:func:`pair_costs`; the render and its backward alone may launch only
    the ``miss_launches`` of the ranks' miss decision from the host). Every
    rank makes the same calls in the same order; ``progress(stage)`` is
    called before each stage. Returns the record, with the replay's outputs
    and gradients under ``"replay_call"`` (removed before printing)."""
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    dev = scene.device
    graph = grad_graph(name, dev)
    graph.release()
    kernels = all_kernels()

    def calls(call, n, record):
        scene.zero_grad(set_to_none=True)
        refs = [torch.zeros((scene.point_count,), device=dev, requires_grad=True)
                for _ in range(n)]
        outs = [call(ref) for ref in refs]
        sum(loss(o) for o in outs).backward()
        if record is not None:
            record.append([t.detach() for o in outs for t in o]
                          + [p.grad for p in scene.parameters()] + [r.grad for r in refs])

    runs = {}
    for side, call in (("graph", pair_call), ("eager", eager_call)):
        progress(f"{name}: the sequence, {side}")
        torch.cuda.synchronize()
        for kernel in kernels:
            kernel.launches = 0
        record = []
        for _, n in SHARDED_GRAD_STEPS:
            calls(call, n, record)
        torch.cuda.synchronize()
        runs[side] = (record, {k.entry: k.launches for k in kernels})
        if side == "graph":
            counts = (graph.captures, graph.replays["forward"], graph.replays["backward"],
                      graph.moves)
            check(counts == (1, 5, 5, 1), f"{name}: the pair's captures, forward and "
                                          f"backward replays and moves {counts}")
            a_replay = check_per_replay(graph.pair, count, name)
            by_replay = {k.entry: n for k, n in graph.by_replay.items()}
    (got, launches), (want, eager_launches) = runs["graph"], runs["eager"]
    compare_records(got, want, name)
    replay_call = got[2]
    del runs, got, want

    ref = torch.zeros((scene.point_count,), device=dev, requires_grad=True)
    cot = torch.ones_like(replay_call[0])

    def render_only():
        scene.zero_grad(set_to_none=True)
        ref.grad = None
        pair_call(ref).colors_rgb_2d.backward(cot)

    progress(f"{name}: the pair's costs")
    costs = pair_costs(graph, types.SimpleNamespace(step=lambda: calls(pair_call, 1, None)),
                       types.SimpleNamespace(step=lambda: calls(eager_call, 1, None)),
                       render_only, name, kernels_allowed=miss_launches)
    scene.zero_grad(set_to_none=True)
    return dict(bit_for_bit=True, steps=[s for s, _ in SHARDED_GRAD_STEPS], captures=1,
                launches=launches, eager_launches=eager_launches, launches_by_replay=by_replay,
                launches_a_replay=a_replay, replay_call=replay_call, **costs)


def miss_decision(mesh, dev) -> dict:
    """The ranks' common miss decision alone (``any_rank``): host ms (median
    of ``REPS``) and the kernels it launches from the host."""
    from gausplat_tpu_torch.parallel._collectives import any_rank

    def decide():
        return any_rank(False, mesh.group, dev)

    ms = statistics.median(host_wall_ms(decide) for _ in range(REPS))
    try:
        launches = kernel_calls(profile_device_time(decide))
    except RuntimeError:  # the profiler is a measurement, not the path
        launches = 1
    return dict(host_ms=ms, kernel_launches=launches)


def nccl_grad_world1(ctx, targets) -> dict:
    """Phase render_grad's NCCL part: a (1, 1) ("data", "tiles") mesh over
    one NCCL rank in this process; ``render_data_parallel`` of the 4 orbit
    views and ``render_tile_sharded`` of the bench view under grad, each a
    user's loop (a fresh ref, an L1 loss against ``targets``,
    ``loss.backward()``) through its graph pair against its eager form
    (:func:`sharded_grad_against_eager`)."""
    import torch.distributed as dist

    from gausplat_tpu_torch.parallel import (
        make_mesh, render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.parallel.render import _data_parallel_eager, _tile_sharded_eager
    from gausplat_tpu_torch.render.views_graph import release_all
    from gausplat_tpu_torch.testing import free_port

    dev, scene, options, views = ctx["device"], ctx["scene"], ctx["options"], ctx["views"]
    w, h = views[0].image_width, views[0].image_height
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        grid = make_mesh((1, 1), ("data", "tiles"))
        cams = stack_cameras(views[1:], device=dev)
        orbit_targets = torch.stack(targets[1:])
        out = dict(backend=dist.get_backend(), miss_decision=miss_decision(grid, dev))
        out["render_data_parallel"] = sharded_grad_against_eager(
            "parallel.render_data_parallel", scene,
            lambda ref: render_data_parallel(scene, cams, w, h, grid, "data", options, ref),
            lambda ref: _data_parallel_eager(scene, cams, w, h, grid, "data", options, ref),
            lambda o: torch.mean(torch.abs(o.colors_rgb_2d - orbit_targets)), len(views) - 1,
            out["miss_decision"]["kernel_launches"])
        out["render_tile_sharded"] = sharded_grad_against_eager(
            "parallel.render_tile_sharded", scene,
            lambda ref: render_tile_sharded(scene, views[0], grid, "tiles", options, ref),
            lambda ref: _tile_sharded_eager(scene, views[0], grid, "tiles", options, ref),
            lambda o: torch.mean(torch.abs(o.colors_rgb_2d - targets[0])), 1,
            out["miss_decision"]["kernel_launches"])
    finally:
        release_all()  # the graphs that captured the group's collectives go first
        dist.destroy_process_group()
    for name in ("render_data_parallel", "render_tile_sharded"):
        del out[name]["replay_call"]
    return out


def phase_render_grad(ctx):
    """The differentiable ``render`` through its forward and backward graphs,
    against the eager render and its backward, at the serving shapes (the
    1M-point scene at 1920 x 1080, SH 3, the calibrated capacity; each
    view's target another view's render) and at the lego fit's (the
    4,114-point scene of the tools phase, 800 x 800)."""
    import gausplat_tpu_torch as T

    dev = ctx["device"]
    targets = ctx["targets"][1:] + ctx["targets"][:1]
    out = dict(card=ctx["card"])
    out["serving"] = render_grad_config(ctx, "render_grad", ctx["scene"], ctx["views"],
                                        targets, ctx["options"])
    out["views"] = render_views_grad_config(ctx, ctx["scene"], ctx["views"], targets,
                                            ctx["options"])
    out["nccl_world_1"] = nccl_grad_world1(ctx, targets)
    lego = ctx.pop("lego_grad")
    scene = T.GaussianScene.from_numpy(**lego["arrays"], device=dev)
    out["lego"] = render_grad_config(ctx, "render_grad_lego", scene, lego["views"],
                                     lego["targets"], lego["options"])
    return out


def nvidia_smi_all(query: str) -> list:
    """``nvidia-smi --query-gpu`` for every card, one line each."""
    done = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return done.stdout.strip().splitlines()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on the card(s).")
    parser.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                        help=f"1: every phase on card 0 (the default); {CARDS}: the parallel "
                             f"path with one NCCL rank per card (phases env, nccl_cards)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} cards, "
              f"{torch.cuda.device_count()} visible; nothing was run", file=sys.stderr)
        return 1
    import gausplat_tpu_torch as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    ctx = dict(device=device, card=nvidia_smi("name,power.limit"), kernels=[])

    phases = [("env", phase_env), ("expand", phase_expand), ("rasterize", phase_rasterize),
              ("fixture", phase_fixture), ("main_path", phase_main_path),
              ("rasterize_backward", phase_rasterize_backward),
              ("adversarial", phase_adversarial), ("grad", phase_grad),
              ("train", phase_train), ("colmap_bf16", phase_colmap_bf16),
              ("parallel", phase_parallel), ("tools", phase_tools),
              ("scripts", phase_scripts), ("fit_scan", phase_fit_scan),
              ("render_grad", phase_render_grad)]
    if args.cards == CARDS:
        phases = [("env", phase_env), ("nccl_cards", phase_nccl_cards)]
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

    for line in nvidia_smi_all("name,power.limit")[:args.cards]:
        print(line, flush=True)
    print(json.dumps({"kernels": ctx["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": args.cards if args.cards > 1 else torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
