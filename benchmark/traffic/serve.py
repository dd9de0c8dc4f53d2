"""Serving: a closed loop of one caller, each request ``render_views`` under
``torch.no_grad`` (the default mode) of V views of one scene.

Set-up draws the scene from the seed on the device and a pool of orbit
cameras on the host, calibrates the entry capacity over the pool, and plans
the requests: V cycles through the mix's sizes in a seeded order in each
block of them, so every seed serves the same sizes, and each request takes
V distinct cameras of the pool. Only the graphs of those V are warmed and
captured. (The program keeps one graph per entry point: a mix of several
sizes misses it, and recaptures, wherever V changes.) A request's latency
runs from its issue to a CUDA event recorded after the call. A seeded
reservoir keeps the outputs of a few finished requests; after the window
the reference renders their views and every output field is compared.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from .. import harness, reference as R, scenes as S, workcount

#: A pixel is off where a value differs from the reference's by more than
#: this (1e-3 of the [0, 1] colour range, a quarter of 1/255).
PIXEL_TOL = 1e-3


def build(cell, seed: int, device) -> dict:
    cfg, mix = cell.config, cell.mix
    params, _ = S.make_scene(cfg, seed, device)
    pool = S.orbit_pool(cfg, mix["pool"], mix["orbit"], seed)
    rng = S.host_rng(seed, 2)
    plan = []
    for _ in range(mix["planned_requests"] // len(mix["views"])):
        plan += [[int(i) for i in rng.choice(len(pool), int(v), replace=False)]
                 for v in rng.permutation(mix["views"])]
    return dict(params=params, pool=pool, plan=plan, rng=rng)


def make_server(cell, state: dict):
    import gausplat_tpu_torch as T

    scene = T.GaussianScene(**{f: state["params"][f].clone() for f in S.FIELDS})
    views = [S.to_view(T, cam) for cam in state["pool"]]
    with torch.no_grad():
        options = T.calibrate_options(scene, views, T.RenderOptions(**cell.config["render"]))

    def serve(indices):
        with torch.no_grad():
            return T.render_views(scene, [views[i] for i in indices], options)

    return serve


def warm_up(serve, sizes, rounds: int = 3) -> None:
    """Each size's graph: its eager call, its capture, a replay."""
    for v in sizes:
        for _ in range(rounds):
            serve(list(range(v)))


def window(serve, plan: list, seconds: float, keep: int, rng, device, events: bool) -> dict:
    """The closed loop for ``seconds``: latencies (ms), views, the kept
    requests ``(plan index, output)`` (a seeded reservoir of ``keep``), and
    with ``events`` each request's latency less its device time. Each
    request's end, views so far and latency are logged."""
    latencies, overhead, kept, views, marks = [], [], [], 0, []
    cuda = device.type == "cuda"
    start = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - start < seconds:
        indices = plan[n % len(plan)]
        issued = time.perf_counter()
        if cuda:
            begin = torch.cuda.Event(enable_timing=events)
            begin.record()
        out = serve(indices)
        if cuda:
            done = torch.cuda.Event(enable_timing=events)
            done.record()
            done.synchronize()
        ended = time.perf_counter()
        ms = (ended - issued) * 1e3
        latencies.append(ms)
        if events and cuda:
            overhead.append(ms - begin.elapsed_time(done))
        views += len(indices)
        marks.append((ended - start, views, ms))
        if len(kept) < keep:
            kept.append((n, out))
        else:
            slot = int(rng.integers(0, n + 1))
            if slot < keep:
                kept[slot] = (n, out)
        n += 1
    harness.log_timeline(marks)
    return dict(requests=n, views=views, seconds=time.perf_counter() - start,
                latencies=latencies, overhead=overhead, kept=kept)


def compare_view(out, v, want: dict) -> dict:
    """View ``v`` of a served output (the whole output where ``v`` is None)
    against the reference's frame."""
    got = type(out)(*(f if v is None else f[v] for f in out))
    diff = (got.colors_rgb_2d - want["image"]).abs()
    trans = (got.transmittances - want["trans"]).abs()
    return dict(
        image_err=float(diff.mean()),
        image_off=float((diff.amax(-1) > PIXEL_TOL).float().mean()),
        trans_off=float((trans > PIXEL_TOL).float().mean()),
        count_off=float((got.point_rendered_counts != want["counts"]).float().mean()),
        radii_off=float((got.radii != want["radii"]).float().mean()),
        total_gap=abs(int(got.tile_point_total) - want["total"]) / max(want["total"], 1),
    )


Frames = collections.namedtuple("Frames", "colors_rgb_2d radii tile_point_total transmittances "
                                           "point_rendered_counts")


def as_output(frame: dict) -> Frames:
    """A reference frame in the fields of the program's output, with a
    leading view axis of one."""
    fields = Frames(colors_rgb_2d=frame["image"].float(), transmittances=frame["trans"].float(),
                    point_rendered_counts=frame["counts"], radii=frame["radii"],
                    tile_point_total=torch.tensor(frame["total"]))
    return Frames(*(f[None] for f in fields))


def check(cell, state: dict, kept: list) -> tuple[dict, list]:
    """The kept requests' views against the reference: the worst of each
    number over them, and each view's work counts."""
    worst, work = {}, []
    for n, out in kept:
        for v, i in enumerate(state["plan"][n % len(state["plan"])]):
            want = R.render(state["params"], state["pool"][i])
            for k, x in compare_view(out, v, want).items():
                worst[k] = max(worst.get(k, 0.0), x)
            work.append(workcount.view_counts(cell.config, want))
            del want
    return worst, work


def release_program() -> None:
    """Free the program's captured graphs and their pools."""
    from gausplat_tpu_torch.render import views_graph

    views_graph.release_all()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx: dict) -> tuple[dict, dict]:
    cell, device = ctx["cell"], ctx["device"]
    mix = cell.mix
    torch.backends.cuda.matmul.allow_tf32 = cell.config["precision"] != "float32"
    torch.backends.cudnn.allow_tf32 = cell.config["precision"] != "float32"
    state = build(cell, ctx["seed"], device)
    harness.reset_peak(device)
    serve = make_server(cell, state)
    warm_up(serve, mix["views"])
    harness.sync(device)
    setup_s = time.time() - ctx["started"]
    trace = None
    if ctx["trace"]:
        harness.log("card:", harness.nvidia_smi("name,power.limit"))
        plan_iter = iter(range(10 ** 9))

        def unit():
            indices = state["plan"][next(plan_iter) % len(state["plan"])]
            serve(indices)
            return len(indices)

        trace = harness.profile_units(unit, mix["profile_seconds"], lambda: harness.sync(device))
        harness.log("port kernels: launches counted", trace.counted, "records held",
                    {k: len(trace.records(lambda n, k=k: k in n)) for k in trace.counted})
    got = window(serve, state["plan"], ctx["seconds"], mix["checked_requests"], state["rng"],
                 device, ctx["trace"])
    harness.sync(device)
    peak = harness.peak_bytes(device)
    del serve
    release_program()
    numbers, work = check(cell, state, got["kept"])
    ok, checks = harness.judge(numbers, cell.limits)
    if ctx["trace"]:
        run_rec = dict(trace=trace, view_ms=got["seconds"] * 1e3 / got["views"],
                       work=workcount.mean_view(work), host_overhead_ms=got["overhead"])
        metrics = harness.read_metrics(cell.per_layer, run_rec)
    else:
        metrics = harness.end_to_end(cell, serve_views_per_s=got["views"] / got["seconds"],
                                     serve_p95_ms=harness.percentile(got["latencies"], 95),
                                     setup_s=setup_s)
    result = dict(correct=ok, attempted=got["requests"], failed=0, metrics=metrics,
                  device=harness.device_record(device, peak, trace))
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    return result, checks
