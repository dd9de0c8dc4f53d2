"""Training: ``Trainer.fit``, one graph replay a step, round robin over the
mix's views, from the mix's global step.

Set-up draws the scene from the seed on the device, renders the targets
with the reference (timed apart, and not counted in ``setup_s``), moves the
scene by seeded noise for the start, builds
one ``Trainer`` and drives it through its first steps with ``fit`` (the
window's own call: an eager step, the capture, replays). The readings of
those steps are kept: each step's loss, the first gradient as Adam's first
moment holds it after one step, the parameters' change after three. The
window then calls ``fit`` in chunks of ``chunk_steps`` until ``--seconds``
have passed. After it, the trainer is freed and the reference runs the same
three steps from the same start; the gaps are the checks.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from .. import harness, reference as R, scenes as S, workcount

#: Adam's first-moment decay in the program's optimizer (its state holds
#: (1 - b1) g after one step from a fresh state).
ADAM_B1 = 0.9


def set_precision(tf32: bool) -> None:
    """TF32 for f32 matmuls and convolutions: off where the configuration
    states float32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build(cell, seed: int, device) -> dict:
    """The benchmark's inputs: the reference's cameras, targets and start;
    ``reference_s``: the seconds the targets' renders took."""
    cfg, mix = cell.config, cell.mix
    params, gen = S.make_scene(cfg, seed, device)
    cams = S.orbit_pool(cfg, mix["views"], mix["orbit"], seed)
    harness.sync(device)
    began = time.perf_counter()
    targets = [R.render(params, cam)["image"] for cam in cams]
    harness.sync(device)
    reference_s = time.perf_counter() - began
    start = S.noisy_start(params, cfg["start"], gen)
    del params
    return dict(cams=cams, targets=targets, start=start, extent=R.camera_extent(cams),
                reference_s=reference_s)


def make_trainer(cell, state: dict):
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch import train as TT

    cfg, mix = cell.config, cell.mix
    scene = T.GaussianScene(**{f: state["start"][f].clone() for f in S.FIELDS})
    views = [S.to_view(T, cam) for cam in state["cams"]]
    options = T.calibrate_options(scene, views, T.RenderOptions(**cfg["render"]),
                                  margin=mix["capacity_margin"])
    extent = state["extent"]
    config = TT.TrainConfig(
        **cfg["train"], render=options,
        optimizer=TT.OptimizerConfig(**cfg["optimizer"], scene_extent=extent),
        densify=TT.DensifyConfig(scene_extent=extent))
    trainer = TT.Trainer(scene, cfg["width"], cfg["height"], config)
    trainer.step_count = mix["start_step"]
    return trainer, views


def program_steps(trainer, views, targets, start: dict, steps: int) -> dict:
    """The program's first ``steps`` steps through ``fit``, one call a step."""
    losses, grad = [], None
    for k in range(steps):
        losses.append(trainer.fit(views, targets, 1)[0]["loss"])
        if k == 0:
            grad = {f: trainer._opt_state["adam"][f][1] / (1 - ADAM_B1) for f in S.FIELDS}
    change = {f: getattr(trainer.scene, f).detach() - start[f] for f in S.FIELDS}
    return dict(losses=losses, grad=grad, change=change)


def reference_steps(cell, state: dict, steps: int, tf32: bool = False,
                    loss_rows=None) -> dict:
    """The reference's first ``steps`` steps from the same start and views;
    ``work``: each step's view counts for the work functions."""
    cfg, mix = cell.config, cell.mix
    params = {f: state["start"][f].clone() for f in S.FIELDS}
    o = cfg["optimizer"]
    adam = R.Adam(state["extent"], position_lr=(o["position_lr_init"], o["position_lr_final"]),
                  position_steps=o["position_lr_max_steps"], sh_lr=o["colors_sh_dc_lr"],
                  sh_rest_div=o["colors_sh_rest_div"], opacity_lr=o["opacity_lr"],
                  scaling_lr=o["scaling_lr"], rotation_lr=o["rotation_lr"], eps=o["eps"])
    adam_state = {}
    losses, grad, work = [], None, []
    for k in range(steps):
        i = (mix["start_step"] + k) % len(state["cams"])
        loss, g, frame = R.gradients(params, state["cams"][i], state["targets"][i],
                                     cfg["train"]["ssim_weight"], loss_rows=loss_rows,
                                     tf32=tf32)
        losses.append(float(loss))
        work.append(workcount.view_counts(cfg, frame))
        if k == 0:
            grad = {f: g[f].clone() for f in S.FIELDS}
        adam.step(params, g, adam_state, mix["start_step"] + k + 1)
    change = {f: params[f] - state["start"][f] for f in S.FIELDS}
    return dict(losses=losses, grad=grad, change=change, work=work)


def leaf_gap(got: dict, want: dict, grads: dict) -> float:
    """The worst leaf's gap between the norms of ``got`` and ``want``, over
    the larger of that leaf's reference norm and the median leaf's; leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out (Adam moves them by round-off alone)."""
    gnorm = {f: float(grads[f].norm()) for f in grads}
    counted = [f for f in gnorm if gnorm[f] >= 1e-3 * statistics.median(gnorm.values())]
    norms = {f: float(want[f].norm()) for f in counted}
    floor = statistics.median(norms.values())
    return max(abs(float(got[f].norm()) - norms[f]) / max(norms[f], floor) for f in counted)


def compare(got: dict, want: dict) -> dict:
    return dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        grad_gap=leaf_gap(got["grad"], want["grad"], want["grad"]),
        change_gap=leaf_gap(got["change"], want["change"], want["grad"]),
    )


def window(trainer, views, targets, seconds: float, chunk: int) -> tuple[int, float, list]:
    """``fit`` in chunks of ``chunk`` steps until ``seconds`` have passed:
    (steps, seconds, losses). ``fit`` reads its metrics back at the end of
    each chunk, so each chunk ends synchronised; its end is logged."""
    steps, losses, marks = 0, [], []
    start = time.perf_counter()
    while steps == 0 or time.perf_counter() - start < seconds:
        losses += [h["loss"] for h in trainer.fit(views, targets, chunk)]
        steps += chunk
        marks.append((time.perf_counter() - start, steps))
    harness.log_timeline(marks)
    return steps, marks[-1][0], losses


def run(ctx: dict) -> tuple[dict, dict]:
    cell, device = ctx["cell"], ctx["device"]
    mix = cell.mix
    set_precision(cell.config["precision"] != "float32")
    torch.manual_seed(0)
    state = build(cell, ctx["seed"], device)
    harness.sync(device)
    harness.reset_peak(device)
    trainer, views = make_trainer(cell, state)
    got = program_steps(trainer, views, state["targets"], state["start"], mix["checked_steps"])
    harness.sync(device)
    setup_s = time.time() - ctx["started"] - state["reference_s"]
    harness.log(f"reference targets: {state['reference_s']!r} s, not in setup_s")
    run_rec, trace = {}, None
    if ctx["trace"]:
        def unit():
            j = trainer.step_count % len(views)
            trainer.train_step(views[j], state["targets"][j])

        harness.log("card:", harness.nvidia_smi("name,power.limit"))
        trace = harness.profile_units(unit, mix["profile_seconds"], lambda: harness.sync(device))
        harness.log("port kernels: launches counted", trace.counted, "records held",
                    {k: len(trace.records(lambda n, k=k: k in n)) for k in trace.counted})
    steps, seconds, losses = window(trainer, views, state["targets"], ctx["seconds"],
                                    mix["chunk_steps"])
    harness.sync(device)
    peak = harness.peak_bytes(device)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(cell, state, mix["checked_steps"])
    ok, checks = harness.judge(compare(got, want), cell.limits)
    failed = sum(1 for x in losses if not math.isfinite(x))
    step_ms = seconds * 1e3 / steps
    if ctx["trace"]:
        run_rec = dict(trace=trace, step_ms=step_ms, work=workcount.mean_view(want["work"]))
        metrics = harness.read_metrics(cell.per_layer, run_rec)
    else:
        metrics = harness.end_to_end(cell, train_step_ms=step_ms, setup_s=setup_s)
    result = dict(correct=ok and failed == 0, attempted=steps, failed=failed, metrics=metrics,
                  device=harness.device_record(device, peak, trace))
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    return result, checks
