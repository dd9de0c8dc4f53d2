"""Whole runs of each cell at a tiny size on the CPU, through the port's
plain versions: the result line's keys, no JAX loaded, and ``correct``
false under each fault a cell can have and under the serving control."""

import subprocess
import sys

import pytest
import torch

from benchmark import harness, reference as R
from benchmark.tests.conftest import dry_run, tiny_cell

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name,trace", [("mipnerf360_train", False), ("mipnerf360_train", True),
                                        ("mipnerf360_serve", False), ("mipnerf360_serve", True)])
def test_result_line(name, trace):
    cell = tiny_cell(name)
    result, checks = dry_run(cell, trace=trace)
    assert RESULT_KEYS <= set(result) and result["correct"] is True, checks
    assert set(checks) == set(cell.limits)
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    if trace:
        assert {"busy_s", "window_s"} <= set(device) and "breakdown" in result
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())


def test_dry_path_loads_no_jax():
    code = ("import sys; from benchmark.tests.conftest import dry_run, tiny_cell; "
            "dry_run(tiny_cell('mipnerf360_train')); dry_run(tiny_cell('mipnerf360_serve')); "
            "from benchmark import harness; "
            "assert 'gausplat_tpu_torch' in {m.split('.')[0] for m in sys.modules}; "
            "print(harness.forbidden_modules())")
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gausplat_tpu_torch_fake.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gausplat_tpu.sub", sys)
    assert harness.forbidden_modules() == ["gausplat_tpu"]


def test_train_state_unchanged_is_caught(monkeypatch):
    from gausplat_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Trainer, "_apply_gradients",
                        lambda self, loss, ref: torch.zeros_like(ref))
    result, checks = dry_run(tiny_cell("mipnerf360_train"))
    assert result["correct"] is False, checks
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_caught(monkeypatch):
    from gausplat_tpu_torch.train import trainer

    loss = trainer.photometric_loss
    monkeypatch.setattr(trainer, "photometric_loss",
                        lambda image, target, w: loss(image[: image.shape[0] // 2],
                                                      target[: target.shape[0] // 2], w))
    result, checks = dry_run(tiny_cell("mipnerf360_train"))
    assert result["correct"] is False, checks


def serve_fault(monkeypatch, alter):
    import gausplat_tpu_torch as T

    render_views = T.render_views
    monkeypatch.setattr(T, "render_views", lambda scene, views, options: alter(
        render_views(scene, views, options), scene, views))
    cell = tiny_cell("mipnerf360_serve")
    cell.mix["views"] = [2, 4]
    result, checks = dry_run(cell)
    assert result["correct"] is False, checks


def test_serve_altered_answer_is_caught(monkeypatch):
    def alter(out, scene, views):
        out.colors_rgb_2d[0] += 1.0 / 255.0
        return out

    serve_fault(monkeypatch, alter)


def test_serve_half_batch_left_out_is_caught(monkeypatch):
    def alter(out, scene, views):
        half = len(views) // 2
        return type(out)(*(f.clone().index_copy_(0, torch.arange(half, len(views)),
                                                 f[:len(views) - half]) for f in out))

    serve_fault(monkeypatch, alter)


def test_serve_control_in_bfloat16_is_caught(monkeypatch):
    """The control: the reference in bfloat16 in the program's place."""
    from benchmark.traffic import serve

    def alter(out, scene, views):
        params = {f: getattr(scene, f).detach() for f in R.FIELDS}
        frames = []
        for view in views:
            cam = R.Cam(rotation=view.view_rotation(), translation=view.view_translation(),
                        position=view.view_position,
                        fov=(view.field_of_view_x, view.field_of_view_y),
                        width=view.image_width, height=view.image_height)
            frames.append(serve.as_output(R.render(params, cam, dtype=torch.bfloat16)))
        return type(out)(*(torch.cat([getattr(f, k) for f in frames]) for k in out._fields))

    serve_fault(monkeypatch, alter)


def test_train_control_in_tf32_is_caught():
    """The control: the reference with every operand of its matrix products
    and convolutions rounded to TF32, in the program's place."""
    from benchmark import calibrate

    cell = tiny_cell("mipnerf360_train")
    numbers = calibrate.train_readings(cell, 2 ** 33 + 1, ("control",),
                                       torch.device("cpu"))["control"]
    assert not harness.judge(numbers, cell.limits)[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mipnerf360_train", "mipnerf360_serve"])
def test_tiny_cell_on_the_card(card, name):
    """The tiny cells through the hand-written kernels and the graphs."""
    import importlib
    import time

    cell = tiny_cell(name)
    driver = importlib.import_module(f"benchmark.traffic.{cell.mix['driver']}")
    result, checks = driver.run(dict(cell=cell, seed=2 ** 35 + 3, seconds=1.0, trace=True,
                                     started=time.time(), device=card))
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
