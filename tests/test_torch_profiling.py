"""The port's profiling helpers (``gausplat_tpu_torch.utils.profiling``)
against the JAX package's, as ``tests/test_utils.py`` tests those: the
logger names, ``stage`` under autograd and in a ``torch.profiler`` run
and its Chrome trace, ``wall_timer``, ``log_stage``."""

import json
import logging

import torch

from gausplat_tpu_torch.utils import profiling


def test_logger_names_match_jax():
    from gausplat_tpu.utils import profiling as jp

    for name in ("logger", "logger_scene", "logger_forward", "logger_backward"):
        assert getattr(profiling, name).name == getattr(jp, name).name


def test_stage_composes_with_autograd():
    x = torch.arange(4.0, requires_grad=True)
    with profiling.stage("gausplat.test"):
        y = (x * x).sum()
    y.backward()
    assert torch.equal(x.grad, 2 * torch.arange(4.0))


def test_stage_is_listed_by_the_profiler_and_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.stage("gausplat.test_stage"):
            torch.ones(8).add_(1)
    assert any(e.key == "gausplat.test_stage" for e in prof.key_averages())
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "gausplat.test_stage" in names


def test_wall_timer_records():
    results = {}
    with profiling.wall_timer("unit", results):
        pass
    assert "unit" in results and results["unit"] >= 0


def test_log_stage_no_crash(monkeypatch, caplog):
    profiling.log_stage(profiling.logger_forward, "forward stage message")
    monkeypatch.setattr(profiling, "_DEBUG", True)
    with caplog.at_level(logging.DEBUG, logger=profiling.logger.name):
        profiling.log_stage(profiling.logger_forward, "logged")
    assert "logged" in caplog.text
