"""Fixtures of the benchmark's own tests: a tiny copy of each cell, run on
the CPU through the port's plain versions, and the card check of the tests
marked ``cuda``."""

import json

import pytest
import torch

from benchmark import harness

torch.set_num_threads(2)


def tiny_cell(name: str) -> harness.Cell:
    """``name``'s cell at 3,000 points and 64 x 48 (the limits as committed)."""
    cell = harness.find_cell(name)
    cfg = json.loads(json.dumps(cell.config))
    cfg.update(points=3000, width=64, height=48)
    cfg["scene"].update(position_std=1.0, scale_min=0.02, scale_span=0.08)
    cfg["camera"]["distance"] = 4.0
    mix = dict(cell.mix, pool=8, chunk_steps=2, profile_seconds=0.2, planned_requests=40)
    return harness.Cell(cell.name, cell.chips, cfg, mix, cell.limits, cell.end_to_end,
                        cell.per_layer)


def dry_run(cell: harness.Cell, seed: int = 2 ** 33 + 7, trace: bool = False,
            seconds: float = 0.3) -> tuple:
    """One run of ``cell`` on the CPU: (result, checks)."""
    import importlib
    import time

    driver = importlib.import_module(f"benchmark.traffic.{cell.mix['driver']}")
    return driver.run(dict(cell=cell, seed=seed, seconds=seconds, trace=trace,
                           started=time.time(), device=torch.device("cpu")))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
