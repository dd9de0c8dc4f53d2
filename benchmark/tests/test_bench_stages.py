"""The stage readers against synthetic run records, the means they read,
and ``benchmark/stages.py``'s sub-window on a tiny copy of each cell's
program on the CPU and on a graph that misses inside it."""

import math

import pytest
import torch

from benchmark import harness, stages
from benchmark.tests.conftest import tiny_cell
from gausplat_tpu_torch.utils.profiling import Span


def _stage(start, end, n=1):
    return dict(n=n, ms=end - start, start_ms=start, end_ms=end, total_ms=n * (end - start))


#: A step's stage means (ms): the backward from 20 to 50, the rasterizer's
#: VJP from 24 to 41 inside it.
TRAIN = {
    "train.step": _stage(0.0, 55.0),
    "render.project": _stage(0.5, 4.5),
    "render.bin": _stage(4.5, 6.0),
    "render.rasterize": _stage(6.0, 7.5),
    "train.loss": _stage(7.5, 12.0),
    "train.backward": _stage(12.5, 50.0),
    "render.rasterize_vjp": _stage(24.0, 41.0),
    "render.rasterize_bwd": _stage(24.0, 27.0),
    "render.reduce": _stage(27.0, 41.0),
    "train.adam": _stage(50.0, 54.5),
}
#: A request's means: 8 views, each view's stages once on its stream.
SERVE = {
    "serve.request": _stage(0.0, 70.0),
    "render.project": _stage(1.0, 7.0, n=8),
    "render.bin": _stage(7.0, 9.5, n=8),
    "render.rasterize": _stage(9.5, 11.0, n=8),
}
WANT = {
    "projection_ms.train": 4.0 + (50.0 - 41.0),
    "binning_ms.train": 1.5,
    "reduce_ms.train": 14.0,
    "loss_ms.train": 4.5 + (24.0 - 12.5),
    "adam_ms.train": 4.5,
    "projection_ms.serve": 6.0,
    "binning_ms.serve": 2.5,
}


def _read(name, run):
    return harness.read_metrics([{"name": name, "unit": "ms"}], run)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_stage_means(name):
    run = dict(stages=TRAIN if name.endswith(".train") else SERVE)
    assert _read(name, run)[name]["value"] == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_stages(name):
    assert _read(name, {}) == {}
    assert _read(name, dict(stages={"train.step": _stage(0.0, 1.0)})) == {}


def test_stage_means_over_units():
    units = [[Span("serve.request", None, 1, 0.0, 10.0), Span("render.bin", 0, 2, 1.0, 3.0),
              Span("render.bin", 0, 3, 2.0, 6.0)],
             [Span("serve.request", None, 1, 0.0, 12.0), Span("render.bin", 0, 2, 1.0, 2.0),
              Span("render.bin", 0, 3, 1.0, 4.0)]]
    means = stages.stage_means(units)
    assert means["serve.request"] == _stage(0.0, 11.0)
    assert means["render.bin"] == dict(n=2.0, ms=2.5, start_ms=1.25, end_ms=3.75, total_ms=5.0)
    assert stages.coverage(TRAIN) == pytest.approx((4 + 1.5 + 1.5 + 4.5 + 37.5 + 4.5) / 55.0)


#: Each cell kind's readers of a run record's ``stages``.
READERS = {"train": sorted(n for n in WANT if n.endswith(".train")),
           "serve": sorted(n for n in WANT if n.endswith(".serve"))}


def _program(cell, device):
    """The cell's program on ``device``, built as its driver builds it: the
    unit of its stage sub-window and the graph the unit runs through."""
    from gausplat_tpu_torch.render.views_graph import views_graph

    if cell.mix["driver"] == "train":
        from benchmark.traffic import train as D

        state = D.build(cell, 2 ** 33 + 7, device)
        trainer, views = D.make_trainer(cell, state)

        def unit():
            j = trainer.step_count % len(views)
            trainer.train_step(views[j], state["targets"][j])

        return unit, trainer._step_graph
    from benchmark.traffic import serve as D

    state = D.build(cell, 2 ** 33 + 7, device)
    serve = D.make_server(cell, state)
    calls = iter(range(10 ** 9))
    return (lambda: serve(state["plan"][next(calls) % len(state["plan"])]),
            views_graph("render_views", device).graph)


@pytest.mark.parametrize("name", ["mipnerf360_train", "mipnerf360_serve"])
def test_stage_window_on_the_cpu(name):
    cell = tiny_cell(name)
    device = torch.device("cpu")
    unit, graph = _program(cell, device)
    got = stages.stage_window(unit, graph, 0.1, lambda: harness.sync(device))
    kept = got["units"]
    assert kept >= 3 and got["counters"] == dict(misses=0, eager_steps=kept + 2, captures=0,
                                                 replays=0)  # CPU: all eager
    assert got["miss_ms"] == {}
    means = got["means"]
    root = "train.step" if name.endswith("train") else "serve.request"
    assert means[root]["n"] == 1 and means["render.project"]["n"] == (
        1 if name.endswith("train") else max(cell.mix["views"]))
    metrics = harness.read_metrics([{"name": n, "unit": "ms"}
                                    for n in READERS[cell.mix["driver"]]], dict(stages=means))
    assert set(metrics) == set(READERS[cell.mix["driver"]])
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in metrics.values())
    stages.log_window(got)


class _Graph:
    """A graph's counters and spans: the unit numbered ``miss_at`` misses."""

    def __init__(self, miss_at):
        self.misses = self.eager_steps = self.captures = self.replays = 0
        self.miss_ms, self.miss_at, self.calls = {}, miss_at, 0

    def unit(self):
        self.calls += 1
        if self.calls in (1, self.miss_at):
            self.misses += 1
            self.eager_steps += 1
            self.miss_ms = {"warm_up_ms": 3.0}
        elif self.calls in (2, self.miss_at + 1):
            self.captures += 1
            self.replays += 1
            self.miss_ms["capture_ms"] = 5.0
        else:
            self.replays += 1

    def spans(self):
        return [Span("train.step", None, 0, 0.0, float(self.calls))]


def test_stage_window_leaves_out_the_units_that_miss():
    graph = _Graph(miss_at=4)
    got = stages.stage_window(graph.unit, graph, 0.0, lambda: None)
    # Units 1-2 before the window, then 3 kept, 4 (a miss) and 5 (the capture) not.
    assert got["units"] == 1 and got["means"]["train.step"]["ms"] == 3.0
    assert got["counters"] == dict(misses=2, eager_steps=2, captures=2, replays=3)
    assert got["miss_ms"] == {"warm_up_ms": 3.0, "capture_ms": 5.0}
