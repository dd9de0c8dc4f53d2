"""The port's stages (``gausplat_tpu_torch.utils.profiling``) on the CPU:
``stage`` under autograd and in a ``torch.profiler`` run and its Chrome
trace; with stage timing on, the spans of an eager training step (the
stage tree, children within their parents, siblings in order) and of each
served view; with it off, no span, and a graph key that differs; the host
spans seen by the profiler as operators' records, not user annotations,
and none entered without one; ``StepGraph``'s counts over a release. The spans inside captured
graphs are the card's (``tests/test_torch_cuda.py``)."""

import collections
import json

import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu_torch import train as TT
from gausplat_tpu_torch.render.views_graph import views_graph
from gausplat_tpu_torch.utils import profiling
from gausplat_tpu_torch.utils.step_graph import address_key

from torch_helpers import (
    RENDER_STAGES, SMALL, TRAIN_TREE, port_view, scene_arrays, stage_tree, train_arrays,
)

W, H = 48, 32
OPTIONS = T.RenderOptions(tile_entry_capacity=2048, block_size=64)


def _trainer():
    scene = T.GaussianScene.from_numpy(**train_arrays(25, 9), device="cpu")
    return TT.Trainer(scene, W, H, TT.TrainConfig(render=OPTIONS))


def _target(seed=0):
    return torch.rand((H, W, 3), generator=torch.Generator().manual_seed(seed))


def _assert_nested_in_order(spans):
    """Each span within its parent, and after its previous sibling."""
    last_end = {}
    for s in spans:
        assert s.start_ms <= s.end_ms, s
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ms <= s.start_ms and s.end_ms <= p.end_ms, (s, p)
        assert s.start_ms >= last_end.get(s.parent, float("-inf")), s
        last_end[s.parent] = s.end_ms


def _serve(scene, mode, views=2):
    ps = [port_view(SMALL["width"], SMALL["height"], (0.3 * i, 0.1 * i, -4.0))
          for i in range(views)]
    opts = T.RenderOptions(tile_entry_capacity=SMALL["capacity"], block_size=SMALL["block"])
    with torch.no_grad():
        return T.render_views(scene, ps, opts, mode=mode)


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


def test_eager_train_step_reports_the_stage_tree():
    trainer = _trainer()
    with profiling.stage_timing():
        trainer.train_step(port_view(W, H), _target())
    spans = trainer._step_graph.spans()
    assert stage_tree(spans) == TRAIN_TREE
    assert all(s.stream is None for s in spans)
    _assert_nested_in_order(spans)


def test_train_step_batch_reports_the_render_once_a_view():
    trainer = _trainer()
    views = [port_view(W, H), port_view(W, H, (0.3, 0.1, -4.0))]
    with profiling.stage_timing():
        trainer.train_step_batch(views, [_target(0), _target(1)])
    spans = trainer._batch_graph.spans()
    counts = collections.Counter(stage_tree(spans))
    assert counts == collections.Counter(
        {edge: 2 if edge[0].startswith("render.") else 1 for edge in TRAIN_TREE})
    assert [s.name for s in spans[1:7]] == RENDER_STAGES * 2
    _assert_nested_in_order(spans)


def test_timing_off_records_no_span_and_the_switch_is_keyed():
    trainer = _trainer()
    trainer.train_step(port_view(W, H), _target())
    assert trainer._step_graph.spans() == []
    tensors = [torch.zeros(3)]
    off = address_key("k", tensors)
    with profiling.stage_timing():
        on = address_key("k", tensors)
        with profiling.stage_timing(False):
            assert address_key("k", tensors) == off
    assert on != off and address_key("k", tensors) == off


@pytest.mark.parametrize("mode", ["vmap", "map"])
def test_eager_render_views_reports_each_views_stages(mode):
    scene = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"]), device="cpu")
    with profiling.stage_timing():
        _serve(scene, mode)
    spans = views_graph("render_views", torch.device("cpu")).graph.spans()
    assert stage_tree(spans) == [("serve.request", None)] + [
        (name, "serve.request") for name in RENDER_STAGES * 2]
    _assert_nested_in_order(spans)


def test_host_spans_appear_under_the_profiler():
    trainer = _trainer()
    scene = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"]), device="cpu")
    with torch.profiler.profile() as prof:
        trainer.fit([port_view(W, H)], [_target()], 1)
        _serve(scene, "vmap")
    names = {e.name for e in prof.events()}
    for name in ("trainer.host_events", "trainer.readback", "train.step", "render.project",
                 "render.rasterize_vjp", "train.adam", "serve.request",
                 "views_graph.copy_in", "views_graph.copy_out"):
        assert name in names, name


def test_no_record_function_is_entered_without_a_profiler(monkeypatch):
    entered = []
    real = profiling._host_record

    class Recorded:
        def __init__(self, name):
            self.name, self.inner = name, real(name)

        def __enter__(self):
            entered.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(profiling, "_host_record", Recorded)
    trainer = _trainer()
    with profiling.stage_timing():
        trainer.train_step(port_view(W, H), _target())
    assert entered == []
    with torch.profiler.profile():
        trainer.train_step(port_view(W, H), _target())
    assert [n for n in entered if n.startswith(("train.", "render."))] == [
        name for name, _ in TRAIN_TREE]


def test_stage_records_are_not_user_annotations():
    """A user annotation is drawn on the device's timeline too, over the
    kernels launched inside it; a stage's record is an operator's, which
    stays on the host, while the caller's annotation keeps its own scope."""
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function("caller"):
            with profiling.stage("step_graph.replay"):
                torch.ones(8).add_(1)
    scopes = {e.name: e.scope for e in prof.events()
              if e.name in ("caller", "step_graph.replay")}
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    assert scopes["caller"] == user and scopes["step_graph.replay"] != user, scopes


def test_step_graph_counts_eager_steps_and_a_release_keeps_them():
    scene = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"]), device="cpu")
    graph = views_graph("render_views", torch.device("cpu"))
    before = graph.graph.eager_steps
    _serve(scene, "map")
    _serve(scene, "map")
    step_graph = graph.graph
    assert step_graph.eager_steps == before + 2
    graph.release()
    assert graph.graph is step_graph and step_graph.eager_steps == before + 2
    # A CPU step is not captured: no miss, no capture, no replay.
    assert (step_graph.misses, step_graph.captures, step_graph.replays) == (0, 0, 0)
