"""The stage sub-window of a cell's ``--trace 1`` run: each stage's mean
device time over units run with stage timing on
(``gausplat_tpu_torch.utils.profiling.stage_timing``), the share of
``train.step`` that its named stages cover, and the graph's counters and
miss cost over the sub-window.

A driver calls :func:`stage_window` after its plain window and after
``peak_bytes`` is read, before it frees its program; it puts the result's
``means`` into its run record under ``stages``, where the readers under
``benchmark/metrics/`` find them (:func:`read`), and logs the result with
:func:`log_window`. The drivers do not call it yet.
"""

from __future__ import annotations

import time

from benchmark import harness


def counters(graph) -> dict:
    """A ``StepGraph``'s counters."""
    return dict(misses=graph.misses, eager_steps=graph.eager_steps, captures=graph.captures,
                replays=graph.replays)


def counted(graph, before: dict) -> dict:
    """``graph``'s counters since ``before``."""
    return {k: v - before[k] for k, v in counters(graph).items()}


def stage_means(units: list) -> dict:
    """Each stage's means over ``units`` (one list of ``profiling.Span``
    rows a unit, times from the unit's first span): ``n``, its spans a
    unit; ``ms``, a span's duration; ``start_ms`` and ``end_ms``, a span's
    start and end; ``total_ms``, ``n`` times ``ms``."""
    sums = {}
    for spans in units:
        for s in spans:
            acc = sums.setdefault(s.name, [0, 0.0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += s.end_ms - s.start_ms
            acc[2] += s.start_ms
            acc[3] += s.end_ms
    out = {}
    for name, (count, ms, start, end) in sums.items():
        out[name] = dict(n=count / len(units), ms=ms / count, start_ms=start / count,
                         end_ms=end / count, total_ms=ms / len(units))
    return out


def stage_window(unit, graph, seconds: float, sync) -> dict:
    """``unit()`` with stage timing on: two units first (turning the
    timing on misses ``graph``'s key: an eager unit, then the capture),
    then units for about ``seconds`` (at least three), ``sync()`` and
    ``graph.spans()`` read after each; a unit in which ``graph`` missed its
    key or captured is left out. Returns the kept units' :func:`stage_means`
    (empty where none was kept) and their count, ``graph``'s counters over
    the sub-window, and its ``miss_ms`` (host ms of the sub-window's
    warm-up and capture, where it captured)."""
    from gausplat_tpu_torch.utils.profiling import stage_timing

    before, kept = counters(graph), []
    with stage_timing():
        for _ in range(2):
            unit()
        start, calls = time.perf_counter(), 0
        while calls < 3 or time.perf_counter() - start < seconds:
            missed, captured = graph.misses, graph.captures
            unit()
            sync()
            calls += 1
            if (graph.misses, graph.captures) == (missed, captured):
                kept.append(graph.spans())
    return dict(means=stage_means(kept) if kept else {}, units=len(kept),
                counters=counted(graph, before), miss_ms=dict(graph.miss_ms))


def read(run: dict, name: str, field: str = "total_ms"):
    """Stage ``name``'s mean ``field`` from a run record's ``stages``, or
    None where the record has no such stage."""
    stage = (run.get("stages") or {}).get(name)
    return None if stage is None else stage[field]


def coverage(means: dict) -> float | None:
    """The share of ``train.step`` that its named child stages cover."""
    step = means.get("train.step")
    if not step:
        return None
    return sum(means[n]["total_ms"] for n in ("render.project", "render.bin",
                                              "render.rasterize", "train.loss",
                                              "train.backward", "train.adam")
               if n in means) / step["total_ms"]


def log_window(window: dict) -> None:
    """A :func:`stage_window` result on standard error: the units kept, the
    graph's counters and miss cost, each stage's means and, for a training
    step, the share of ``train.step`` its named stages cover."""
    harness.log(f"stage sub-window: {window['units']} units kept, counters",
                window["counters"], "miss_ms", window["miss_ms"])
    harness.log("stages (n a unit, ms a span, start and end from the unit's first span):")
    for name, m in window["means"].items():
        harness.log(f"  {name}: n {m['n']!r} ms {m['ms']!r} start {m['start_ms']!r} "
                    f"end {m['end_ms']!r}")
    share = coverage(window["means"])
    if share is not None:
        harness.log("named stages' share of train.step:", share)
