"""Stages: the program's named spans, seen by ``torch.profiler`` on the host
and timed on the device, inside captured CUDA graphs too.

- :func:`stage`: a named scope. Where a ``torch.profiler`` run is active
  (or ``torch.autograd.profiler.emit_nvtx``, which makes it an NVTX
  range), it is a record function of the host; otherwise the host part is
  one flag check. The record is an operator's (``_RecordFunctionFast``),
  not a user annotation (``record_function``): the profiler draws a user
  annotation on the device's timeline too, over the kernels launched in
  it, so a span around a replay would read as one device operation as
  long as the replay. An operator's record stays on the host, and the
  kernels keep the caller's annotations. Where stage timing is on (:func:`stage_timing`) and a
  :class:`Collector` is installed (:func:`collecting`), it is also a span
  of that collector: a timed CUDA event recorded on the current stream at
  entry and at exit. The events are ``external``, so under stream capture
  each record is an event-record node of the graph, and every replay
  stamps the span again on the device with no host work. On a CPU device
  the collector takes ``time.perf_counter`` stamps instead.
- :func:`stage_timing`: turns stage timing on (or off) for a block. With
  it off, :func:`stage` records no event and a captured graph holds no
  extra node. The switch is part of every graph's key
  (``utils.step_graph.address_key``), so turning it on or off misses once
  and recaptures.
- :func:`trace`: profile a block with ``torch.profiler`` (CPU, and CUDA
  where there is a device) and write a Chrome trace into a directory.

``utils.step_graph.StepGraph`` installs a collector of its own for each
capture (the graph owns its spans) and for each eager step, and gives the
last run's spans (:meth:`Collector.read`).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_timing = False
_collector: Optional["Collector"] = None
#: A stage's record on the host under a profiler: an operator's scope.
_host_record = torch._C._profiler._RecordFunctionFast


def timing_on() -> bool:
    """Whether stage timing is on."""
    return _timing


@contextlib.contextmanager
def stage_timing(on: bool = True):
    """Stage timing on (or, with ``on`` false, off) inside the block."""
    global _timing
    before, _timing = _timing, on
    try:
        yield
    finally:
        _timing = before


class Span(NamedTuple):
    """One span of a run, in ms from the start of the run's first span.
    ``parent``: the index of the span it lies in (None at the top);
    ``stream``: the CUDA stream it was recorded on (None on a CPU)."""

    name: str
    parent: Optional[int]
    stream: Optional[int]
    start_ms: float
    end_ms: float


class Collector:
    """The spans of one run of a step: each stage's name, its parent (the
    stage open around it on the host when it began) and stream, and its
    start and end stamps, CUDA events on a CUDA ``device``, host clock
    readings otherwise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans = []  # [name, parent, stream, start, end]
        self._open = []

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def begin(self, name: str) -> int:
        parent = self._open[-1] if self._open else None
        stream = torch.cuda.current_stream().stream_id if self.cuda else None
        self._spans.append([name, parent, stream, self._stamp(), None])
        self._open.append(len(self._spans) - 1)
        return self._open[-1]

    def end(self, index: int) -> None:
        self._spans[index][4] = self._stamp()
        self._open.remove(index)

    def read(self) -> list:
        """The spans as :class:`Span` rows, in the order they began. On the
        card, after a synchronise on each end event, so a graph's spans are
        those of its last replay."""
        if not self._spans:
            return []
        origin = self._spans[0][3]
        if not self.cuda:
            return [Span(n, p, s, (a - origin) * 1e3, (b - origin) * 1e3)
                    for n, p, s, a, b in self._spans]
        for span in self._spans:
            span[4].synchronize()
        return [Span(n, p, s, origin.elapsed_time(a), origin.elapsed_time(b))
                for n, p, s, a, b in self._spans]


@contextlib.contextmanager
def collecting(collector: Optional[Collector]):
    """``collector`` installed for the block (None: no collector); the
    stages inside it are its spans."""
    global _collector
    before, _collector = _collector, collector
    try:
        yield collector
    finally:
        _collector = before


class stage:
    """``with stage(name):`` a named scope: a host record where a
    profiler is active, a span of the installed collector where stage
    timing put one in place. Composes with autograd; a stage in an
    autograd ``Function``'s backward is seen from the engine's thread too."""

    __slots__ = ("name", "_record", "_collector", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._record = None
        if _autograd_profiler._is_profiler_enabled:
            self._record = _host_record(self.name)
            self._record.__enter__()
        self._collector = _collector
        if self._collector is not None:
            self._span = self._collector.begin(self.name)
        return self

    def __exit__(self, *exc):
        if self._collector is not None:
            self._collector.end(self._span)
        if self._record is not None:
            self._record.__exit__(*exc)
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block with ``torch.profiler``; on leaving it, write a Chrome
    trace (``<host>_<pid>.<ms>.pt.trace.json``) into ``log_dir``. Yields the
    profiler, so a caller can also read ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
