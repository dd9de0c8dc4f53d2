"""A step captured as a CUDA graph and replayed: a training step, or a
batched render.

The card's counterpart of the JAX package's compiled dispatches. For
``make_step_scan`` a chunk of steps is one ``lax.scan`` dispatch; here the
training step is captured once with ``torch.cuda.graph`` (the autograd
backward, kernels A, B and C and the Adam update inside it) and each step
of a chunk is one replay, one launch from the host where an eager step
issues some 1,500. The serving entry points' ``jax.jit`` of a batched
render becomes one replay a call the same way
(:mod:`gausplat_tpu_torch.render.views_graph`).

A graph replays the addresses it was captured with. :class:`StepGraph`
keys a graph on the step's static shapes and options and on the address,
shape and type of every tensor the step reads or writes (the scene, the
optimizer state, the densify accumulators, the watermark, the stacked
cameras and targets, the counters and the metrics buffers), and holds
those tensors while the graph lives, so that no other tensor can take
their addresses. A host event that replaces one of them (a densify, an
opacity reset, a fresh optimizer state) misses the key: the old graph and
its memory pool are freed, the next step runs eagerly on a side stream (a
real step of the schedule, which also warms up cuDNN, cuBLAS and the
kernels' first use), and the step is captured for the replays that follow.

On a CPU scene the same step runs eagerly, step by step: that is the
graph's plain version. On the card nothing here falls back to it: an
error in capture or replay raises. A caller whose step cannot be captured
on the card (a sharded step whose collectives go through gloo, which
copies through the host) asks for the eager steps itself.

Where several processes each capture a step that holds collectives (one
rank per card over NCCL), every rank must capture and replay the same
collectives in the same order: a rank that recaptures while another
replays waits for it forever. The key's addresses are each process's own,
so such a caller passes ``any_miss``, which makes the miss the ranks'
common decision.

**Stages.** With stage timing on (``utils.profiling.stage_timing``), a
capture installs a collector of its own, so the graph holds an event-record
node at each end of each stage of the step and every replay stamps them
anew; an eager step (the warm-up, a CPU step) has a collector of its own.
:meth:`StepGraph.spans` reads the last run's spans. The switch is part of
the key: turning it on or off misses once.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from .kernels import captured_launches, count_replay
from .profiling import Collector, collecting, stage, timing_on


def address_key(static_key, tensors: Sequence[torch.Tensor]) -> tuple:
    """A graph's key: ``static_key``, whether stage timing is on (a graph
    captured with it holds the stages' event records), and the address,
    shape and type of each of ``tensors``, which a replay reads and
    writes."""
    return (static_key, timing_on(),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors))


def decide_miss(key, held, any_miss: Optional[Callable[[bool], bool]] = None) -> bool:
    """Whether ``key`` misses the ``held`` one: this process's answer, or,
    with ``any_miss``, that of every process that captures together (true
    where any of them missed)."""
    missed = key != held
    return missed if any_miss is None else any_miss(missed)


class StepGraph:
    """A step function captured as one CUDA graph, replayed while its key
    holds. Over its life: ``misses`` counts the misses of the key,
    ``eager_steps`` the steps run eagerly (each miss's warm-up, every step
    on a CPU device or without capture), ``captures`` the captures,
    ``replays`` the replays, ``by_replay`` each kernel's launches made by
    replays; ``miss_ms`` holds the host ms of the last warm-up and
    capture."""

    def __init__(self):
        self.key = None
        self.graph = None
        self.launches = {}
        self._held = ()
        self.misses = 0
        self.eager_steps = 0
        self.captures = 0
        self.replays = 0
        self.by_replay = {}
        self.miss_ms = {}
        self._captured = None  # the capture's collector, where stage timing was on
        self._last = None  # the collector of the last step run

    def invalidate(self) -> None:
        """Free the graph, its memory pool and the tensors it held (the
        graph before the events its nodes record)."""
        self.key, self.graph, self.launches, self._held = None, None, {}, ()
        self._captured = self._last = None

    def spans(self) -> list:
        """The stage spans (``profiling.Span``) of the last step run,
        replayed or eager; empty where stage timing was off for it."""
        return [] if self._last is None else self._last.read()

    def run(self, step: Callable[[], None], static_key, tensors: Sequence[torch.Tensor],
            steps: int, capture: bool = True,
            any_miss: Optional[Callable[[bool], bool]] = None) -> None:
        """Run ``step`` ``steps`` times. ``step`` reads and writes only
        ``tensors`` (and what it allocates itself), and ``static_key`` holds
        everything else that shapes it. On a CPU device, or with
        ``capture`` false, each step runs eagerly; on a CUDA device the
        graph of ``step`` is replayed, after a miss of the key an eager step
        on a side stream and a capture. ``any_miss(missed)``, where given,
        turns this process's miss into the decision of all the processes
        that capture together (true where any of them missed)."""
        if steps <= 0:
            return
        device = tensors[0].device
        if device.type != "cuda" or not capture:
            for _ in range(steps):
                self._eager(step, device)
            return
        key = address_key(static_key, tensors)
        if decide_miss(key, self.key, any_miss):
            self.misses += 1
            self.invalidate()
            start = time.perf_counter()
            with stage("step_graph.warm_up"):
                self._eager(lambda: self.warm_up(step, device), device)
            self.miss_ms = {"warm_up_ms": (time.perf_counter() - start) * 1e3}
            self.key, self._held = key, tuple(tensors)
            steps -= 1
        if steps and self.graph is None:
            start = time.perf_counter()
            self.capture(step, device)
            self.miss_ms["capture_ms"] = (time.perf_counter() - start) * 1e3
        for _ in range(steps):
            self.replay()

    def _eager(self, step: Callable[[], None], device) -> None:
        """``step`` run eagerly, with a collector of its own where stage
        timing is on."""
        self._last = Collector(device) if timing_on() else None
        with collecting(self._last):
            step()
        self.eager_steps += 1

    def replay(self) -> None:
        """One replay of the captured step, with its kernels' launches
        counted."""
        with stage("step_graph.replay"):
            self.graph.replay()
        self._last = self._captured
        count_replay(self.launches)
        self.replays += 1
        for kernel, n in self.launches.items():
            self.by_replay[kernel] = self.by_replay.get(kernel, 0) + n

    @staticmethod
    def warm_up(step, device) -> None:
        """``step`` run eagerly on a side stream, joined back to the current
        one: before a capture, it makes the lazy first uses (libraries,
        handles, workspaces) that a capture may not record."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, step, device, pool=None) -> None:
        """Capture ``step`` as this graph, its kernels' launches recorded
        for :meth:`replay`. ``pool``: a memory pool
        (``torch.cuda.graph_pool_handle()``) shared with other graphs that
        replay in turn with this one, as a forward and its backward do."""
        graph = torch.cuda.CUDAGraph()
        collector = Collector(device) if timing_on() else None
        with stage("step_graph.capture"), torch.cuda.device(device):
            with captured_launches() as launches, torch.cuda.graph(graph, pool=pool), \
                    collecting(collector):
                step()
        self.graph, self.launches, self._captured = graph, launches, collector
        self.captures += 1
