"""Tracing / profiling helpers.

Counterpart of ``gausplat_tpu/utils/profiling.py``, in PyTorch's idiom:

- :func:`stage`: a named scope, a ``torch.profiler.record_function`` (seen
  by :func:`trace` and any ``torch.profiler`` run) plus an NVTX range where
  the process has a CUDA device (seen by Nsight);
- :func:`trace`: profile a block with ``torch.profiler`` (CPU, and CUDA
  where there is a device) and write a Chrome trace into a directory
  (open it in Perfetto, ``chrome://tracing`` or TensorBoard);
- :data:`logger` hierarchy matching the reference's log targets
  (``gausplat::renderer::gaussian_3d::{scene,forward,backward}``);
- :func:`log_stage`: debug logging gated on the ``GAUSPLAT_DEBUG`` env var;
- :func:`wall_timer`: a host wall-clock timer.

Nothing in the render or the trainer calls these: a caller wraps what it
wants to see.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("gausplat.renderer.gaussian_3d")
logger_scene = logger.getChild("scene")
logger_forward = logger.getChild("forward")
logger_backward = logger.getChild("backward")

_DEBUG = bool(os.environ.get("GAUSPLAT_DEBUG"))


@contextlib.contextmanager
def stage(name: str):
    """Named scope for a pipeline stage (in profiler traces and, on a CUDA
    device, as an NVTX range). A CPU build of torch has no NVTX, so the
    range is pushed only where CUDA is available."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def log_stage(which: logging.Logger, message: str) -> None:
    if _DEBUG:
        which.debug(message)


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


@contextlib.contextmanager
def wall_timer(label: str, results: dict | None = None):
    """Host wall-clock timer (CUDA work is asynchronous: synchronise first)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    log_stage(logger, f"{label}: {dt * 1000:.2f} ms")
