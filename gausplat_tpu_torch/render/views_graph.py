"""Serving as one CUDA graph replay a call.

The card's counterpart of the JAX package's one-dispatch renders:
``render/pipeline.py::_make_render_fn`` (``jax.jit`` of one view's render),
its jitted ``count_tile_entries``, ``_make_render_views_fn`` (``jax.jit``
of a ``vmap`` or a ``lax.map`` over the views) and, in
``parallel/render.py``, the jitted vmap of ``render_views``, the
``shard_map`` of ``render_data_parallel`` and that of
``render_tile_sharded``. Each is one dispatch a call there; here the same
no-grad render (``_render_core`` per view, the collectives where the entry
point has them; for ``count_tile_entries`` the projection and the sum of
its tile counts into a 0-d int64) is captured once through
:class:`~gausplat_tpu_torch.utils.step_graph.StepGraph` and each later
call is one host-to-device copy of its cameras into a static buffer, one
graph launch, and one copy of the static outputs into fresh tensors (so
that a returned tensor never aliases the graph's memory and the next call
leaves it as it was).

**Cameras.** A view's camera is packed on the host into one float32 row of
:data:`CAMERA_FLOATS` (focal length, half size, bound, position, the
row-major 3x3 rotation and the translation, with ``Camera.host_fields``'
arithmetic), and the ``[V, 21]`` rows go to the card in one copy; the
stacked :class:`Camera` the step reads is column views of that buffer
(:func:`stacked_camera`), bit for bit ``stack_cameras`` of
``Camera.from_view`` (six copies a view).

**The key.** :class:`ViewsGraph` keys its graph on what the caller says
shapes the render (sizes, options, capacity, mode, mesh) and on the
address, shape and dtype of the scene's five parameters, the camera
buffer, the static outputs, the ref and any per-rank constant, and holds
those tensors while the graph lives. A parameter updated in place is read
by the next replay; a scene from a setter or ``from_numpy`` holds new
tensors, so it misses: the old graph and its pool are dropped (their
memory goes back to the caching allocator), the call runs eagerly on a
side stream (the warm-up), and the next call captures.

**Memory.** One graph is kept per entry point and device
(:func:`views_graph`): a server that renders several scenes in turn keeps
one pool, and recaptures at each change of scene. The graph holds the
scene's tensors, not the scene; when the scene is collected, a finalizer
drops the graph, its pool, its buffers and the tensors it held. A graph
that captured NCCL collectives must be freed before its process group is
destroyed (:func:`release_all`).

**When it runs eagerly** (the documented modes; on the card nothing else
falls back to them, and an error in capture or replay raises): where grad
is enabled and a scene parameter (or a given ref) requires it, ``render``,
``render_views`` and the parallel entry points take their own pairs of
graphs, a forward and a backward (:mod:`.grad_graph`); where the current
stream is already capturing (the caller's own graph then records the
eager loop) every entry point runs eagerly; on a CPU device the step
below runs eagerly, its plain version (``render`` itself calls its eager
form there, as every entry point does under grad); a render whose
collectives go through gloo stays eager; the plain versions
(``backend="torch"``) stay eager for ``render`` and under grad, as they
read their loop bounds back to the host.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.projection import Camera
from ..utils.profiling import stage
from ..utils.step_graph import StepGraph

#: Each packed camera field: its name, first column and shape.
CAMERA_LAYOUT = (
    ("focal_length", 0, (2,)),
    ("image_size_half", 2, (2,)),
    ("view_bound", 4, (2,)),
    ("view_position", 6, (3,)),
    ("view_rotation", 9, (3, 3)),
    ("view_translation", 18, (3,)),
)
#: Floats of one packed camera row.
CAMERA_FLOATS = 21


def pack_cameras(views) -> np.ndarray:
    """The views' cameras as float32 rows ``[V, CAMERA_FLOATS]``."""
    rows = np.empty((len(views), CAMERA_FLOATS), np.float32)
    for i, view in enumerate(views):
        fields = Camera.host_fields(view)
        rows[i] = np.concatenate([fields[name].reshape(-1) for name, _, _ in CAMERA_LAYOUT])
    return rows


def rows_of(cameras: Camera) -> torch.Tensor:
    """A stacked :class:`Camera`'s fields as packed rows ``[V, 21]`` on its
    device (one concatenation, no host copy)."""
    v = cameras.focal_length.shape[0]
    return torch.cat([getattr(cameras, name).reshape(v, -1) for name, _, _ in CAMERA_LAYOUT], 1)


def stacked_camera(rows: torch.Tensor) -> Camera:
    """The :class:`Camera` whose fields, with a leading view axis, are
    column views of the packed ``rows`` ``[V, 21]``."""
    v = rows.shape[0]
    return Camera(**{name: rows[:, start:start + int(np.prod(shape))].view(v, *shape)
                     for name, start, shape in CAMERA_LAYOUT})


def camera_at(cameras: Camera, i: int, pos2d_shift: Optional[torch.Tensor] = None) -> Camera:
    """View ``i`` of a stacked :class:`Camera` (views of its fields), with
    ``pos2d_shift``."""
    fields = {f.name: getattr(cameras, f.name)[i] for f in dataclasses.fields(Camera)
              if f.name != "pos2d_shift"}
    return Camera(**fields, pos2d_shift=pos2d_shift)


def needs_grad(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether grad is enabled and one of ``tensors`` requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def capturing(device: torch.device) -> bool:
    """Whether the current stream of ``device`` is capturing a graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def runs_eagerly(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a serving call on ``tensors`` (the scene's parameters and any
    ref) takes its eager loop: grad is needed, or the current stream is
    already capturing."""
    return needs_grad(tensors) or capturing(tensors[0].device)


def release_with(scene, finalizer: Optional[weakref.finalize],
                 release: Callable[[], None]) -> weakref.finalize:
    """A finalizer that calls ``release`` when ``scene`` is collected:
    ``finalizer`` where it already watches ``scene``, else a new one (and
    ``finalizer`` detached)."""
    if finalizer is not None and finalizer.peek() is not None \
            and finalizer.peek()[0] is scene:
        return finalizer
    if finalizer is not None:
        finalizer.detach()
    return weakref.finalize(scene, release)


class EntryGraphs:
    """What an entry point's graphs on one device keep beside them, serving
    (:class:`ViewsGraph`) or under grad (``grad_graph.GradGraph``): the
    per-rank constants the renders read (a slab's screen shift), made once
    and held while the scene lives, and the release when the scene is
    collected."""

    def __init__(self, device: torch.device):
        self.device = device
        self.constants = {}
        self._finalizer = None

    def release(self) -> None:
        """Drop the constants and stop watching the scene."""
        self.constants = {}
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None

    def constant(self, key, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The per-rank constant ``key``, made by ``make()`` on first use."""
        if key not in self.constants:
            self.constants[key] = make()
        return self.constants[key]

    def watch(self, scene) -> None:
        """Release these graphs when ``scene``, the one a call renders, is
        collected."""
        self._finalizer = release_with(scene, self._finalizer, self.release)


#: The graphs of each kind, entry point and device.
_ENTRIES: dict = {}


def entry_graphs(kind: type, name: str, device: torch.device) -> EntryGraphs:
    """The ``kind`` graphs of entry point ``name`` on ``device``, made on
    first use."""
    key = (kind, name, str(device))
    if key not in _ENTRIES:
        _ENTRIES[key] = kind(device)
    return _ENTRIES[key]


def release_all() -> None:
    """Release every entry point's graphs, of both kinds, on every device,
    and collect what they left. Call it before destroying a process group
    whose NCCL collectives a graph captured: NCCL's communicator, when
    destroyed, waits for every graph that holds its collectives to be
    freed."""
    for graphs in _ENTRIES.values():
        graphs.release()
    gc.collect()


def output_specs(views: Optional[int], width: int, height: int, points: int) -> tuple:
    """The ``(shape, dtype)`` of each :class:`RenderOutput` field, with a
    leading axis of ``views`` (none where ``views`` is None)."""
    lead = () if views is None else (views,)
    return ((lead + (height, width, 3), torch.float32), (lead + (points,), torch.int32),
            (lead, torch.int32), (lead + (height, width), torch.float32),
            (lead + (height, width), torch.int32))


class ViewsGraph(EntryGraphs):
    """One entry point's captured batched render on one device, with its
    static inputs and outputs. ``graph`` is its
    :class:`~gausplat_tpu_torch.utils.step_graph.StepGraph` (``captures``,
    ``replays`` and its other counts, kept over releases; ``spans()``: the
    stages of the last call, ``serve.request`` around each view's
    ``render.project``, ``render.bin`` and ``render.rasterize`` on the
    view's stream)."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.graph = StepGraph()
        self.rows = None  # [V, 21] f32: the packed cameras
        self.outputs = ()  # the static outputs, one per RenderOutput field
        self.ref = None  # [P] f32 zeros: the render's densification ref
        self._streams = []

    def release(self) -> None:
        """Drop the graph, its pool, the static buffers and the held tensors;
        the graph's counts go on."""
        super().release()
        self.graph.invalidate()
        self.rows, self.outputs, self.ref = None, (), None

    def each_view(self, count: int, fn: Callable[[int], None], concurrent: bool) -> None:
        """``fn(i)`` for each view ``i``: one after another on the current
        stream, or (``concurrent``, on the card) each on its own side stream
        forked from and joined back to the current one, so every view's
        buffers are live at once and the views' kernels may overlap."""
        if not concurrent or self.device.type != "cuda":
            for i in range(count):
                fn(i)
            return
        current = torch.cuda.current_stream(self.device)
        while len(self._streams) < count:  # made once, kept
            self._streams.append(torch.cuda.Stream(self.device))
        streams = self._streams[:count]
        for i, stream in enumerate(streams):
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                fn(i)
        for stream in streams:
            current.wait_stream(stream)

    def _static(self, rows, specs, points: int) -> None:
        """Static buffers of the call's shapes: kept where they match, else
        made anew (which misses the key)."""
        device = self.device
        if self.rows is None or tuple(self.rows.shape) != tuple(rows.shape):
            self.rows = torch.empty(tuple(rows.shape), dtype=torch.float32, device=device)
        if [(tuple(t.shape), t.dtype) for t in self.outputs] != [(s, d) for s, d in specs]:
            self.outputs = tuple(torch.empty(s, dtype=d, device=device) for s, d in specs)
        if self.ref is None or self.ref.shape[0] != points:
            self.ref = torch.zeros((points,), dtype=torch.float32, device=device)

    def run(self, scene, params: Sequence[torch.Tensor], rows, specs, static_key,
            body: Callable[[Camera, tuple, torch.Tensor], None],
            constants: Sequence[torch.Tensor] = (),
            any_miss: Optional[Callable[[bool], bool]] = None) -> tuple:
        """One call: ``rows`` (packed cameras, a numpy array or a tensor on
        the device) copied into the static camera buffer, then
        ``body(cameras, outputs, ref)`` replayed (captured or run eagerly as
        :class:`StepGraph` decides), which reads ``params``, the stacked
        ``cameras``, ``ref`` and ``constants`` and writes every one of the
        static ``outputs`` (``specs``: their shapes and dtypes). Returns
        fresh copies of the outputs."""
        self.watch(scene)
        self._static(rows, specs, params[0].shape[0])
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(rows)
        with stage("views_graph.copy_in"):
            self.rows.copy_(rows, non_blocking=True)
        cameras, outputs, ref = stacked_camera(self.rows), self.outputs, self.ref
        tensors = [*params, self.rows, *outputs, ref, *constants]

        def request():
            with stage("serve.request"):
                body(cameras, outputs, ref)

        self.graph.run(request, static_key, tensors, 1, any_miss=any_miss)
        with stage("views_graph.copy_out"):
            return tuple(t.clone() for t in outputs)


def views_graph(name: str, device: torch.device) -> ViewsGraph:
    """The :class:`ViewsGraph` of entry point ``name`` on ``device``."""
    return entry_graphs(ViewsGraph, name, device)
