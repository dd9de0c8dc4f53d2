"""The differentiable renders as one forward and one backward graph replay.

The card's counterpart of the JAX package's compiled renders under
``jax.grad``: ``render`` (``jax.jit`` of a ``jax.custom_vjp``,
``render/pipeline.py::_render_fwd`` and ``_render_bwd``), ``render_views``
(``jax.jit`` of a ``vmap`` or a ``lax.map`` of it) and, in
``parallel/render.py``, the jitted vmap of ``render_views`` and the
``shard_map``s of ``render_data_parallel`` and ``render_tile_sharded``,
whose transposes sum the replicated parameters' cotangents over the mesh.
Each runs its forward as one compiled dispatch and its backward as
another. Here the same renders (``_render_core`` for each view or slab,
with autograd recording, on detached aliases of the scene's parameters,
and the collectives and their autograd pieces where the entry point has
them) are captured once as a forward CUDA graph, and
``torch.autograd.grad`` of the image against those aliases and a static
ref as a backward CUDA graph, both in one memory pool (as
``torch.cuda.make_graphed_callables`` does). A call is then
:class:`GraphRenderFunction`: its forward copies the cameras in (packed
``[V, 21]`` rows, or the fields of a stacked ``Camera`` the caller holds
on the device: copies only, no kernel), replays the forward graph and
clones the five outputs out; its backward copies the image's cotangent
in, replays the backward graph and clones the gradients out. Outputs and
gradients are bit for bit those of the eager forms and their autograd
backward.

**Streams.** Every view is rendered one after another on the capture
stream, whichever ``mode`` ``render_views`` is given. Autograd runs each
backward op on the stream of its forward op; a forward that forked views
onto side streams would leave backward work on streams that are not
capturing, unrecorded or an error. Under grad every view's saved state is
live until the backward either way, so ``"map"`` would save no memory.

**The key** (:meth:`GradGraph.run`): the sizes, options, capacity and mesh
the caller gives, the view count and the cameras' form, which of
the five parameters and the ref need a gradient, and the address, shape
and dtype of the five parameters and of any per-rank constant, which the
graphs hold while they live. The aliases share the parameters' storage,
so a parameter updated in place is read by the next replay. The caller's
ref is not keyed: its value enters no output, and a trainer makes a fresh
one each step; it may be absent (``render_views`` takes none, as JAX's
makes its refs inside), and where given has the point count's length. A
miss (a new scene, a setter, another size or view count, another set of
inputs needing grad) drops the pair; the call runs eagerly, forward and
backward (the warm-up), and the next call captures (an eager forward and
backward of the static inputs on a side stream first, then both
captures), then replays. ``miss_ms`` keeps the host ms of the last
warm-up and capture calls. Where the renders hold collectives (one rank
per card over NCCL), the caller passes ``any_miss``, which makes the miss
the ranks' common decision, so every rank warms up, captures and replays
the same collectives in the same order.

**Saved state.** The backward graph reads what the forward graph wrote:
the tensors autograd saved during the forward capture (collected with
``torch.autograd.graph.saved_tensors_hooks``; those that are views of the
parameters or of a constant excepted) and the cameras. A second
forward overwrites them while an earlier call's backward may still be to
come: two calls before one backward, backwards in the reverse order, a
forward whose output is kept. So the pair records which call owns the
static state; before a forward replay overwrites it while that call is
still pending (its autograd node alive and its saved tensors not
released), the state is copied into the call's own tensors, and before
that call's backward replay it is copied back. One call and then its
backward copies nothing. Recomputing the projection in the backward, as
``_render_bwd`` does, would add the projection's device time to every
backward instead. These decisions follow the autograd nodes' lives, which
are the same on every rank of an SPMD program, and the copies hold no
collective, so the ranks need not agree on them.

As in the eager render, an in-place change to a parameter between a
forward and its backward raises (:class:`GraphRenderFunction` saves the
five parameters), and the transmittances, radii, counts and entry total
carry no gradient. Double backward is not supported, as the reference's
``custom_vjp`` has none.

**On a CPU device** the same code runs, every replay run eagerly: the
forward body is run again and what it saved and returned is copied into
the static tensors, and the backward is ``torch.autograd.grad`` of the
static image, so the ownership and its copies (and, over gloo, the
collectives) run as on the card. The entry points themselves stay eager
there.

**Memory.** One pair is kept per entry point and device
(:func:`grad_graph`); it holds the scene's tensors, not the scene, and is
released when the scene is collected. A pair left behind by a miss lives
on while a pending call needs it. A pair that captured NCCL collectives
must be freed before its process group is destroyed
(``views_graph.release_all``): NCCL's communicator, when destroyed, waits
for the graphs that hold its collectives. The saved state grows with the views:
617 MB for one view of 1M points at 1920x1080, 3.08 GB for
``render_views`` of five, in pools of 1.94 and 4.98 GB (``chip_smoke.py``'s
render_grad phase on an NVIDIA H100).
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.projection import Camera
from ..utils.step_graph import StepGraph, address_key, decide_miss
from .views_graph import CAMERA_LAYOUT, EntryGraphs, entry_graphs, stacked_camera


def _storage_bytes(t: torch.Tensor) -> torch.Tensor:
    """The whole storage under ``t`` as a uint8 tensor (with a version
    counter of its own, so autograd sees no in-place change)."""
    storage = t.untyped_storage()
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        storage, 0, (storage.nbytes(),), (1,))


class _Call:
    """One call through a pair: its autograd node (weakly) and, while
    another call owns the pair's static state, its own copy of its state."""

    def __init__(self, pair: "_Pair"):
        self.pair = pair
        self.node = None  # weakref of the call's autograd node
        self.own = None  # its saved state while another call owns the static one

    def pending(self) -> bool:
        """Whether the call's backward may still come: its node is alive and
        its saved tensors were not released (nor changed in place)."""
        node = None if self.node is None else self.node()
        if node is None:
            return False
        try:
            node.saved_tensors
        except RuntimeError:
            return False
        return True


def _camera_fields(cameras: Camera) -> tuple:
    """A stacked :class:`Camera`'s fields in the packed rows' order."""
    return tuple(getattr(cameras, name) for name, _, _ in CAMERA_LAYOUT)


class _Pair:
    """One captured forward and backward graph in one pool, with their
    static tensors: the cameras (``inputs``), the aliases of the
    parameters, the static ref, the outputs, the image's cotangent, the
    gradients and the saved state, and the call that owns that state.
    ``constants``: the per-rank constants the body reads, never part of the
    saved state."""

    def __init__(self, stats: "GradGraph", params: Sequence[torch.Tensor], needs: tuple,
                 cameras, body: Callable, constants: Sequence[torch.Tensor] = ()):
        device = params[0].device
        self.stats, self.device, self.body = stats, device, body
        self.constants = tuple(constants)
        if isinstance(cameras, Camera):
            # A stacked Camera on the device: a static copy of each field, each
            # call's copied in field by field (a copy each, no kernel).
            self.inputs = tuple(torch.zeros_like(f) for f in _camera_fields(cameras))
            self.cameras = Camera(**{name: t for (name, _, _), t in zip(CAMERA_LAYOUT,
                                                                        self.inputs)})
        else:  # packed rows [V, 21], one copy a call
            self.inputs = (torch.zeros(tuple(cameras.shape), dtype=torch.float32,
                                       device=device),)
            self.cameras = stacked_camera(self.inputs[0])
        self.ref = torch.zeros((params[0].shape[0],), dtype=torch.float32,
                               device=device).requires_grad_(needs[-1])
        self.aliases = tuple(p.detach().requires_grad_(n) for p, n in zip(params, needs))
        self.wrt = tuple(t for t, n in zip(self.aliases + (self.ref,), needs) if n)
        self.needs = needs
        self.forward, self.backward = StepGraph(), StepGraph()
        self._owner = None  # weakref of the call that owns the static state
        self.image = self.outputs = self.cot = self.grads = None
        self.saved, self.state, self._copies = (), (), ()

    @property
    def owner(self) -> Optional[_Call]:
        """The call whose forward wrote the static state. Held weakly: a
        call holds its pair, and a cycle would keep a released pair's graphs
        and pool alive until a collection, at a time that differs from rank
        to rank."""
        return None if self._owner is None else self._owner()

    @owner.setter
    def owner(self, call: Optional[_Call]) -> None:
        self._owner = None if call is None else weakref.ref(call)

    def _run_forward(self, saved: list):
        """The render on the static inputs, with autograd recording; every
        tensor it saves for the backward is appended to ``saved``."""
        def pack(t):
            t = t.detach()
            saved.append(t)
            return t

        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return self.body(self.aliases, self.ref, self.cameras)

    def _grads(self):
        with torch.enable_grad():
            return torch.autograd.grad(self.image, self.wrt, self.cot, retain_graph=True)

    def _copy_in(self, cameras) -> None:
        """A call's cameras into the static ones."""
        if isinstance(cameras, Camera):
            for dst, src in zip(self.inputs, _camera_fields(cameras)):
                dst.copy_(src, non_blocking=True)
        else:
            if isinstance(cameras, np.ndarray):
                cameras = torch.from_numpy(cameras)
            self.inputs[0].copy_(cameras, non_blocking=True)

    def capture(self, cameras) -> None:
        """Make the static tensors and, on the card, capture both graphs
        (after an eager forward and backward on a side stream)."""
        saved = []

        def forward():
            out = self._run_forward(saved)
            self.image, self.outputs = out[0], tuple(t.detach() for t in out)

        def backward():
            self.grads = self._grads()

        self._copy_in(cameras)
        if self.device.type == "cuda":
            def warm_up():
                image = self._run_forward([])[0]
                with torch.enable_grad():
                    torch.autograd.grad(image, self.wrt, torch.zeros_like(image))

            StepGraph.warm_up(warm_up, self.device)
            pool = torch.cuda.graph_pool_handle()
            self.forward.capture(forward, self.device, pool)
            self.cot = torch.zeros_like(self.outputs[0])
            self.backward.capture(backward, self.device, pool)
        else:
            forward()
            self.cot = torch.zeros_like(self.outputs[0])
            backward()
        self.saved = tuple(saved)
        # The state a forward writes and the backward reads: each storage of
        # the saved tensors and the outputs once (by index), the parameters'
        # and the constants excepted, then the cameras.
        skip = {t.untyped_storage().data_ptr()
                for t in self.aliases + (self.ref,) + self.inputs + self.constants}
        copies = []
        for i, t in enumerate(self.saved + self.outputs):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in skip:
                skip.add(ptr)
                copies.append((i, _storage_bytes(t)))
        self._copies = tuple(copies)
        self.state = tuple(b for i, b in copies if i < len(self.saved)) + tuple(
            _storage_bytes(t) for t in self.inputs)

    def replay_forward(self) -> None:
        if self.device.type == "cuda":
            self.forward.replay()
        else:
            saved = []
            out = self._run_forward(saved)
            new = saved + [t.detach() for t in out]
            if len(saved) != len(self.saved):
                raise RuntimeError(f"the render saved {len(saved)} tensors, its capture "
                                   f"{len(self.saved)}")
            for i, dst in self._copies:
                dst.copy_(_storage_bytes(new[i]))
        self.stats.note("forward", self.forward)

    def replay_backward(self) -> None:
        if self.device.type == "cuda":
            self.backward.replay()
        else:
            for dst, g in zip(self.grads, self._grads()):
                dst.copy_(g)
        self.stats.note("backward", self.backward)

    def take(self, call: _Call, cameras) -> None:
        """Give the static state to ``call``'s forward: the current owner's
        state moved out first where its backward may still come."""
        if self.owner is not None and self.owner is not call and self.owner.pending():
            self._move_out(self.owner)
        self.owner = call
        self._copy_in(cameras)
        self.replay_forward()

    def restore(self, call: _Call) -> None:
        """Give the static state back to ``call`` before its backward."""
        if self.owner is call:
            return
        if call.own is None:
            raise RuntimeError("the graphed render lost a pending call's saved state")
        if self.owner is not None and self.owner.pending():
            self._move_out(self.owner)
        for dst, src in zip(self.state, call.own):
            dst.copy_(src)
        call.own, self.owner = None, call

    def _move_out(self, call: _Call) -> None:
        call.own = tuple(b.clone() for b in self.state)
        self.stats.moves += 1


class GraphRenderFunction(torch.autograd.Function):
    """One differentiable call through a captured pair.

    ``apply(pair, cameras, *params, ref)``: ``pair`` a captured
    :class:`_Pair`, ``cameras`` the packed camera rows ``[V, 21]`` (on the
    host or the device) or a stacked :class:`Camera` on the device,
    ``params`` the five parameters, ``ref`` the densification ref (None
    where it needs no gradient). Returns the five :class:`RenderOutput`
    fields; only the image carries a gradient."""

    @staticmethod
    def forward(ctx, pair, cameras, *inputs):
        call = _Call(pair)
        pair.take(call, cameras)
        ctx.call = call
        call.node = weakref.ref(ctx)
        ctx.save_for_backward(*inputs[:5])
        ctx.set_materialize_grads(False)  # no zeros made for the other outputs
        outs = tuple(t.clone() for t in pair.outputs)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_image, *_):
        ctx.saved_tensors  # raises where a parameter changed in place since the forward
        pair = ctx.call.pair
        pair.restore(ctx.call)
        if grad_image is None:
            pair.cot.zero_()
        else:
            pair.cot.copy_(grad_image)
        pair.replay_backward()
        grads = iter(g.clone() for g in pair.grads)
        return (None, None, *(next(grads) if n else None for n in pair.needs))


class GradGraph(EntryGraphs):
    """One entry point's captured pair on one device, with the counts over
    its pairs since it was made or released: ``captures``, ``replays`` (of
    each graph), ``by_replay`` (each kernel's launches by replay), ``moves``
    (a call's state moved out) and ``miss_ms``."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.release()

    def release(self) -> None:
        """Drop the pair and the held tensors (the counts start again). A
        call still pending keeps its own pair until its backward."""
        super().release()
        self.key, self.pair, self._held = None, None, ()
        self.captures, self.moves = 0, 0
        self.replays = {"forward": 0, "backward": 0}
        self.by_replay = {}
        self.miss_ms = {}

    def note(self, which: str, graph: StepGraph) -> None:
        """Count one replay of ``which`` graph of a pair."""
        self.replays[which] += 1
        for kernel, n in graph.launches.items():
            self.by_replay[kernel] = self.by_replay.get(kernel, 0) + n

    def run(self, scene, params: Sequence[torch.Tensor], ref: Optional[torch.Tensor], cameras,
            static_key, body: Callable, warm_up: Callable,
            constants: Sequence[torch.Tensor] = (),
            any_miss: Optional[Callable[[bool], bool]] = None) -> tuple:
        """One differentiable call. ``cameras``: the packed camera rows
        ``[V, 21]`` (numpy, or on the device), or a stacked :class:`Camera`
        on the device (copied in field by field, so a call launches no
        kernel to pack it). ``body(params, ref, cameras)`` renders from the
        static stacked ``cameras`` and returns the five outputs (each with a
        leading view axis where the entry point stacks views); it reads
        ``constants`` too;
        ``static_key`` holds everything else that shapes it; ``warm_up()``
        is the eager form, run on a miss. ``any_miss(missed)``, where given,
        turns this process's miss into the decision of all the processes
        whose renders hold collectives together (true where any missed).
        Returns the five outputs."""
        needs = tuple(p.requires_grad for p in params) + (
            ref is not None and ref.requires_grad,)
        stacked = isinstance(cameras, Camera)
        views = cameras.focal_length.shape[0] if stacked else cameras.shape[0]
        key = address_key((static_key, stacked, views, needs), (*params, *constants))
        self.watch(scene)
        start = time.perf_counter()
        if decide_miss(key, self.key, any_miss):
            self.key, self.pair, self._held = key, None, (*params, *constants)
            out = warm_up()
            self.miss_ms = {"warm_up_ms": (time.perf_counter() - start) * 1e3}
            return tuple(out)
        captured = self.pair is None
        if captured:
            self.pair = _Pair(self, params, needs, cameras, body, constants)
            self.pair.capture(cameras)
            self.captures += 1
        out = GraphRenderFunction.apply(self.pair, cameras, *params, ref if needs[-1] else None)
        if captured:
            self.miss_ms["capture_ms"] = (time.perf_counter() - start) * 1e3
        return out


def grad_graph(name: str, device: torch.device) -> GradGraph:
    """The :class:`GradGraph` of entry point ``name`` on ``device``
    (``"render"``, ``"render_views"``, ``"parallel.render_views"``,
    ``"parallel.render_data_parallel"``, ``"parallel.render_tile_sharded"``)."""
    return entry_graphs(GradGraph, name, device)
