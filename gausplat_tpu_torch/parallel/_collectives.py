"""Collectives over one mesh axis, and the differentiable pieces built on
them: what ``shard_map``'s transpose does in the JAX package.

- a replicated input: :func:`replicate`, the identity forward and the
  gradient summed over the axis backward;
- an output sharded along an axis: :func:`gather`, an all-gather forward
  and this rank's slice of the gradient backward;
- ``ppermute`` of boundary rows: :func:`halo_extend`, the neighbours' rows
  forward (zeros at the frame's borders) and each row's gradient back to
  its owner backward;
- ``psum`` / ``pmax``: :func:`all_reduce` (no gradient).

The backend is the caller's choice, made when the process group was
initialised: NCCL for CUDA tensors, one card per rank, gloo for CPU
tensors. Several ranks on one card cannot use NCCL (it refuses two ranks
on one GPU), so they use gloo. Everything here is an all-reduce or an
all-gather, which gloo takes on CUDA tensors as well (it stages them
through host memory itself); its point-to-point ``send`` / ``recv`` of a
CUDA tensor aborts the process, which is why the halo exchange is an
all-gather of the slabs' edge rows. The kernels run on the card in every
rank either way. A collective that fails raises.

Only NCCL's collectives can be captured in a CUDA graph: the process
group runs each on its own stream, after the work queued on the caller's
current stream and before what the caller queues next there (the capture
stream in the forward; in the backward, autograd's thread runs on the
stream of the matching forward op), so under capture the collective
joins the graph and a replay runs it. gloo's copy through the host cannot be
captured, so a step over gloo runs eagerly. A group's NCCL communicator is
made at its first collective, which must run eagerly, before any capture.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

MAX = dist.ReduceOp.MAX


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the group's ranks, as a new tensor,
    with no gradient."""
    buf = x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of the group, concatenated along ``dim`` in rank
    order (every rank gives the same shape), with no gradient."""
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` holds on any rank of the group (a max over it, read
    back on the host): how ranks that capture together decide a miss of
    their graphs' keys as one."""
    flags = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(flags, op=MAX, group=group)
    return bool(flags.item())


def all_reduce_each(tensors, group) -> list:
    """Each of ``tensors`` (one dtype) summed over the group's ranks, in one
    all-reduce of them flattened together."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view_as(t) for p, t in zip(parts, tensors)]


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_each(grads, ctx.group))


def replicate(tensors, group) -> tuple:
    """The same tensors, whose gradients are summed over the group's ranks
    in the backward: a replicated input whose every rank's use counts."""
    return _Replicate.apply(group, *tensors)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        # Every rank holds the same loss of the gathered whole, so each keeps
        # only the gradient of its own slice (a sum would count it D times).
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather`, differentiable: the backward keeps this rank's
    slice of the gradient."""
    return _Gather.apply(x, group, dim)


class _HaloExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows):
        index, size = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.rows, ctx.index, ctx.size = group, rows, index, size
        edges = all_gather(torch.cat([x[:, :rows], x[:, -rows:]], 1)[None], group)
        zeros = torch.zeros_like(x[:, :rows])
        above = edges[index - 1][:, rows:] if index > 0 else zeros
        below = edges[index + 1][:, :rows] if index < size - 1 else zeros
        return torch.cat([above, x, below], 1)

    @staticmethod
    def backward(ctx, grad):
        rows, index, size = ctx.rows, ctx.index, ctx.size
        # The first rows' gradient belongs to the rank above, the last rows'
        # to the rank below; each rank takes what its neighbours send back.
        edges = all_gather(torch.cat([grad[:, :rows], grad[:, -rows:]], 1)[None], ctx.group)
        out = grad[:, rows:-rows].clone()
        if index > 0:
            out[:, :rows] += edges[index - 1][:, rows:]
        if index < size - 1:
            out[:, -rows:] += edges[index + 1][:, :rows]
        return out, None, None


def halo_extend(x: torch.Tensor, group, rows: int) -> torch.Tensor:
    """``x`` [V, h, ...] (this rank's slab of rows, slabs in rank order)
    with ``rows`` rows of the slab above before it and of the slab below
    after it, zeros past the first and the last slab: ``[V, h + 2 rows,
    ...]``. Differentiable: the backward sends each neighbour row's
    gradient to the rank that owns the row."""
    return _HaloExtend.apply(x, group, rows)
