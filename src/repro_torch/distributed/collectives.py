"""The collectives of the mesh, over one axis of ranks at a time.

An `Axis` is one line of the mesh through this rank: its name, its size,
this rank's index along it, and the `torch.distributed` process group of
the ranks on that line.  Every collective here takes an `Axis` and is the
identity on an axis of size 1, where it calls nothing (a world of one
rank needs no process group at all).  The counterparts of the
reference's `jax.lax` collectives inside a shard_map body:

  `all_gather(x, axis, dim)`      ``all_gather(..., axis=dim, tiled=True)``
  `reduce_scatter(x, axis, dim)`  ``psum_scatter(..., scatter_dimension=dim,
                                  tiled=True)``
  `all_reduce(x, axis)`           ``psum``
  `broadcast(x, axis)`            (placement of replicated host state)
  `all_max(x, axis)`              ``pmax``

and the two differentiable boundaries of a tensor-parallel region (the
Megatron "copy" and "reduce" pair), which GSPMD inserts by itself where
a replicated activation meets a "model"-split weight:

  `copy_to(x, axis)`      identity forward, sum of the cotangents over
                          the axis backward (a replicated input read by
                          each rank's slice of the weights)
  `reduce_from(x, axis)`  sum over the axis forward, identity backward
                          (each rank's partial result made whole)

and two more of a region split by heads or channels:

  `sum_over(x, axis)`     sum over the axis forward and backward (a
                          statistic every rank reads for its own part:
                          a norm's row sums over channels cut over the
                          axis; the reference's ``psum`` transposes to
                          itself)
  `gather_from(x, axis, dim)`  all-gather forward, this rank's slice of
                          the gradient backward (a split output made
                          whole for a replicated use)

and the FSDP boundary of a parameter cut over "data" (ZeRO-3), which
GSPMD inserts where an "embed"-sharded weight meets its use:

  `gather_at_use(x, axis, dim)`  all-gather forward; the whole gradient
                          reduce-scattered back to the slice as a sum
                          backward (JAX transposes ``all_gather`` to a
                          ``psum_scatter``)

and the same boundary over "model", for a weight cut there at rest whose
layer computes whole on every model rank (heads the axis does not
divide: the reference's resolver cuts their fused columns and GSPMD
gathers them around the head reshape):

  `gather_at_use(x, axis, dim, alike=True)`  all-gather forward; this
                          rank's slice of the whole gradient backward
                          (every rank runs the same whole layer on the
                          same tokens and holds the same whole gradient,
                          so a sum would count it M times; inside a
                          sequence-parallel region, where each rank's
                          gradient is its part of a sum, the default
                          reduce-scatter is the right one)

and the two boundaries of a sequence-parallel region (Megatron's
sequence parallelism: the residual stream held as each rank's slice of
the sequence between blocks, the reference's ``"seq": "model"`` rule):

  `gather_seq(x, axis, dim)`  the slices all-gathered on the sequence
                          dim forward; the reduce-scatter sum backward
                          (every rank's block reads the whole sequence
                          and keeps only its slice of the output, so
                          each position's gradient is spread over the
                          ranks: a slice-only backward gives 1/M of it)
  `reduce_scatter_seq(x, axis, dim)`  a row-parallel output's partial
                          sums reduce-scattered on the sequence dim
                          forward; the all-gather backward

Inside the region (between the two) every rank's gradient of a tensor
is its part of a sum over the axis.  A computation that every rank of
the axis does alike there (a part whole over "model") either keeps its
rank's slice of the output (`split_chunk`, whose gradient is zero off
the slice) or carries 1/M of its gradient (`grad_share`); `first_only`
turns a whole tensor into such a part (itself on the axis' first rank,
zeros elsewhere).  `seq_observers` see every whole tensor `gather_seq`
makes (the liveness tests use them).

`sub_axis(axis, size)` is the line of `size` consecutive ranks of an
axis through this rank (an MoE group that spans several data ranks).

Transport: tensors go to the backend as they are, CUDA tensors included:
with torch 2.11 on an H100, gloo takes CUDA tensors for every collective
used here (`scripts/collective_probe.py` checks a machine), so nothing
is staged through host copies of our own.  NCCL needs one card per
rank; two ranks on one card use gloo.  The backend is the caller's
explicit choice (`partition.initialize_distributed`), never switched at
run time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank.  ``ranks`` are the global
    ranks on this rank's line of the axis, in axis order; ``group`` is
    their process group (None when the axis has one rank)."""

    name: str
    size: int
    index: int
    ranks: tuple = ()
    group: Optional[Any] = None

    @property
    def root(self) -> int:
        """Global rank of the line's first member."""
        return self.ranks[0] if self.ranks else 0


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of `x` over the axis (a new tensor; `x` is left as it is)."""
    if axis.size == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis' chunks of `x` concatenated on `dim`, in axis order."""
    if axis.size == 1:
        return x
    dim = dim % x.ndim
    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((axis.size * lead.shape[0],) + tuple(lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, lead, group=axis.group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's chunk (on `dim`) of the sum of `x` over the axis."""
    if axis.size == 1:
        return x
    dim = dim % x.ndim
    if x.shape[dim] % axis.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {axis.size} ways")
    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((lead.shape[0] // axis.size,) + tuple(lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, lead, op=dist.ReduceOp.SUM,
                               group=axis.group)
    return out.movedim(0, dim).contiguous()


def broadcast(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`x` as the axis' first rank holds it, written into `x` in place."""
    if axis.size == 1:
        return x
    dist.broadcast(x, src=axis.root, group=axis.group)
    return x


def barrier(axis: Axis) -> None:
    if axis.size > 1:
        dist.barrier(group=axis.group)


def split_chunk(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's chunk of `x` on `dim` (a contiguous copy)."""
    if axis.size == 1:
        return x
    width = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * width, width).contiguous()


def fused_slice(x: torch.Tensor, dim: int, pieces, axis: Axis
                ) -> torch.Tensor:
    """This rank's part of a whole tensor fused on `dim` from `pieces`
    ((width, cut) in order): its equal slice of each cut piece and all of
    each other one (a contiguous copy)."""
    parts, start = [], 0
    for width, cut in pieces:
        if cut:
            step = width // axis.size
            parts.append(x.narrow(dim, start + axis.index * step, step))
        else:
            parts.append(x.narrow(dim, start, width))
        start += width
    return torch.cat(parts, dim=dim).contiguous()


def fused_gather(x: torch.Tensor, axis: Axis, dim: int,
                 pieces) -> torch.Tensor:
    """The whole tensor from each rank's `fused_slice` of it: every cut
    piece concatenated over the axis, each other one from the axis'
    first rank."""
    if axis.size == 1:
        return x
    ranks = all_gather(x, axis, dim).chunk(axis.size, dim)
    parts, start = [], 0
    for width, cut in pieces:
        held = width // axis.size if cut else width
        parts += ([r.narrow(dim, start, held) for r in ranks] if cut
                  else [ranks[0].narrow(dim, start, held)])
        start += held
    return torch.cat(parts, dim=dim)


def all_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise maximum of `x` over the axis (a new tensor)."""
    if axis.size == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`x` as it is; its gradient is summed over the axis (every rank
    of the axis reads the same `x` with its own slice of a weight)."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of `x` over the axis; the gradient reaches each rank's
    `x` as it is (every rank holds one part of a sum)."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


def sum_over(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of `x` over the axis; each rank reads it for its own part
    of a computation, so the gradient is summed over the axis too."""
    if axis is None or axis.size == 1:
        return x
    return _SumOver.apply(x, axis)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return split_chunk(grad, ctx.axis, ctx.dim), None, None


def gather_from(x: torch.Tensor, axis: Optional[Axis],
                dim: int) -> torch.Tensor:
    """The axis' slices of `x` all-gathered on `dim`; every rank uses the
    whole alike, so each slice's gradient is this rank's part of the
    whole's."""
    if axis is None or axis.size == 1:
        return x
    return _GatherFrom.apply(x, axis, dim)


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.axis, ctx.dim), None, None


def gather_at_use(x: torch.Tensor, axis: Optional[Axis], dim: int, *,
                  alike: bool = False) -> torch.Tensor:
    """The axis' slices of `x` all-gathered on `dim` (a new tensor); the
    gradient of the whole is reduce-scattered back to each rank's slice
    as a sum over the axis (a rank's slice is read by every rank).
    ``alike``: every rank of the axis uses the whole alike and holds the
    same whole gradient, so each slice's gradient is its part of it
    (`gather_from`'s backward)."""
    if axis is None or axis.size == 1:
        return x
    if alike:
        return _GatherFrom.apply(x, axis, dim)
    return _GatherAtUse.apply(x, axis, dim)


seq_observers: list = []   # callables given each whole sequence gathered


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.axis, ctx.dim), None, None


def gather_seq(x: torch.Tensor, axis: Optional[Axis],
               dim: int = 1) -> torch.Tensor:
    """The axis' slices of the sequence all-gathered on `dim`; the
    gradient of the whole is reduce-scattered back to each rank's slice
    as a sum over the axis (`gather_at_use`'s pair of collectives)."""
    if axis is None or axis.size == 1:
        return x
    out = _GatherAtUse.apply(x, axis, dim)
    for fn in seq_observers:
        fn(out)
    return out


def reduce_scatter_seq(x: torch.Tensor, axis: Optional[Axis],
                       dim: int = 1) -> torch.Tensor:
    """This rank's slice on `dim` of the sum of `x` over the axis (each
    rank holds a partial sum of the whole sequence, or of all channels in
    RWKV6's split channel mix); the gradient of the slice is all-gathered
    back to the whole."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceScatterSeq.apply(x, axis, dim)


class _GradShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


def grad_share(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`x` as it is; its gradient divided by the axis' size (every rank
    of the axis computes the same `x`, and the gradients they give are
    summed over the axis)."""
    if axis is None or axis.size == 1:
        return x
    return _GradShare.apply(x, axis.size)


def first_only(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`x` on the axis' first rank and zeros on the others: a whole
    tensor as one part of a sum over the axis."""
    if axis is None or axis.size == 1 or axis.index == 0:
        return x
    return torch.zeros_like(x)


_SUB_AXES: dict = {}


def sub_axis(axis: Axis, size: int) -> Axis:
    """The line of `size` consecutive ranks of `axis` through this rank
    (`size` divides the axis).  Its process group is made on first use
    by the line's members alone (``use_local_synchronization``), so each
    line's ranks may ask for it independently; it is kept for the
    axis' group."""
    if size == axis.size:
        return axis
    if axis.size % size:
        raise ValueError(f"sub_axis: {size} does not divide {axis.name}'s "
                         f"{axis.size} ranks")
    start = axis.index // size * size
    ranks = tuple(axis.ranks[start:start + size])
    # a line spanning the world has no group of its own: key it by the
    # world's, so a later world in this process makes its own
    owner = axis.group if axis.group is not None else dist.group.WORLD
    key = (id(owner), ranks)
    if key not in _SUB_AXES:
        group = (dist.new_group(list(ranks), use_local_synchronization=True)
                 if size > 1 else None)
        # the owner is held beside its sub-lines, so its id is not reused
        # while they are kept
        _SUB_AXES[key] = (owner, Axis(f"{axis.name}/{size}", size,
                                      axis.index - start, ranks, group))
    return _SUB_AXES[key][1]


def sub_axis_of(group) -> Optional[Axis]:
    """The `sub_axis` line whose process group is `group`, or None."""
    return next((line for _, line in _SUB_AXES.values()
                 if line.group is group), None)
