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
