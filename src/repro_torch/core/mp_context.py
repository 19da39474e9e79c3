"""The model axis as the ops see it (counterpart of
`repro.core.mp_context`).

Lives at the core layer so `repro_torch.core.ops` can read it without
importing `repro_torch.distributed`: the mesh plan *sets* the context
around a train or eval step, the ops *read* it to split the feature axis
and place the all-gather at the pool boundary.

`ModelContext.gather` is an autograd Function whose backward is the
reduce-scatter SUM of the cotangent over the model axis, as JAX
transposes ``all_gather``.  Every rank of a model row computes the same
loss from the gathered values, so rank i's chunk receives the model
size times its share of the gradient; the step's mean over the model
axis then gives every parameter upstream of a split pool its full
gradient.  A backward that only sliced out its own chunk would hand
those parameters 1/M of it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch

_tls = threading.local()


class _Gather(torch.autograd.Function):
    """Forward: all-gather on the last dim, tiled.  Backward:
    reduce-scatter sum of the cotangent on the last dim."""

    @staticmethod
    def forward(ctx, x, axis):
        from repro_torch.distributed import collectives
        ctx.axis = axis
        return collectives.all_gather(x, axis, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.distributed import collectives
        return collectives.reduce_scatter(grad.contiguous(), ctx.axis,
                                          dim=-1), None


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """The model axis (a `repro_torch.distributed.collectives.Axis`) as
    visible inside a step.  `split` takes this rank's feature chunk,
    `gather` is the boundary all-gather."""

    axis: Any

    @property
    def size(self) -> int:
        return self.axis.size

    def can_split(self, x) -> bool:
        return (getattr(x, "ndim", 0) >= 2
                and x.shape[-1] % self.size == 0
                and x.shape[-1] >= self.size)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        # a contiguous copy: the kernels take row-major [E, D] chunks
        from repro_torch.distributed import collectives
        return collectives.split_chunk(x, self.axis, dim=-1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.axis)


@contextlib.contextmanager
def model_parallel_trace(axis: Optional[Any]):
    """Make the model axis visible to `repro_torch.core.ops` on the
    calling thread for the duration of a step.  No-op for an axis of one
    rank (the 1-D data-parallel path) or None."""
    prev = getattr(_tls, "mp", None)
    _tls.mp = ModelContext(axis) if axis is not None and axis.size > 1 \
        else None
    try:
        yield _tls.mp
    finally:
        _tls.mp = prev


def current_model_context() -> Optional[ModelContext]:
    return getattr(_tls, "mp", None)
