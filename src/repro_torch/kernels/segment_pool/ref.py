"""Plain PyTorch version of the segment_pool kernel.

Same contract as the kernel (and as the Pallas kernel it ports): ids
outside ``[0, n_segments)`` mark padding rows and are dropped, empty
segments yield 0 for every reduction, max starts from -1e30 and maps a
result <= -5e29 to 0, min is -max(-x), float inputs accumulate in fp32
and the result is cast back to the input dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
REDUCES = ("sum", "max", "min")


def segment_pool_ref(values: torch.Tensor, seg_ids: torch.Tensor, *,
                     n_segments: int, reduce: str = "sum") -> torch.Tensor:
    """values [E, ...], seg_ids [E] -> [n_segments, ...]."""
    if reduce not in REDUCES:
        raise ValueError(f"unsupported reduce {reduce!r}; expected one of "
                         f"{REDUCES}")
    ids = seg_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_segments)
    safe = torch.where(valid, ids, n_segments)  # padding -> spare row
    # the width spelled out: reshape cannot infer -1 when E = 0
    width = math.prod(values.shape[1:])
    flat = values.reshape(values.shape[0], width)
    floating = values.is_floating_point()
    if reduce == "sum":
        acc_dtype = torch.float32 if floating else values.dtype
        acc = torch.zeros((n_segments + 1, width), dtype=acc_dtype,
                          device=values.device)
        acc.index_add_(0, safe, flat.to(acc_dtype))
        out = acc[:n_segments]
    else:
        src = -flat if reduce == "min" else flat
        acc = torch.full((n_segments + 1, width), NEG_INF,
                         dtype=torch.float32, device=values.device)
        acc.scatter_reduce_(0, safe[:, None].expand(-1, width),
                            src.to(torch.float32), "amax", include_self=True)
        out = acc[:n_segments]
        out = torch.where(out <= NEG_INF / 2, torch.zeros_like(out), out)
        if reduce == "min":
            out = -out
    return out.to(values.dtype).reshape((n_segments,) + values.shape[1:])
