"""Plain PyTorch version of the edge_mpnn kernel.

Same contract as the kernel (and as the Pallas kernel it ports): gather
with clamped indices, message = act([h_src[src]; h_tgt[tgt]] @ W + b) in
fp32, edges with tgt outside ``[0, n_tgt)`` dropped, sum per target in
fp32, result cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = ("relu", "gelu", "identity")


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    if activation == "identity":
        return x
    raise ValueError(f"unsupported activation {activation!r}; expected one "
                     f"of {ACTIVATIONS}")


def edge_mpnn_ref(h_src: torch.Tensor, h_tgt: torch.Tensor,
                  src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, *, n_src: int, n_tgt: int,
                  activation: str = "relu") -> torch.Tensor:
    """h_src [n_src, Ds], h_tgt [n_tgt, Dt], src/tgt [E], w [Ds+Dt, M],
    b [M] -> [n_tgt, M]."""
    src = src.to(torch.int64)
    tgt = tgt.to(torch.int64)
    valid = (tgt >= 0) & (tgt < n_tgt)
    hs = h_src[src.clamp(0, n_src - 1)]
    ht = h_tgt[tgt.clamp(0, n_tgt - 1)]
    x = torch.cat([hs, ht], dim=-1).to(torch.float32)
    msg = activate(x @ w.to(torch.float32) + b.to(torch.float32), activation)
    msg = torch.where(valid[:, None], msg, torch.zeros_like(msg))
    out = torch.zeros((n_tgt + 1, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, torch.where(valid, tgt, n_tgt), msg)
    return out[:n_tgt].to(h_src.dtype)
