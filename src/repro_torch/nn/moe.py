"""Mixture-of-Experts FFN with static-shape capacity dispatch
(counterpart of `repro.nn.moe`).

Token -> expert dispatch is a gather, batched expert GEMMs, then a
weighted combine back to the tokens, in groups (GShard): positions in an
expert are counted within a group of tokens, each expert keeps at most
`capacity` of a group's assignments, and the rest are dropped.

  * routing: the router in the compute dtype, softmax in fp32, top-k by a
    stable descending sort, so equal probabilities keep the lower expert
    id first, as `jax.lax.top_k` does;
  * positions in an expert: the cumsum over a one-hot ``[G, N, E]``
    (N = tokens of a group x top_k), in assignment order;
  * dispatch: a scatter into an ``[G, E * cap + 1, d]`` buffer whose last
    row takes every dropped assignment and is then cut off (the
    reference's ``.at[slot].set(mode="drop")`` with slot ``E * cap``);
  * combine: each assignment's expert output, clamped to a real slot and
    weighted by its gate (0 when dropped), summed over its token's k
    assignments (the reference's ``segment_sum`` over
    ``repeat(arange(T), k)``).

The expert stacks ``wi`` / ``wg`` ``[E, d, h]`` and ``wo`` ``[E, h, d]``
are each one parameter, cast to the compute dtype on every call as the
reference casts them.  The sharding constraints of the reference are the
identity on one device and are left out.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import ACTIVATIONS, MLP, Linear, lecun_normal_


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    drop_fraction: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, ties in
    index order (`jax.lax.top_k`'s order; `torch.topk` leaves it open)."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


class MoELayer(nn.Module):
    """Top-k routed expert FFN, with an optional parallel dense MLP."""

    def __init__(self, dim: int, hidden: int, n_experts: int, top_k: int, *,
                 capacity_factor: float = 1.25, capacity_multiple: int = 8,
                 activation: str = "silu", gated: bool = True,
                 dense_residual_hidden: int | None = None,
                 normalize_gates: bool = True, n_groups: int = 16):
        super().__init__()
        self.n_groups = n_groups
        self.dim = dim
        self.hidden = hidden
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.capacity_multiple = capacity_multiple
        self.act = ACTIVATIONS[activation]
        self.gated = gated
        self.normalize_gates = normalize_gates
        self.router = Linear(dim, n_experts, use_bias=False)
        self.wi = nn.Parameter(torch.zeros(n_experts, dim, hidden))
        self.wg = (nn.Parameter(torch.zeros(n_experts, dim, hidden))
                   if gated else None)
        self.wo = nn.Parameter(torch.zeros(n_experts, hidden, dim))
        self.dense = (MLP(dim, dense_residual_hidden, activation=activation,
                          gated=gated)
                      if dense_residual_hidden else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each expert's matrices lecun-normal, drawn one expert at a
        time (`repro/nn/moe.py:66-85`); the router and the dense MLP draw
        their own."""
        for stack in (self.wi, self.wo, self.wg):
            if stack is not None:
                for expert in stack:
                    lecun_normal_(expert, generator)

    def capacity(self, n_tokens: int) -> int:
        c = math.ceil(n_tokens * self.top_k / self.n_experts
                      * self.capacity_factor)
        return max(self.capacity_multiple,
                   _round_up(c, self.capacity_multiple))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, MoEAux]:
        orig_shape = x.shape
        d = orig_shape[-1]
        xt = x.reshape(-1, d)
        t = xt.shape[0]
        e, k = self.n_experts, self.top_k
        g = self.n_groups
        while t % g:
            g //= 2
        tg = t // g
        cap = self.capacity(tg)
        xg = xt.reshape(g, tg, d)

        # routing: the router in the compute dtype, softmax in fp32
        router_logits = self.router(xg).to(torch.float32)
        probs = torch.softmax(router_logits, dim=-1)  # [G, Tg, E]
        gate_vals, expert_ids = top_k(probs, k)       # [G, Tg, k]
        if self.normalize_gates:
            gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

        # group-local position in each expert
        flat_expert = expert_ids.reshape(g, tg * k)
        onehot = F.one_hot(flat_expert, e).to(torch.int32)  # [G, N, E]
        pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1  # [G, N]
        keep = pos < cap
        slots = torch.where(keep, flat_expert * cap + pos,
                            torch.full_like(pos, e * cap))
        token_ids = torch.arange(tg, device=x.device).repeat_interleave(k)

        # dispatch: the dropped go to row e * cap, which is cut off
        gathered = xg[:, token_ids]  # [G, N, d]
        gathered = torch.where(keep[..., None], gathered,
                               torch.zeros((), dtype=xt.dtype,
                                           device=x.device))
        buf = torch.zeros((g, e * cap + 1, d), dtype=xt.dtype,
                          device=x.device)
        buf.scatter_(1, slots[..., None].expand(-1, -1, d), gathered)
        buf = buf[:, :e * cap].reshape(g, e, cap, d)

        # the experts, their stacks cast a call
        wi = self.wi.to(xt.dtype)
        wo = self.wo.to(xt.dtype)
        h = torch.einsum("gecd,edh->gech", buf, wi)
        if self.gated:
            wg = self.wg.to(xt.dtype)
            h = self.act(torch.einsum("gecd,edh->gech", buf, wg)) * h
        else:
            h = self.act(h)
        out = torch.einsum("gech,ehd->gecd", h, wo).reshape(g, e * cap, d)

        # combine: a token's k assignments are adjacent
        picked = torch.gather(
            out, 1, slots.clamp(max=e * cap - 1)[..., None].expand(-1, -1, d))
        weight = (gate_vals.reshape(g, -1) * keep).to(xt.dtype)
        y = (picked * weight[..., None]).reshape(g, tg, k, d).sum(2)
        y = y.reshape(t, d)

        if self.dense is not None:
            y = y + self.dense(xt)

        # auxiliary values
        me = probs.mean(dim=(0, 1))  # [E] mean router probability
        ce = (onehot.sum((0, 1)) / max(t * k, 1)).to(torch.float32)
        lb_loss = e * torch.sum(me * ce)
        z_loss = torch.mean(torch.square(
            torch.logsumexp(router_logits, dim=-1)))
        dropped = 1.0 - keep.to(torch.float32).mean()
        aux = MoEAux(lb_loss, z_loss, dropped)
        return y.reshape(orig_shape).to(x.dtype), aux
