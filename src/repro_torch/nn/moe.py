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
reference casts them, and run by `Experts`, a module without parameters
of its own (so a forward hook, such as the dry run's, sees the experts
apart from the dispatch and combine around them).

On a mesh (the counterpart of the reference's sharding constraints,
`repro/nn/moe.py:112-165`):

  * groups over "data" (the current `sharding.use_sharding` context's
    data-parallel ranks, `sharding.batch_axis`: pod x data on a mesh with
    pods): the group count and capacity are the reference's, from
    the tokens of the whole (micro)batch, and a group is consecutive
    tokens of it.  Where the data ranks divide the groups, a rank runs
    its contiguous block of them — the block its rows hold.  Where the
    groups divide the ranks instead (16 groups over 2 pods x 16 data
    ranks: the reference's rule puts them on "data" and GSPMD
    replicates them over "pod"), each group spans ``share`` consecutive
    ranks: a rank gathers the group's tokens from them
    (`collectives.sub_axis`, `gather_at_use`), computes the group as they
    all do, and keeps its own rows' outputs.  The auxiliary values are
    global means: sums and counts are all-reduced over the data axis
    before the load-balance product (``e * sum(me * ce)`` is not
    linear), a shared group's counted once (its ``share`` copies each
    weighed 1 / share).  Any other group count raises;
  * experts over "model" (`split_`): a rank keeps its contiguous block
    of experts, runs them on the dispatched tokens of its groups and
    combines only their outputs; the combine is summed over the axis.
    The router and the routing stay whole on every rank; the dispatched
    tokens and the gates enter the rank's experts through
    `collectives.copy_to`, so their gradients are summed over the axis;
  * where the axis does not divide the experts but divides their hidden
    width (granite's 40 experts of 512 at 16), the reference's resolver
    falls through from "expert" to "mlp": each rank keeps every expert,
    ``wi`` / ``wg`` cut on their hidden columns and ``wo`` on its rows
    (``cut == "mlp"``).  Routing, capacity and drops are computed alike
    on every rank (the same router on the same tokens), every rank
    dispatches every assignment to its slice of each expert, and the
    combine is a partial sum over the axis, reduced once where the
    output is (`reduce_from`), as the dense `MLP`'s row split is.  The
    dispatched tokens and the gates enter through `copy_to` as above,
    so the router's gradient is whole and alike on every rank and the
    auxiliary values, computed alike, are counted once;
  * inside a sequence-parallel block (``reduce=False``: the input is the
    whole gathered sequence, each rank's gradient its part of a sum over
    "model"): no `copy_to`, the output is this rank's part of the sum
    (its experts' combine and its part of the dense MLP; a whole part
    counted on the axis' first rank, `collectives.first_only`), and the
    auxiliary values, which every model rank computes alike, carry 1/M of
    their gradient (`collectives.grad_share`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import Axis, copy_to, reduce_from
from repro_torch.distributed.sharding import (batch_axis, mesh_axis,
                                              shard_activation)
from repro_torch.nn.layers import (ACTIVATIONS, MLP, Linear, rank_slice,
                                   lecun_normal_, splits)


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


class Experts(nn.Module):
    """The experts' three batched products on a dispatch buffer
    ``[G, E, cap, d]``, from the stacks the caller passes (`MoELayer`
    owns them)."""

    def __init__(self, act, gated: bool):
        super().__init__()
        self.act, self.gated = act, gated

    def forward(self, buf, wi, wg, wo):
        h = torch.einsum("gecd,edh->gech", buf, wi.to(buf.dtype))
        if self.gated:
            h = self.act(torch.einsum("gecd,edh->gech", buf,
                                      wg.to(buf.dtype))) * h
        else:
            h = self.act(h)
        h = shard_activation(h, ("moe_group", "expert", None, "mlp"))
        return torch.einsum("gech,ehd->gecd", h, wo.to(buf.dtype))


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
        self.router = Linear(dim, n_experts, use_bias=False,
                             kernel_axes=("embed", None))
        self.wi = nn.Parameter(torch.zeros(n_experts, dim, hidden))
        self.wg = (nn.Parameter(torch.zeros(n_experts, dim, hidden))
                   if gated else None)
        self.wo = nn.Parameter(torch.zeros(n_experts, hidden, dim))
        self.experts = Experts(self.act, gated)
        self.dense = (MLP(dim, dense_residual_hidden, activation=activation,
                          gated=gated)
                      if dense_residual_hidden else None)
        self.axis: Axis | None = None
        self.cut: str | None = None   # "expert" or "mlp" once split
        self.expert_start = 0

    def logical_axes(self) -> dict:
        return {"wi": ("expert", "embed", "mlp"),
                "wg": ("expert", "embed", "mlp"),
                "wo": ("expert", "mlp", "embed")}

    def split_(self, axis: Axis) -> bool:
        """Keep this rank's block of experts when they split evenly over
        the axis, else this rank's slice of every expert's hidden width
        when that splits (module docstring); the dense residual MLP
        splits on its own.  False when the experts stay whole."""
        if self.dense is not None:
            self.dense.split_(axis)
        if splits(self.n_experts, axis):
            self.cut, dims = "expert", (0, 0)
        elif splits(self.hidden, axis):
            self.cut, dims = "mlp", (2, 1)
        else:
            return False
        self.wi = rank_slice(self.wi, dims[0], axis)
        self.wo = rank_slice(self.wo, dims[1], axis)
        if self.wg is not None:
            self.wg = rank_slice(self.wg, dims[0], axis)
        self.axis = axis
        if self.cut == "expert":
            self.expert_start = axis.index * self.wi.shape[0]
        return True

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

    def partial(self) -> bool:
        """Whether ``forward(reduce=False)`` gives a part of a sum over
        the model axis (the experts or the dense MLP are split) rather
        than the whole output."""
        return self.axis is not None or (self.dense is not None
                                         and self.dense.axis is not None)

    def forward(self, x: torch.Tensor, reduce: bool = True
                ) -> tuple[torch.Tensor, MoEAux]:
        """The output and the auxiliary values; ``reduce=False`` inside a
        sequence-parallel block (module docstring)."""
        entry = copy_to if reduce else (lambda t, axis: t)
        orig_shape = x.shape
        d = orig_shape[-1]
        xt = x.reshape(-1, d)
        t = xt.shape[0]
        e, k = self.n_experts, self.top_k
        data = batch_axis()
        shards = data.size if data is not None else 1
        t_all = t * shards  # the (micro)batch's tokens on every data rank
        g = self.n_groups
        while t_all % g:
            g //= 2
        share = 1
        if g % shards and not shards % g:
            share = shards // g  # ranks a group spans
        elif g % shards:
            raise ValueError(
                f"MoE: {g} groups of {t_all // g} tokens ({t_all} tokens, "
                f"input {tuple(orig_shape)} a rank) do not split over "
                f"{shards} data shards")
        tg = t_all // g
        g = max(g // shards, 1)  # the groups this rank computes
        cap = self.capacity(tg)
        line = None
        if share > 1:
            line = collectives.sub_axis(data, share)
            xt = collectives.gather_at_use(xt, line, 0)
        xg = shard_activation(xt.reshape(g, tg, d),
                              ("moe_group", None, None))

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
        gathered = entry(xg, self.axis)[:, token_ids]  # [G, N, d]
        gathered = torch.where(keep[..., None], gathered,
                               torch.zeros((), dtype=xt.dtype,
                                           device=x.device))
        buf = torch.zeros((g, e * cap + 1, d), dtype=xt.dtype,
                          device=x.device)
        buf.scatter_(1, slots[..., None].expand(-1, -1, d), gathered)
        # this rank's experts (all of them unless split over "model")
        e_loc, first = self.wi.shape[0], self.expert_start * cap
        buf = buf[:, first:first + e_loc * cap].reshape(g, e_loc, cap, d)
        buf = shard_activation(buf, ("moe_group", "expert", None, None))

        # the experts, their stacks cast a call
        out = self.experts(buf, self.wi, self.wg, self.wo)
        out = shard_activation(out, ("moe_group", "expert", None, None))
        out = out.reshape(g, e_loc * cap, d)

        # combine: a token's k assignments are adjacent; on a split, only
        # the assignments to this rank's experts (all of them, each a
        # partial sum, when cut by hidden width), summed over the axis
        mine, gates = keep, gate_vals.reshape(g, -1)
        local = slots - first
        if self.axis is not None:
            if self.cut == "expert":
                mine = keep & (local >= 0) & (local < e_loc * cap)
            gates = entry(gates, self.axis)
        picked = torch.gather(
            out, 1, local.clamp(0, e_loc * cap - 1)[..., None]
            .expand(-1, -1, d))
        weight = (gates * mine).to(xt.dtype)
        y = (picked * weight[..., None]).reshape(g, tg, k, d).sum(2)
        if reduce:
            y = reduce_from(y, self.axis)
        y = shard_activation(y, ("moe_group", None, None)).reshape(-1, d)
        if line is not None:  # this rank's rows of its group
            xt = xt.narrow(0, line.index * t, t)
            y = y.narrow(0, line.index * t, t)
        model = None if reduce else mesh_axis("model")
        if not reduce and self.partial() and self.axis is None:
            y = collectives.first_only(y, model)

        if self.dense is not None:
            dense = self.dense(xt, reduce)
            if not reduce and self.partial() and self.dense.axis is None:
                dense = collectives.first_only(dense, model)
            y = y + dense

        aux = self._aux(probs, router_logits, onehot, keep, t_all, data,
                        share)
        if model is not None:
            aux = MoEAux(*(collectives.grad_share(a, model) for a in aux))
        return y.reshape(orig_shape).to(x.dtype), aux

    def _aux(self, probs, router_logits, onehot, keep, t: int,
             data: Axis | None, share: int = 1) -> MoEAux:
        """The load-balance loss, router z-loss and drop fraction over
        all `t` tokens of the (micro)batch: over this rank's groups, or
        with `data`, from sums and counts all-reduced over it first (a
        group computed on `share` ranks weighed 1 / share on each)."""
        e, k = self.n_experts, self.top_k
        lse2 = torch.square(torch.logsumexp(router_logits, dim=-1))
        if data is None:
            me = probs.mean(dim=(0, 1))  # [E] mean router probability
            ce = (onehot.sum((0, 1)) / max(t * k, 1)).to(torch.float32)
            z_loss = torch.mean(lse2)
            dropped = 1.0 - keep.to(torch.float32).mean()
        else:
            sums = reduce_from(torch.cat([probs.sum(dim=(0, 1)),
                                          lse2.sum()[None]]), data)
            counts = collectives.all_reduce(torch.cat([
                onehot.sum((0, 1)).to(torch.float32),
                keep.to(torch.float32).sum()[None]]), data)
            if share > 1:
                sums, counts = sums / share, counts / share
            me, z_loss = sums[:e] / t, sums[e] / t
            ce = counts[:e] / max(t * k, 1)
            dropped = 1.0 - counts[e] / (t * k)
        return MoEAux(e * torch.sum(me * ce), z_loss, dropped)
