"""GPipe-style pipeline parallelism over a mesh "stage" axis of ranks
(counterpart of `repro.distributed.pipeline_parallel`).

The layer stack of L layers is cut into S contiguous stages of L/S
layers, one stage a rank of the "stage" axis (`partition.make_mesh(
stages=S)`).  The schedule is the reference's GPipe loop: with M
microbatches it runs M + S - 1 ticks; at tick t stage 0 takes microbatch
t (the last one again past the end), every other stage the activation
its predecessor sent at tick t - 1, every stage runs its layers, and the
last stage's output at tick t is microbatch t - (S - 1).  The bubble
fraction is (S - 1) / (M + S - 1).

Where the reference moves activations with ``jax.lax.ppermute`` (stage i
to stage i + 1), a rank here all-gathers every stage's output over the
axis (`collectives.all_gather`, which gloo takes for CUDA tensors on one
card) and keeps its predecessor's: S times the bytes of a point-to-point
send, with a collective the port has proven on the card.  The final
outputs go to every stage as the reference's do, by a sum over the axis
of the last stage's copy and everybody else's zeros.

The gradient is the reference's, as ``jax.grad`` takes it through the
scan of ticks (`_Pipeline`): the forward runs the ticks without a graph
and keeps each tick's stage input; the backward runs the ticks in
reverse, recomputes the stage at each under autograd and sends its
input's cotangent from stage i to stage i - 1 by the same all-gather
(every rank issues the same collectives in the same order, bubble ticks
and the last tick included, whose cotangents are zero: a rank skips
their recompute but not their collective).  The output's cotangent is
taken once: each rank passes its own, and their mean over the axis
goes to the last stage (equal cotangents, as every rank's copy of one
logical output gives, are that cotangent once, as the transpose of the
reference's final sum is).  The input, which every stage is given, gets
its whole gradient on every rank (stage 0's, summed over the axis);
each stage's layers get theirs on their own rank.  A call with no
tensor that requires a gradient, or under `torch.no_grad()`, runs the
forward alone and keeps nothing.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.distributed import collectives


def stage_layers(stacked, mesh, *, stage_axis: str = "stage") -> list:
    """This rank's L/S layers of a whole stack, in order: a tensor
    ``[L, ...]`` gives its slices, a dict of such tensors a dict a
    layer, a sequence of L layers (modules, trees) its items.  L must
    be a multiple of the stage count."""
    axis = mesh.axes[stage_axis]
    if isinstance(stacked, dict):
        per = {k: stage_layers(v, mesh, stage_axis=stage_axis)
               for k, v in stacked.items()}
        return [dict(zip(per, vals)) for vals in zip(*per.values())]
    n = len(stacked)
    if n % axis.size:
        raise ValueError(f"{n} layers do not cut into {axis.size} stages")
    width = n // axis.size
    return [stacked[i] for i in range(axis.index * width,
                                      (axis.index + 1) * width)]


def _tensors(obj) -> list:
    """The tensors a layer tree reads: a module's parameters, a tensor,
    those of a dict's values or a sequence's items."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


class _Schedule:
    """One call's schedule: the body, this rank's layers and its place on
    the stage axis."""

    def __init__(self, body, layers, axis, n_microbatches):
        self.body, self.layers, self.axis = body, layers, axis
        self.n_micro = n_microbatches
        self.n_ticks = n_microbatches + axis.size - 1

    def stage(self, h):
        for layer in self.layers:
            h = self.body(layer, h)
        return h

    def live(self, t: int) -> bool:
        """Whether this stage's output at tick t reaches an emitted
        output (else its cotangent is zero)."""
        return self.axis.index <= t < self.axis.index + self.n_micro

    def forward(self, x, keep: bool):
        """The ticks without a graph: (outputs [M, b, ...] on every
        stage, {tick: stage input} of the live ticks when `keep`)."""
        axis, m = self.axis, self.n_micro
        s, stage = axis.size, axis.index
        mbs = x.reshape(m, -1, *x.shape[1:])
        buf = torch.zeros_like(mbs[0])
        outputs = torch.zeros_like(mbs)
        inputs = {}
        for t in range(self.n_ticks):
            h = mbs[min(t, m - 1)] if stage == 0 else buf
            if keep and self.live(t):   # a view of x, or a copy of
                inputs[t] = h if stage == 0 else h.clone()   # one gather
            h = self.stage(h)
            # the reference's ppermute i -> i + 1 (mod S)
            every = collectives.all_gather(h[None], axis, 0)
            buf = every[(stage - 1) % s]
            emit = t - (s - 1)
            if 0 <= emit < m and stage == s - 1:
                outputs[emit] = h
        # only the last stage wrote its outputs: the sum is its copy
        return collectives.all_reduce(outputs, axis), inputs


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node (module docstring)."""

    @staticmethod
    def forward(ctx, sched, x, *leaves):
        outputs, ctx.inputs = sched.forward(x, keep=True)
        ctx.sched, ctx.leaves = sched, leaves
        ctx.x_shape = x.shape
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        sched, leaves = ctx.sched, ctx.leaves
        axis, m = sched.axis, sched.n_micro
        s, stage = axis.size, axis.index
        # the one logical output's cotangent: the ranks' mean
        g_out = collectives.all_reduce(g_out, axis) / s
        mb_shape = g_out.shape[1:]
        g_x = torch.zeros((m,) + tuple(mb_shape), dtype=g_out.dtype,
                          device=g_out.device)
        wanted = [i for i, t in enumerate(leaves) if t.requires_grad]
        g_leaves = [None] * len(leaves)
        recv = torch.zeros(mb_shape, dtype=g_out.dtype, device=g_out.device)
        for t in reversed(range(sched.n_ticks)):
            g_in = torch.zeros_like(recv)
            if sched.live(t):
                g_y = recv
                emit = t - (s - 1)
                if 0 <= emit < m and stage == s - 1:
                    g_y = g_y + g_out[emit]
                h = ctx.inputs.pop(t).detach().requires_grad_(True)
                with torch.enable_grad():
                    y = sched.stage(h)
                got = torch.autograd.grad(
                    y, [h] + [leaves[i] for i in wanted], g_y,
                    allow_unused=True)
                g_in = got[0] if got[0] is not None else g_in
                for i, g in zip(wanted, got[1:]):
                    if g is not None:
                        g_leaves[i] = g if g_leaves[i] is None \
                            else g_leaves[i] + g
                if stage == 0:
                    g_x[min(t, m - 1)] += g_in
            # the forward's send i -> i + 1, reversed: i + 1 -> i
            every = collectives.all_gather(g_in[None], axis, 0)
            recv = every[(stage + 1) % s] if stage < s - 1 \
                else torch.zeros_like(recv)
        if ctx.needs_input_grad[1]:
            # every stage was given x: its gradient, stage 0's, on all
            g_x = collectives.all_reduce(g_x, axis).reshape(ctx.x_shape)
        else:
            g_x = None
        return (None, g_x, *g_leaves)


def pipeline_apply(body: Callable, mesh, *, stage_axis: str = "stage",
                   n_microbatches: int) -> Callable:
    """``fn(stage_params, x)`` running the stack as a pipeline.

    ``body(layer_params, h) -> h`` is one layer; ``stage_params`` are
    this rank's layers in order (`stage_layers`), where the reference
    takes the whole stack and its shard_map cuts it.  ``x`` [B, ...],
    the same on every stage, with B a multiple of `n_microbatches`.
    Every stage returns the whole output [B, ...], differentiable in
    ``x`` and in the tensors of ``stage_params`` (module docstring).
    Whether anything needs a gradient must be the same on every rank:
    the backward's collectives are issued by all of them."""
    axis = mesh.axes[stage_axis]

    def pipelined(stage_params: Sequence, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_microbatches:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n_microbatches} microbatches")
        sched = _Schedule(body, stage_params, axis, n_microbatches)
        leaves = list({id(t): t for t in _tensors(stage_params)}.values())
        if torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad for t in leaves)):
            outputs = _Pipeline.apply(sched, x, *leaves)
        else:
            with torch.no_grad():
                outputs, _ = sched.forward(x, keep=False)
        return outputs.reshape(-1, *outputs.shape[2:])

    return pipelined
