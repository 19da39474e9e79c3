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

The forward only: no reference path differentiates the pipeline, so it
runs without autograd and its result carries no gradient (ROADMAP.md
lists the backward as a follow-up).
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


def pipeline_apply(body: Callable, mesh, *, stage_axis: str = "stage",
                   n_microbatches: int) -> Callable:
    """``fn(stage_params, x)`` running the stack as a pipeline.

    ``body(layer_params, h) -> h`` is one layer; ``stage_params`` are
    this rank's layers in order (`stage_layers`), where the reference
    takes the whole stack and its shard_map cuts it.  ``x`` [B, ...],
    the same on every stage, with B a multiple of `n_microbatches`.
    Every stage returns the whole output [B, ...]."""
    axis = mesh.axes[stage_axis]
    n_stages, stage = axis.size, axis.index

    def pipelined(stage_params: Sequence, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_microbatches:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n_microbatches} microbatches")
        with torch.no_grad():
            mbs = x.reshape(n_microbatches, -1, *x.shape[1:])
            buf = torch.zeros_like(mbs[0])
            outputs = torch.zeros_like(mbs)
            for t in range(n_microbatches + n_stages - 1):
                h = mbs[min(t, n_microbatches - 1)] if stage == 0 else buf
                for layer in stage_params:
                    h = body(layer, h)
                # the reference's ppermute i -> i + 1 (mod S)
                every = collectives.all_gather(h[None], axis, 0)
                buf = every[(stage - 1) % n_stages]
                emit = t - (n_stages - 1)
                if 0 <= emit < n_microbatches and stage == n_stages - 1:
                    outputs[emit] = h
            # only the last stage wrote its outputs: the sum is its copy
            outputs = collectives.all_reduce(outputs, axis)
        return outputs.reshape(-1, *outputs.shape[2:])

    return pipelined
