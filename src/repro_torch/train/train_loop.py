"""Graph train/eval steps (counterpart of the Trainer's step factories in
`repro.train.train_loop`, `:264-306`), without the mesh (``plan=``).

In PyTorch the parameters live in the modules, so a loss function here
takes ``(graph, labels)`` and reads the parameters it was built over;
a step is handed the same parameters as a dict ``{name: nn.Parameter}``
(``dict(model.named_parameters())``) and writes the optimizer's new
values into them.  The gradient is `torch.autograd.grad` of the loss —
on the card it runs through the kernels' autograd Functions, whose
backward is the plain versions' gradient.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.pipeline import prefetch


def loss_and_grads(loss_fn: Callable, params: dict, graph, labels):
    """(loss, {name: gradient}); an unused parameter gets a zero
    gradient, as `jax.grad` gives it."""
    names = list(params)
    loss = loss_fn(graph, labels)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def apply_updates(optimizer, params: dict, opt_state, grads: dict):
    """One optimizer update, written into `params` in place; returns the
    new optimizer state."""
    with torch.no_grad():
        new, opt_state, _ = optimizer.update(
            grads, opt_state, {k: p.detach() for k, p in params.items()})
        for k, p in params.items():
            p.copy_(new[k])
    return opt_state


def make_graph_train_step(loss_fn: Callable, optimizer) -> Callable:
    """(params, opt_state, graph, labels) -> (params, opt_state, loss).

    ``loss_fn(scalar_graph, labels) -> scalar`` over modules that own
    `params`: value-and-grad, then the optimizer update."""

    def train_step(params, opt_state, graph, labels):
        loss, grads = loss_and_grads(loss_fn, params, graph, labels)
        opt_state = apply_updates(optimizer, params, opt_state, grads)
        return params, opt_state, loss

    return train_step


def make_graph_eval_step(metric_fn: Callable) -> Callable:
    """(graph, labels) -> tuple of metric scalars, without autograd.

    ``metric_fn(scalar_graph, labels)`` must return a TUPLE of scalars
    that are exact sums (numerators/denominators, not means)."""

    def eval_step(graph, labels):
        with torch.no_grad():
            return metric_fn(graph, labels)

    return eval_step


def device_prefetch(batches, place: Callable, *, depth: int = 2):
    """Run `place` (host -> device) for the next batches on a background
    thread while the caller runs the current step (the
    `repro_torch.data.pipeline.prefetch` contract: errors re-raise at the
    consumer, early close joins the thread).  The copy itself is
    `to_device`'s, from pageable memory; pinned buffers and a side CUDA
    stream are later work."""
    return prefetch((place(*b) for b in batches), depth=depth)
