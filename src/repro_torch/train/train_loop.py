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

from repro_torch.core.graph_tensor import GraphTensor
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


def device_prefetch(batches, place: Callable, *, depth: int = 2,
                    device=None):
    """Run `place` (host -> device) for the next batches on a background
    thread while the caller runs the current step (the
    `repro_torch.data.pipeline.prefetch` contract: errors re-raise at the
    consumer, early close joins the thread).

    On a CUDA `device`, ``place(*batch, non_blocking=True)`` runs under a
    side stream: each leaf is written into a pinned host buffer and
    copied from there without blocking the host, so the copies of batch
    k + 1 overlap step k.  An event recorded on the side stream after
    each batch's copies is what the consumer's stream waits on before
    the batch is handed over, and every placed tensor is marked as used
    on the consumer's stream (`record_stream`), so the caching allocator
    does not give its memory to another tensor before the step that
    reads it has run.  On any other device (or ``device=None``) `place`
    runs as it is, on the thread."""
    if device is None or torch.device(device).type != "cuda":
        return prefetch((place(*b) for b in batches), depth=depth)
    return _cuda_prefetch(batches, place, depth, torch.device(device))


def _tensors(tree):
    """Every tensor of a placed batch: a GraphTensor, tensors, tuples."""
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, GraphTensor):
        ctx = tree.context
        yield ctx.sizes
        yield from ctx.features.values()
        for ns in tree.node_sets.values():
            yield ns.sizes
            yield from ns.features.values()
        for es in tree.edge_sets.values():
            yield es.sizes
            yield es.adjacency.source
            yield es.adjacency.target
            yield from es.features.values()
    elif hasattr(tree, "record_stream"):
        yield tree


def _cuda_prefetch(batches, place, depth: int, device):
    copy_stream = torch.cuda.Stream(device)

    def staged():
        for b in batches:
            with torch.cuda.stream(copy_stream):
                placed = place(*b, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            yield placed, done

    ahead = prefetch(staged(), depth=depth)
    try:
        for placed, done in ahead:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in _tensors(placed):
                t.record_stream(stream)
            yield placed
    finally:
        ahead.close()  # joins the prefetch thread on an early close
