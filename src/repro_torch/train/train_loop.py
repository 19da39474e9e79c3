"""Train and eval steps (counterpart of `repro.train.train_loop`).

The LM half (`:21-175`, `:250-261`): `softmax_cross_entropy`,
`chunked_cross_entropy`, `make_loss_fn`, the microbatched
`make_train_step` on one device and `make_eval_step`.  The reference
returns a pure step for `jax.jit` and donates its state; here the step
is ``(params, opt_state, batch) -> (params, opt_state, metrics)`` over
the module's named parameters (``dict(model.named_parameters())``),
whose ``.grad`` it fills by backward and which the optimizer's
`update_` rewrites in place — the counterpart of the donated buffers.
``plan=``, ``mesh=``, ``zero1=`` and ``param_axes=`` belong to the LM
on the mesh, which is not ported yet (ROADMAP.md queue 1, "the LM on
the mesh"): they raise `NotImplementedError`.

The graph steps (the Trainer's step factories, `:218-306`): a plain
step on one device, or under a mesh plan (``plan=``) the 2-D step of
`repro_torch.distributed.partition`.

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
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.pipeline import prefetch

EXTRA_INPUT_KEYS = ("audio_embeds", "patch_embeds")
# the metrics every LM step returns, averaged over microbatches (the
# reference's accumulator `m0`)
LM_METRICS = ("loss", "total_loss", "tokens", "moe_lb_loss", "moe_z_loss",
              "moe_drop_fraction")


# ---------------------------------------------------------------------------
# LM: loss, train step, eval step
# ---------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - ll


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None):
    """logits [B, S, V] fp32, labels [B, S] int; the mean over `mask`
    and its denominator ``max(mask.sum(), 1)``."""
    nll = _nll(logits, labels)
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(torch.float32))
    total = (nll * mask).sum()
    denom = torch.clamp(mask.sum(), min=1.0)
    return total / denom, denom


def chunked_cross_entropy(apply_head: Callable, x: torch.Tensor,
                          labels: torch.Tensor, mask=None, *,
                          seq_chunk: int = 512):
    """CE loss without ever holding [B, S, V] logits.

    The sequence goes in chunks of `seq_chunk` positions (or the largest
    divisor of S below it); each chunk's head and CE run under
    `torch.utils.checkpoint` (non-reentrant), as the reference's scan
    body under `jax.checkpoint`, so one [B, c, V] fp32 logits block is
    live at a time, in the forward and again in the backward.  The
    chunks' sums are added in order, as the scan's carry."""
    b, s, _ = x.shape
    c = min(seq_chunk, s)
    while s % c:  # fall back to a divisor
        c -= 1
    n = s // c
    if n <= 1:
        return softmax_cross_entropy(apply_head(x), labels, mask)

    def body(xc, lc, mc):
        nll = _nll(apply_head(xc), lc)
        mc = mc.to(torch.float32)
        return (nll * mc).sum(), mc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        cut = slice(i * c, (i + 1) * c)
        mc = (mask[:, cut] if mask is not None
              else torch.ones((b, c), dtype=torch.float32, device=x.device))
        if torch.is_grad_enabled():
            part, count = _ckpt.checkpoint(body, x[:, cut], labels[:, cut],
                                           mc, use_reentrant=False)
        else:
            part, count = body(x[:, cut], labels[:, cut], mc)
        tot, den = tot + part, den + count
    den = torch.clamp(den, min=1.0)
    return tot / den, den


def make_loss_fn(model, cfg: ArchConfig, *, seq_chunk: int = 512
                 ) -> Callable:
    """``loss_fn(batch) -> (total loss, metrics)`` over `model`'s own
    parameters; the MoE configs add ``aux_loss_weight * moe_lb_loss +
    z_loss_weight * moe_z_loss`` to the total."""
    def loss_fn(batch):
        extras = {k: batch[k] for k in EXTRA_INPUT_KEYS if k in batch}
        x, aux = model.backbone(batch["tokens"], **extras)
        loss, denom = chunked_cross_entropy(
            model.apply_head, x, batch["labels"], batch.get("loss_mask"),
            seq_chunk=seq_chunk)
        total = loss
        if cfg.moe is not None:
            total = (total
                     + cfg.moe.aux_loss_weight * aux["moe_lb_loss"]
                     + cfg.moe.z_loss_weight * aux["moe_z_loss"])
        metrics = {"loss": loss, "total_loss": total, "tokens": denom}
        metrics.update(aux)
        return total, metrics

    return loss_fn


def _split_microbatches(batch: dict, n_micro: int) -> list:
    """`n_micro` batches, each leaf's leading dim cut in equal parts."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does "
                             f"not split into {n_micro} microbatches")
    return [{k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n_micro)]


def make_train_step(model, cfg: ArchConfig, optimizer, *,
                    n_microbatches: int = 1, grad_compression=None,
                    param_axes=None, mesh=None, plan=None,
                    zero1: bool = False) -> Callable:
    """The LM train step on one device: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)``.

    ``params`` are `model`'s named parameters.  Each microbatch's mean
    loss is backpropagated as it is, so its gradient adds into
    ``.grad`` in the parameter dtype (no second gradient buffer); with
    ``n_microbatches`` > 1 the sum is then multiplied by ``1 / n`` in
    that dtype and the metrics averaged, as the reference accumulates.
    An unused parameter gets a zero gradient, as `jax.grad` gives it.
    ``grad_compression`` (a ``grads -> grads`` callable, e.g.
    `ErrorFeedbackCompressor.bind`) sees the gradients before the
    optimizer's in-place `update_`.  The raw gradients stay in
    ``.grad`` until the next step clears them."""
    if plan is not None or mesh is not None or zero1 \
            or param_axes is not None:
        raise NotImplementedError(
            "make_train_step: plan=, mesh=, zero1= and param_axes= are the "
            "LM on the mesh, not ported yet (ROADMAP.md queue 1, 'the LM "
            "on the mesh')")
    loss_fn = make_loss_fn(model, cfg)

    def train_step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        if n_microbatches > 1:
            metrics = None
            for mb in _split_microbatches(batch, n_microbatches):
                total, m = loss_fn(mb)
                total.backward()
                m = {k: m[k].detach().to(torch.float32) for k in LM_METRICS}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in LM_METRICS}
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.mul_(torch.full(
                            (), 1.0 / n_microbatches, dtype=p.grad.dtype,
                            device=p.grad.device))
            metrics = {k: v / n_microbatches for k, v in metrics.items()}
        else:
            total, metrics = loss_fn(batch)
            total.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = {}
        for k, p in params.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads[k] = p.grad
        if grad_compression is not None:
            grads = grad_compression(grads)
        params, opt_state, opt_metrics = optimizer.update_(grads, opt_state,
                                                           params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(model, cfg: ArchConfig) -> Callable:
    """``eval_step(batch) -> metrics``, without autograd."""
    loss_fn = make_loss_fn(model, cfg)

    def eval_step(batch):
        with torch.no_grad():
            return loss_fn(batch)[1]

    return eval_step


# ---------------------------------------------------------------------------
# Graph train/eval steps (the Trainer's step factories)
# ---------------------------------------------------------------------------


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


def make_graph_train_step(loss_fn: Callable, optimizer, *, plan=None,
                          num_groups: int | None = None) -> Callable:
    """(params, opt_state, graph, labels) -> (params, opt_state, loss).

    ``loss_fn(scalar_graph, labels) -> scalar`` over modules that own
    `params`.  Without a plan: value-and-grad, then the optimizer
    update.  With a `repro_torch.distributed.partition.MeshPlan`:
    ``partition.make_train_step`` (per-rank forward/backward over the
    2-D mesh, gradient mean, ZeRO-1 update) — ``num_groups`` is the
    super-batch stack size, required there."""
    if plan is not None:
        from repro_torch.distributed import partition
        if num_groups is None:
            raise ValueError("make_graph_train_step with plan= needs "
                             "num_groups= (the super-batch stack size)")
        return partition.make_train_step(plan, loss_fn, optimizer,
                                         num_groups=num_groups)

    def train_step(params, opt_state, graph, labels):
        loss, grads = loss_and_grads(loss_fn, params, graph, labels)
        opt_state = apply_updates(optimizer, params, opt_state, grads)
        return params, opt_state, loss

    return train_step


def make_graph_eval_step(metric_fn: Callable, *, plan=None) -> Callable:
    """(graph, labels) -> tuple of metric scalars, without autograd.

    ``metric_fn(scalar_graph, labels)`` must return a TUPLE of scalars
    that are exact sums (numerators/denominators, not means) — with a
    plan they are summed over component groups and over the data axis
    by ``partition.make_eval_step``."""
    if plan is not None:
        from repro_torch.distributed import partition
        return partition.make_eval_step(plan, metric_fn)

    def eval_step(graph, labels):
        with torch.no_grad():
            return metric_fn(graph, labels)

    return eval_step


def device_prefetch(batches, place: Callable | None = None, *, plan=None,
                    depth: int = 2, device=None):
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
    runs as it is, on the thread.

    Under a mesh pass the `MeshPlan` as ``plan``: `place` then defaults
    to ``plan.put_super_batch`` (this rank's block of the groups, or its
    own row's group, at full width) and `device` to the plan's."""
    if place is None:
        if plan is None:
            raise ValueError("device_prefetch needs place= or plan=")
        place = plan.put_super_batch
    if device is None and plan is not None:
        device = plan.device
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
