"""Train and eval steps (counterpart of `repro.train.train_loop`).

The LM half (`:21-206`, `:250-261`): `softmax_cross_entropy`,
`chunked_cross_entropy`, `make_loss_fn`, the microbatched
`make_train_step` and `make_eval_step`.  The reference returns a pure
step for `jax.jit` and donates its state; here the step is ``(params,
opt_state, batch) -> (params, opt_state, metrics)`` over the module's
named parameters (``dict(model.named_parameters())``), whose ``.grad``
it fills by backward and which the optimizer's `update_` rewrites in
place — the counterpart of the donated buffers.  With ``plan=`` (or
``mesh=``) it is the LM on the mesh, `MeshTrainStep`: the reference's
one GSPMD program (`:176-206`) as explicit collectives over
`torch.distributed` ranks, with the one-device step's numbers, over
parameters whole over "data" (ZeRO-1) or placed first by
`MeshPlan.place_params_` (FSDP, the reference's production layout).

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
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed.collectives import Axis
from repro_torch.nn import layers

EXTRA_INPUT_KEYS = ("audio_embeds", "patch_embeds")
# the metrics every LM step returns, averaged over microbatches (the
# reference's accumulator `m0`)
LM_METRICS = ("loss", "total_loss", "tokens", "moe_lb_loss", "moe_z_loss",
              "moe_drop_fraction")


# ---------------------------------------------------------------------------
# LM: loss, train step, eval step
# ---------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor,
         vocab: tuple | None = None) -> torch.Tensor:
    """Per-position ``logsumexp(logits) - logits[label]``.  With `vocab`
    = (model `Axis`, first id), `logits` are this rank's slice of the
    vocabulary: the maximum and the sum of exponentials are reduced over
    the axis, and the label's logit is taken on the rank that holds it
    (the full logits are never gathered)."""
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz - ll
    axis, start = vocab
    width = logits.shape[-1]
    top = collectives.all_max(logits.detach().amax(dim=-1), axis)
    sumexp = collectives.reduce_from(
        torch.exp(logits - top[..., None]).sum(dim=-1), axis)
    local = labels.long() - start
    inside = (local >= 0) & (local < width)
    ll = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[
        ..., 0]
    ll = collectives.reduce_from(
        torch.where(inside, ll, torch.zeros((), dtype=ll.dtype,
                                            device=ll.device)), axis)
    return top + torch.log(sumexp) - ll


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
                          seq_chunk: int = 512, vocab: tuple | None = None,
                          data: Axis | None = None):
    """CE loss without ever holding [B, S, V] logits.

    The sequence goes in chunks of `seq_chunk` positions (or the largest
    divisor of S below it); each chunk's head and CE run under
    `torch.utils.checkpoint` (non-reentrant), as the reference's scan
    body under `jax.checkpoint`, so one [B, c, V] fp32 logits block is
    live at a time, in the forward and again in the backward.  The
    chunks' sums are added in order, as the scan's carry.

    `vocab`: the head gives a vocabulary slice (`_nll`).  `data`: this
    rank holds one block of the batch; the summed loss and the mask's
    count are summed over the data axis before the division, so the
    loss is the whole batch's mean (each rank's gradient is then its
    part of the whole batch's)."""
    b, s, _ = x.shape
    c = min(seq_chunk, s)
    while s % c:  # fall back to a divisor
        c -= 1
    n = s // c
    if n <= 1 and vocab is None and data is None:
        return softmax_cross_entropy(apply_head(x), labels, mask)
    if n <= 1:
        nll = _nll(apply_head(x), labels, vocab)
        mask = (torch.ones_like(nll) if mask is None
                else mask.to(torch.float32))
        return _global_mean((nll * mask).sum(), mask.sum(), data)

    def body(xc, lc, mc):
        nll = _nll(apply_head(xc), lc, vocab)
        mc = mc.to(torch.float32)
        return (nll * mc).sum(), mc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    recomputed = fsdp.recomputed(body)
    for i in range(n):
        cut = slice(i * c, (i + 1) * c)
        mc = (mask[:, cut] if mask is not None
              else torch.ones((b, c), dtype=torch.float32, device=x.device))
        if torch.is_grad_enabled():
            part, count = _ckpt.checkpoint(recomputed, x[:, cut],
                                           labels[:, cut], mc,
                                           use_reentrant=False)
        else:
            part, count = body(x[:, cut], labels[:, cut], mc)
        tot, den = tot + part, den + count
    return _global_mean(tot, den, data)


def _global_mean(total: torch.Tensor, count: torch.Tensor,
                 data: Axis | None):
    """(total / max(count, 1), that denominator), both summed over the
    data axis first when given."""
    if data is not None:
        total = collectives.reduce_from(total, data)
        count = collectives.all_reduce(count.detach(), data)
    count = torch.clamp(count, min=1.0)
    return total / count, count


def make_loss_fn(model, cfg: ArchConfig, *, seq_chunk: int = 512,
                 data: Axis | None = None) -> Callable:
    """``loss_fn(batch) -> (total loss, metrics)`` over `model`'s own
    parameters; the MoE configs add ``aux_loss_weight * moe_lb_loss +
    z_loss_weight * moe_z_loss`` to the total.  `data`: the batch is
    this rank's block of one over the data axis (`chunked_cross_entropy`;
    the MoE layers read the axis from the sharding context); a model
    split over its model axis gives a vocabulary slice (`vocab_shard`)."""
    def loss_fn(batch):
        extras = {k: batch[k] for k in EXTRA_INPUT_KEYS if k in batch}
        x, aux = model.backbone(batch["tokens"], **extras)
        vocab = model.vocab_shard() if hasattr(model, "vocab_shard") \
            else None
        loss, denom = chunked_cross_entropy(
            model.apply_head, x, batch["labels"], batch.get("loss_mask"),
            seq_chunk=seq_chunk, vocab=vocab, data=data)
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
    """The LM train step: ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    With ``plan`` (a `repro_torch.distributed.partition.MeshPlan`) or
    ``mesh`` (wrapped by `plan_for`) it is `MeshTrainStep` over the
    mesh's ranks (ZeRO-1 with ``zero1``; FSDP where the model was
    placed by `MeshPlan.place_params_`, which the step reads from the
    model; ``param_axes``: {parameter name: logical axes},
    `layers.param_axes(model)` when None).
    Without either, ``zero1`` and ``param_axes`` change nothing, as in
    the reference, and the step runs on one device:

    ``params`` are `model`'s named parameters.  Each microbatch's mean
    loss is backpropagated as it is, so its gradient adds into
    ``.grad`` in the parameter dtype (no second gradient buffer); with
    ``n_microbatches`` > 1 the sum is then multiplied by ``1 / n`` in
    that dtype and the metrics averaged, as the reference accumulates.
    An unused parameter gets a zero gradient, as `jax.grad` gives it.
    ``grad_compression`` (a ``grads -> grads`` callable, e.g.
    `ErrorFeedbackCompressor.bind`; on the mesh see `MeshTrainStep`)
    sees the gradients before the optimizer's in-place `update_`, with
    the layer grouping of the
    model's parameters (`layers.stack_groups`, Adafactor's; pass the same
    to ``optimizer.init``).  The raw gradients stay in ``.grad`` until
    the next step clears them."""
    if plan is not None or mesh is not None:
        if plan is None:
            from repro_torch.distributed.partition import plan_for
            plan = plan_for(mesh, device=next(model.parameters()).device)
        return MeshTrainStep(model, cfg, optimizer, plan,
                             n_microbatches=n_microbatches,
                             grad_compression=grad_compression,
                             param_axes=param_axes, zero1=zero1)
    loss_fn = make_loss_fn(model, cfg)
    groups = layers.stack_groups(dict(model.named_parameters()))

    def train_step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        metrics = _backward_metrics(
            loss_fn, _split_microbatches(batch, n_microbatches))
        grads = _gradients(params, n_microbatches)
        if grad_compression is not None:
            grads = _compress(grad_compression, grads, groups)
        params, opt_state, opt_metrics = optimizer.update_(
            grads, opt_state, params, groups=groups)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _compress(fn, grads: dict, groups: dict, whole_max=None) -> dict:
    """``grad_compression`` `fn` of `grads`: the repo's compressors
    (`compression.takes_max_over`) take each leaf's scale over its layer
    stack (`compression.stacked_max`, the reference's stacked leaf) and,
    through `whole_max`, over the ranks holding its slices; any other
    callable sees the gradients as they are."""
    from repro_torch.distributed import compression
    if not compression.takes_max_over(fn):
        return fn(grads)

    def max_over(amax):
        amax = compression.stacked_max(amax, groups)
        return amax if whole_max is None else whole_max(amax)
    return fn(grads, max_over=max_over)


def _backward_metrics(loss_fn, batches: list) -> dict:
    """Backpropagate each batch's total loss (the gradients add into
    ``.grad``) and return the metrics averaged over the batches."""
    metrics = None
    for mb in batches:
        total, m = loss_fn(mb)
        total.backward()
        m = {k: m[k].detach().to(torch.float32) for k in LM_METRICS}
        metrics = m if metrics is None else {
            k: metrics[k] + m[k] for k in LM_METRICS}
    return {k: v / len(batches) for k, v in metrics.items()}


def _gradients(params: dict, n_microbatches: int) -> dict:
    """{name: ``.grad``}: the microbatches' sum multiplied by 1 / n in
    the parameter dtype, as the reference accumulates; an unused
    parameter gets a zero gradient, as `jax.grad` gives it."""
    grads = {}
    with torch.no_grad():
        for k, p in params.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif n_microbatches > 1:
                p.grad.mul_(torch.full((), 1.0 / n_microbatches,
                                       dtype=p.grad.dtype,
                                       device=p.grad.device))
            grads[k] = p.grad
    return grads


class MeshTrainStep:
    """The LM train step on a (data, model) mesh of ranks: the
    reference's ``make_train_step(..., plan=, zero1=)``, one GSPMD
    program with the one-device step's numbers, as explicit collectives.

    * **Tensor parallelism** over "model": the step splits `model` in
      place on construction (`partition.model_layout`: the model's
      ``split_``, every family's: `DecoderLM`, `RWKV6LM`, `Zamba2LM`,
      `WhisperModel`), so read ``model.named_parameters()`` after
      building it.  A leaf split there holds its slice; its logical axes
      keep their model names, and a whole leaf's lose them, so every
      spec is what the rank holds.  A layer whose heads the axis does
      not divide computes whole on every model rank, its weights cut at
      rest and gathered at use (`nn.layers.Linear` ``rest_cut``): each
      rank keeps its slice of the whole gradient, which every rank
      holds alike, so nothing sums it over "model" (under the cut
      sequence, and in RWKV6's time mix cut by value columns, the
      gather's reduce-scatter sums each rank's part).  A layer split by
      heads (or value columns) that keeps a leaf whole but reads it for
      its part alone (RWKV6's mixes and LoRAs, Mamba2's ``A_log``, the
      cross-rank norms' scales: ``layout.partial``), or that holds some
      of a fused leaf alike on
      every rank (Mamba2's B and C columns: ``layout.dup``), leaves a
      part of their gradient on each model rank: those are summed over
      "model" every step, and the clipping norm counts the alike ranges
      once.
    * **Data parallelism**: every rank is handed the whole batch.  It is
      cut into microbatches first and each microbatch into the data
      ranks' row blocks (over pod x data where the mesh has pods) (the
      reference constrains each microbatch over "data"), so rank ``d``
      runs block ``d`` of every microbatch.  The loss is the
      microbatch's global mean (`make_loss_fn` with ``data=``), and the
      MoE layers see the data axis through `use_sharding`.
    * **Gradients**: each rank's backward gives its part of the global
      gradient, whole over "model" for a whole leaf and its slice's for
      a split one, so they are summed over the data ranks only
      (`MeshPlan.zero_reduce_grads(mean=False)`: "pod" and "data").
    * **Sequence parallelism**: where the plan's act rule of "seq" cut
      the step's sequence over "model" (the model's ``head_seq`` after
      its forward), a leaf whole over "model" (a norm, a bias added
      after a reduce-scatter, a whole attention or FFN, the router, a
      whole head) holds only its part of the gradient on each model
      rank: those are summed over "model" first (``model_sum``); a
      split leaf's gradient is whole for its shard already.
    * **ZeRO-1** (``zero1`` and more than one data rank): the optimizer
      state holds this data rank's slice of each leaf on the dim its
      "embed" axis resolves to (`init_opt_state`); the gradient arrives
      reduce-scattered there, the update runs on the slices (the norm
      and Adafactor's statistics corrected over both axes), and the new
      slices are all-gathered.
    * **FSDP** (ZeRO-3): where the model was placed first
      (`MeshPlan.place_params_`, the reference's ``"embed": "data"`` at
      rest), the step reads the layout from the model and splits
      nothing.  The parameters are slices over "data"; each layer
      gathers its own at use, and the gather's backward leaves each
      rank's slice of the gradient, summed over "data", in ``.grad``.
      Those are summed over "pod" alone (``sliced=True``), the whole
      leaves over pod x data; the update runs on the slices in place, as
      ZeRO-1's does, and nothing is gathered after it.

    * **Gradient compression** (``grad_compression``): after the
      reduction above and before the update, as the reference compresses
      the reduced gradient inside its step (`repro/train/train_loop.py:
      169-170`).  Each rank holds its slices of the gradient, so the
      repo's compressors (`compression.takes_max_over`:
      `compress_int8_stateless`, `ErrorFeedbackCompressor.bind`) take each
      leaf's scale over the whole leaf (`whole_max`) and code their own
      slice with it (a layer's scale its stack's, as the reference
      stacks layers); a bound compressor's residual is the rank's
      gradient slice (sized from the first gradient).  Any other
      ``grads -> grads`` callable is called on the rank's slices as they
      are.

    The body runs under the plan's `dispatch_context()`."""

    def __init__(self, model, cfg: ArchConfig, optimizer, plan, *,
                 n_microbatches: int = 1, grad_compression=None,
                 param_axes=None, zero1: bool = False):
        from repro_torch.distributed.partition import MODEL_AXIS, model_layout
        self.grad_compression = grad_compression
        self.optimizer, self.plan = optimizer, plan
        self.n_microbatches = n_microbatches
        self.model_axis = (plan.mesh.axes[MODEL_AXIS] if plan.model_axis
                           else None)
        layout = getattr(model, "mesh_layout", None)
        if layout is None:
            layout = model_layout(model, plan, param_axes)
        elif layout.plan is not plan:
            raise ValueError("make_train_step: the model was placed by "
                             "another plan")
        self.layout, self.fsdp = layout, layout.fsdp
        self.model_dims, self.axes = layout.model_dims, layout.axes
        self.specs = layout.specs
        self.zero = zero1 and plan.zero_enabled() and not self.fsdp
        self.data_dims = (layout.data_dims if self.zero or self.fsdp
                          else {k: -1 for k in layout.data_dims})
        params = dict(model.named_parameters())
        self.groups = layers.stack_groups(params)
        self.data = plan.batch_axis if plan.data_size > 1 else None
        self.model = model
        self.loss_fn = make_loss_fn(model, cfg, data=self.data)

    def init_opt_state(self, params: dict):
        """The optimizer's zero state for this rank: over its ZeRO slices
        of `params` (this rank's model slices; under FSDP the slices it
        holds)."""
        with torch.no_grad():
            mine = {k: p.detach() for k, p in params.items()}
            if not self.fsdp:
                mine = self.plan.zero_slice(mine, self.data_dims)
            return self.optimizer.init(mine, self.groups)

    def gather_params(self, params: dict) -> dict:
        """Whole parameters from this rank's (a collective)."""
        with torch.no_grad():
            tree = {k: p.detach() for k, p in params.items()}
            if self.fsdp:
                tree = {k: collectives.all_gather(
                    x, self.plan.data_axis, self.data_dims[k])
                    if self.data_dims[k] >= 0 else x
                    for k, x in tree.items()}
            return self.plan.gather_params(tree, self.model_dims,
                                           self.layout.fused)

    def model_sum(self) -> list:
        """The leaves whose gradients are summed over "model": those a
        split layer reads in part (``layout.partial``), and every leaf
        whole over it when the last forward cut its sequence over it."""
        names = list(self.layout.partial)
        if getattr(self.model, "head_seq", None) is not None:
            names += [k for k, d in self.model_dims.items()
                      if d < 0 and k not in self.layout.partial]
        return names

    def whole_max(self, amax: dict) -> dict:
        """{name: max |x| over the whole leaf} from each leaf's maximum
        over this rank's slice of its gradient: the maxima of the leaves
        cut over "model" taken over that axis in one `all_max`, then
        those of the leaves cut over "data" (ZeRO-1's or FSDP's slices,
        a leaf cut over both carrying its model maximum) over "data" in
        one more.  A leaf held alike on every rank of an axis (whole, or
        a fused leaf's columns every model rank holds) needs nothing
        there: a maximum counts it once."""
        out = dict(amax)
        cuts = ((self.model_axis, self.model_dims),
                (self.plan.data_axis, self.data_dims))
        for axis, dims in cuts:
            names = [k for k in out if dims[k] >= 0]
            if axis is None or axis.size == 1 or not names:
                continue
            both = collectives.all_max(torch.stack([out[k] for k in names]),
                                       axis)
            out.update(zip(names, both.unbind(0)))
        return out

    def compress(self, grads: dict) -> dict:
        """``grad_compression`` of this rank's reduced gradient slices
        (class docstring)."""
        return _compress(self.grad_compression, grads, self.groups,
                         self.whole_max)

    def _microbatches(self, batch: dict) -> list:
        """Rank ``d``'s row block of every microbatch of `batch`."""
        data = self.data
        micro = _split_microbatches(batch, self.n_microbatches)
        if data is None:
            return micro
        for k, x in micro[0].items():
            if x.shape[0] % data.size:
                raise ValueError(
                    f"batch leaf {k!r}: a microbatch of {x.shape[0]} rows "
                    f"does not split over {data.size} data shards")
        return [{k: collectives.split_chunk(x, data, 0)
                 for k, x in mb.items()} for mb in micro]

    def __call__(self, params: dict, opt_state, batch: dict):
        from repro_torch.distributed.sharding import use_sharding
        plan = self.plan
        for p in params.values():
            p.grad = None
        with use_sharding(plan.mesh, plan.param_rules, plan.act_rules), \
                plan.dispatch_context():
            metrics = _backward_metrics(self.loss_fn,
                                        self._microbatches(batch))
        grads = _gradients(params, self.n_microbatches)
        with torch.no_grad():
            grads = plan.zero_reduce_grads(
                grads, self.data_dims, mean=False, sliced=self.fsdp,
                model_sum=self.model_sum(), model_dup=self.layout.dup)
            if self.grad_compression is not None:
                grads = self.compress(grads)
            mesh_kw = dict(model=self.model_axis, model_dims=self.model_dims,
                           groups=self.groups)
            if self.layout.dup:
                mesh_kw["model_dup"] = self.layout.dup
            if self.zero:
                current = {k: p.detach() for k, p in params.items()}
                mine = plan.zero_slice(current, self.data_dims)
                mine, opt_state, opt_metrics = self.optimizer.update_(
                    grads, opt_state, mine, group=plan.data_axis,
                    shard_dims=self.data_dims, **mesh_kw)
                for k, x in plan.zero_gather(mine, self.data_dims).items():
                    params[k].copy_(x)
            else:  # in place: whole over "data", or FSDP's slices
                if self.fsdp:
                    mesh_kw.update(group=plan.data_axis,
                                   shard_dims=self.data_dims)
                _, opt_state, opt_metrics = self.optimizer.update_(
                    grads, opt_state, params, **mesh_kw)
        metrics.update(opt_metrics)
        return params, opt_state, metrics


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
