"""AdamW, Adafactor, their schedules and gradient clipping — a
line-for-line port of `repro.train.optimizer`, ZeRO-1 arguments
included: under the mesh (`repro_torch.distributed.partition`) `update`
takes this data rank's slices and a ``group`` (the data `Axis`) with
``shard_dims``; AdamW needs the cross-rank correction only in the
clipping norm, Adafactor also in every mean over a sliced dimension.
A leaf split over the "model" axis as well (tensor parallelism) comes
with ``model`` (the model `Axis`) and ``model_dims``, and is corrected
over that axis in the same places.  ``model_dup`` names the ranges of a
split leaf that every model rank holds alike (Mamba2's B and C columns
of its fused projection): AdamW's norm counts them once; Adafactor
refuses them.

It is not `torch.optim.AdamW`, whose defaults and order differ: b2 is
0.95 and eps 1e-8; the gradient is clipped to global norm 1.0 (with
``norm + 1e-9``) in fp32 inside `update`; weight decay is added to the
Adam step inside the lr-scaled delta; the schedule is read at
``step + 1``; and `warmup_cosine` decays to ``final_frac = 0.1`` of the
peak.  Trees are dicts ``{name: tensor}`` (a module's named parameters).

`update` is pure — it returns new tensors and a new state, and the
caller writes them into the parameters.  `update_` is the same update
written into the parameters and the optimizer state in place, leaf by
leaf: the counterpart of the reference's buffer donation and
`_maybe_chunked`.  AdamW's `update_` applies the clip scale inside each
leaf's update (no clipped copy of the gradient tree) and takes a leaf
above `CHUNKED_UPDATE_THRESHOLD` elements in slices of rows, so its fp32
temporaries cover one slice; every operation is elementwise and the
same as `update`'s, so both give the same bits.

Adafactor sees the reference's stacked leaves: the port holds each layer
of a `LAYER_STACKS` ModuleList as its own parameters (``blocks.3.…``),
the reference one ``[L, …]`` leaf a stack (``blocks.…``), and Adafactor
factors every leaf of two or more dimensions and clips its update by one
RMS a leaf, so a per-layer ``[d]`` norm scale is factored over (L, d)
there.  Its state is keyed by the stacked names, and its update gives
the stacked leaf's numbers without building the stack: a layer group
of 2-D or larger leaves goes a layer at a time, every statistic but the
RMS of the stack's update being that layer's own, and that RMS is summed
over the layers in a first pass (the reference's per-layer clip above
`CHUNKED_UPDATE_THRESHOLD` needs none).  Only groups of 1-D leaves (norm
scales, biases), small by nature, are stacked.  `update_` writes each
layer as it is done, so its fp32 temporaries cover one layer, or one
unstacked leaf whole, as the reference's do.  The caller passes the
grouping (``groups=``, {stacked name: [names in layer order]}, or a
name mapped to itself: what `repro_torch.nn.layers.stack_groups` gives
for a model's parameters); without it every leaf stands alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

Tree = dict  # {name: torch.Tensor}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------

def _sqnorms(leaves: list) -> list:
    """Each leaf's squared L2 norm in fp32: one fused reduction over all
    of them (`torch._foreach_norm`, fp32 accumulation; no fp32 copy of a
    16-bit leaf)."""
    if not leaves:
        return []
    return [n * n for n in torch._foreach_norm(leaves, 2,
                                               dtype=torch.float32)]


def _pieces(size: int, ranges) -> list:
    """[(start, stop, alike)] covering ``[0, size)``: the `ranges` held
    alike by every model rank, and the rest between them."""
    out, at = [], 0
    for lo, hi in sorted(ranges):
        if lo > at:
            out.append((at, lo, False))
        out.append((lo, hi, True))
        at = hi
    if at < size:
        out.append((at, size, False))
    return out


def global_norm(tree: Tree, *, group=None, shard_dims: dict | None = None,
                model=None, model_dims: dict | None = None,
                model_dup: dict | None = None) -> torch.Tensor:
    """L2 norm over a gradient tree, each leaf's squared norm taken in
    fp32.

    Under ZeRO-1 each leaf may be this data rank's *slice*: pass
    ``group`` (the data `Axis`) and ``shard_dims`` ({name: int}, -1 =
    replicated) and the squared sum of the sliced leaves is all-reduced
    over the group, while replicated leaves count once — so every rank
    computes the exact full norm.  ``model`` and ``model_dims`` do the
    same for the leaves split over the model axis (a leaf split over
    both is summed over both); ``model_dup`` ({name: (dim, [(start,
    stop)])}) the ranges of such a leaf that every model rank holds
    alike, counted once."""
    if group is None:
        shard_dims = None
    if model is None:
        model_dims = model_dup = None
    if shard_dims is None and model_dims is None:
        return torch.sqrt(sum(_sqnorms(list(tree.values()))))
    from repro_torch.distributed import collectives

    def cut(dims, k):
        return dims is not None and dims[k] >= 0

    items = []   # (tensor, sliced over data, split over model)
    for k, x in tree.items():
        d, m = cut(shard_dims, k), cut(model_dims, k)
        dup = (model_dup or {}).get(k) if m else None
        if dup is None:
            items.append((x, d, m))
            continue
        dim, ranges = dup
        for lo, hi, alike in _pieces(x.shape[dim], ranges):
            items.append((x.narrow(dim, lo, hi - lo), d, not alike))
    device = next(iter(tree.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    parts = {(d, m): sum(_sqnorms([
        x for x, xd, xm in items if xd == d and xm == m]), zero)
        for d in (False, True) for m in (False, True)}
    over_data = torch.stack([parts[True, False], parts[True, True]])
    if shard_dims is not None:
        over_data = collectives.all_reduce(over_data, group)
    over_model = torch.stack([parts[False, True], over_data[1]])
    if model_dims is not None:
        over_model = collectives.all_reduce(over_model, model)
    return torch.sqrt(parts[False, False] + over_data[0] + over_model[0]
                      + over_model[1])


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that clips a tree of global norm `norm` to
    `max_norm`."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float, *, group=None,
                        shard_dims: dict | None = None, model=None,
                        model_dims: dict | None = None,
                        model_dup: dict | None = None):
    norm = global_norm(tree, group=group, shard_dims=shard_dims,
                       model=model, model_dims=model_dims,
                       model_dup=model_dup)
    scale = clip_scale(norm, max_norm)
    # multiply in each leaf's own dtype, as the reference does
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

# A leaf larger than this (elements) is updated in place in slices of
# rows of at most UPDATE_SLICE elements: the fp32 temporaries of the
# update (about six of a slice's size) then cover one slice, not the
# leaf.  The reference's threshold (`_maybe_chunked` slices its stacked
# leaves per layer above it); the port's leaves are per layer already,
# so what it slices are the 389 M-element embedding and head of
# qwen1.5-4b and their like.
CHUNKED_UPDATE_THRESHOLD = 64 * 1024 * 1024
UPDATE_SLICE = 16 * 1024 * 1024


def _slices(*leaves):
    """Views of `leaves` over the same rows: the whole leaves when the
    first holds at most CHUNKED_UPDATE_THRESHOLD elements, else runs of
    rows of dim 0 of at most UPDATE_SLICE elements each."""
    lead = leaves[0]
    if lead.numel() <= CHUNKED_UPDATE_THRESHOLD or lead.ndim == 0:
        yield leaves
        return
    rows = max(1, UPDATE_SLICE // max(1, lead[0].numel()))
    for start in range(0, lead.shape[0], rows):
        yield tuple(x[start:start + rows] for x in leaves)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    m: Tree
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32
    max_grad_norm: float = 1.0

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=step.device)

    def init(self, params: Tree, groups: dict | None = None) -> AdamWState:
        """Zero moments shaped as `params` (``groups`` is Adafactor's and
        changes nothing here)."""
        del groups
        device = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=self.moment_dtype,
                                device=p.device) for k, p in params.items()}
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros,
                          {k: z.clone() for k, z in zeros.items()})

    def _terms(self, state: AdamWState) -> tuple:
        """(step, bias corrections 1 and 2, lr) of the next update."""
        step = state.step + 1
        bc1 = 1 - self.b1 ** step.to(torch.float32)
        bc2 = 1 - self.b2 ** step.to(torch.float32)
        return step, bc1, bc2, self._lr(step)

    def _upd(self, p, g, m, v, bc1, bc2, lr) -> tuple:
        """The reference's elementwise update of one leaf (or slice):
        (new p, new m, new v) as new tensors."""
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + self.eps)
        delta = delta + self.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return (new_p.to(p.dtype), m32.to(self.moment_dtype),
                v32.to(self.moment_dtype))

    def update(self, grads: Tree, state: AdamWState, params: Tree, *,
               group=None, shard_dims: dict | None = None, model=None,
               model_dims: dict | None = None, groups: dict | None = None,
               model_dup: dict | None = None
               ) -> tuple[Tree, AdamWState, dict]:
        """ZeRO-1: with ``group``/``shard_dims`` the inputs are this data
        rank's slices (and with ``model``/``model_dims`` this model
        rank's); AdamW's update is elementwise, so only the clipping
        norm needs the cross-rank correction."""
        del groups
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm,
                                           group=group,
                                           shard_dims=shard_dims,
                                           model=model,
                                           model_dims=model_dims,
                                           model_dup=model_dup)
        step, bc1, bc2, lr = self._terms(state)
        out = {k: self._upd(params[k], grads[k], state.m[k], state.v[k],
                            bc1, bc2, lr)
               for k in params}
        return ({k: o[0] for k, o in out.items()},
                AdamWState(step, {k: o[1] for k, o in out.items()},
                           {k: o[2] for k, o in out.items()}),
                {"grad_norm": gnorm, "learning_rate": lr})

    def update_(self, grads: Tree, state: AdamWState, params: Tree, *,
                group=None, shard_dims: dict | None = None, model=None,
                model_dims: dict | None = None, groups: dict | None = None,
                model_dup: dict | None = None
                ) -> tuple[Tree, AdamWState, dict]:
        """`update` written into `params` and the state's moments in
        place, leaf by leaf, a leaf above CHUNKED_UPDATE_THRESHOLD in
        slices of rows.  The clip scale comes from one fused norm and
        multiplies each slice of the gradient in its own dtype, as
        `clip_by_global_norm` does, so the bits are `update`'s.  Returns
        `params` and a state holding the same moment tensors."""
        del groups
        gnorm = global_norm(grads, group=group, shard_dims=shard_dims,
                            model=model, model_dims=model_dims,
                            model_dup=model_dup)
        scale = clip_scale(gnorm, self.max_grad_norm)
        step, bc1, bc2, lr = self._terms(state)
        with torch.no_grad():
            for k, p in params.items():
                for ps, gs, ms, vs in _slices(p, grads[k], state.m[k],
                                              state.v[k]):
                    new = self._upd(ps, gs * scale.to(gs.dtype), ms, vs,
                                    bc1, bc2, lr)
                    for dst, src in zip((ps, ms, vs), new):
                        dst.copy_(src)
        return (params, AdamWState(step, state.m, state.v),
                {"grad_norm": gnorm, "learning_rate": lr})

    def state_axes(self, param_axes: Tree,
                   groups: dict | None = None) -> AdamWState:
        """Optimizer-state logical axes mirror the parameters'."""
        del groups
        return AdamWState((), param_axes, param_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; for the >=100B archs)
# ---------------------------------------------------------------------------

def _refuse_dup(model, model_dup) -> None:
    if model is not None and model_dup:
        raise NotImplementedError(
            "Adafactor on leaves held alike by every model rank "
            f"({sorted(model_dup)}): its factored statistics would count "
            "them once a rank (ROADMAP.md queue 1)")


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Tree  # row second moment (or the full v of a leaf under 2-D)
    vc: Tree  # column second moment (or an unused zero)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    learning_rate: Callable | float = 1e-3
    decay: float = 0.8  # beta2 exponent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    # T5X-style: no global grad-norm clip — Adafactor's rms_u update clip
    # substitutes, and skipping it avoids full-gradient-tree fp32 temps.
    max_grad_norm: float | None = None

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=step.device)

    @staticmethod
    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(self, params: Tree, groups: dict | None = None
             ) -> AdafactorState:
        """Zero moments for the stacked view of `params` under `groups`
        (module docstring; without it every leaf stands alone)."""
        groups = _groups(params, groups)
        device = next(iter(params.values())).device
        vr, vc = {}, {}
        for key, names in groups.items():
            first = params[names if isinstance(names, str) else names[0]]
            shape = tuple(first.shape)
            if not isinstance(names, str):
                shape = (len(names),) + shape
            f32 = dict(dtype=torch.float32, device=first.device)
            if len(shape) >= 2:
                vr[key] = torch.zeros(shape[:-1], **f32)
                vc[key] = torch.zeros(shape[:-2] + shape[-1:], **f32)
            else:
                vr[key] = torch.zeros(shape, **f32)
                vc[key] = torch.zeros((), **f32)
        return AdafactorState(torch.zeros((), dtype=torch.int32,
                                          device=device), vr, vc)

    def update(self, grads: Tree, state: AdafactorState, params: Tree, *,
               group=None, shard_dims: dict | None = None, model=None,
               model_dims: dict | None = None, groups: dict | None = None,
               model_dup: dict | None = None
               ) -> tuple[Tree, AdafactorState, dict]:
        """ZeRO-1: with ``group``/``shard_dims`` ({name: dim of the
        port's tensor, -1 = replicated}; every layer of a stack on the
        same dim) the inputs are this data rank's slices, and with
        ``model``/``model_dims`` this model rank's.  Unlike AdamW the
        factored statistics are not elementwise — any mean that reduces
        over a sliced dimension (the column statistics and the RMS
        normalizers of a row-sliced 2-D leaf) is averaged over the axis
        it is sliced on, so every rank reproduces the replicated math.
        ``groups``: the layer grouping (`init`).  Ranges held alike by
        every model rank (``model_dup``) are refused: no config runs
        Adafactor on a Mamba2 layer."""
        _refuse_dup(model, model_dup)
        out: Tree = {}

        def put(name, index, value):
            if index is None:
                out[name] = value
            else:
                out.setdefault(name, torch.empty_like(params[name]))[
                    index] = value

        state, metrics = self._update(
            grads, state, params, put, dict(
                group=group, shard_dims=shard_dims, model=model,
                model_dims=model_dims), groups)
        return out, state, metrics

    def update_(self, grads: Tree, state: AdafactorState, params: Tree, *,
                group=None, shard_dims: dict | None = None, model=None,
                model_dims: dict | None = None, groups: dict | None = None,
                model_dup: dict | None = None
                ) -> tuple[Tree, AdafactorState, dict]:
        """`update`, each layer's new values written into `params` as
        soon as they are computed: no stack of a layer group is made
        (apart from the small ones of 1-D per-layer leaves), so the fp32
        temporaries cover one layer of a stack, or one unstacked leaf
        whole, as the reference's do."""
        _refuse_dup(model, model_dup)
        def put(name, index, value):
            target = params[name]
            (target if index is None else target[index]).copy_(value)

        state, metrics = self._update(
            grads, state, params, put, dict(
                group=group, shard_dims=shard_dims, model=model,
                model_dims=model_dims), groups)
        return params, state, metrics

    def _update(self, grads, state, params, put, mesh, groups):
        """The update, handed to ``put(name, index, value)`` a leaf (index
        None) or a leading slice of one at a time; returns (new state,
        metrics).  `mesh`: `update`'s ``group``, ``shard_dims``,
        ``model`` and ``model_dims``.  A stack of per-layer leaves of 2 or
        more dims is taken a layer at a time: every statistic of the
        stacked leaf but the RMS of its update is one layer's, and that
        RMS is summed over the layers first and the update made in a
        second pass, unless the reference clips the stack per layer
        (`_maybe_chunked`)."""
        with torch.no_grad():
            return self._run(grads, state, params, put, mesh,
                             _groups(params, groups))

    def _run(self, grads, state, params, put, mesh, groups):
        # the axes the leaves are sliced over: ((axis, {name: dim}), ...)
        sliced = tuple((axis, dims) for axis, dims in (
            (mesh["group"], mesh["shard_dims"]),
            (mesh["model"], mesh["model_dims"]))
            if axis is not None and dims is not None)
        if self.max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm,
                                               **mesh)
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.step.device)
        step = state.step + 1
        beta2 = 1.0 - step.to(torch.float32) ** (-self.decay)
        lr = self._lr(step)
        f32 = torch.float32
        if sliced:
            from repro_torch.distributed import collectives

        # cuts: ((axis, dim), ...), the dims of this leaf sliced over each
        # axis (slices are equal-sized, so the mean of means is the mean)
        def corr(x, cuts, over_dim):
            for axis, dim in cuts:
                if dim == over_dim:
                    x = collectives.all_reduce(x, axis) / axis.size
            return x

        def moments(g32, vr, vc, ndim, cuts):
            g2 = torch.square(g32) + self.eps
            if ndim >= 2:
                return (beta2 * vr + (1 - beta2) * corr(
                            g2.mean(dim=-1), cuts, ndim - 1),
                        beta2 * vc + (1 - beta2) * corr(
                            g2.mean(dim=-2), cuts, ndim - 2))
            return beta2 * vr + (1 - beta2) * g2, vc

        def direction(g32, vr_n, vc_n, ndim, cuts):
            if ndim >= 2:
                rbar = corr(vr_n.mean(dim=-1, keepdim=True), cuts, ndim - 2)
                denom = (vr_n / torch.clamp(rbar, min=self.eps))[..., None] \
                    * vc_n[..., None, :]
                return g32 * torch.rsqrt(denom + self.eps)
            return g32 * torch.rsqrt(vr_n + self.eps)

        def apply(p, u, msq, cuts):
            for axis, _ in cuts:
                msq = collectives.all_reduce(msq, axis) / axis.size
            rms_u = torch.sqrt(msq + 1e-12)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            new_p = (p.to(f32) - lr * (u + self.weight_decay * p.to(f32)))
            return new_p.to(p.dtype)

        def whole(p, g, vr, vc, cuts=()):
            g32 = g.to(f32)
            vr_n, vc_n = moments(g32, vr, vc, p.ndim, cuts)
            u = direction(g32, vr_n, vc_n, p.ndim, cuts)
            return apply(p, u, torch.mean(torch.square(u)), cuts), \
                vr_n, vc_n

        def by_slice(ps, gs, vr, vc, targets, cuts, per_slice):
            # ps[i], gs[i]: the stacked leaf's slice i, of >= 2 dims
            vr_n, vc_n = torch.empty_like(vr), torch.empty_like(vc)
            total = torch.zeros((), dtype=f32, device=vr.device)
            for i, (p, g) in enumerate(zip(ps, gs)):
                g32 = g.to(f32)
                vr_n[i], vc_n[i] = moments(g32, vr[i], vc[i], p.ndim, cuts)
                u = direction(g32, vr_n[i], vc_n[i], p.ndim, cuts)
                if per_slice:
                    put(*targets[i], apply(p, u, torch.mean(torch.square(u)),
                                           ()))
                else:
                    total += torch.sum(torch.square(u))
            if not per_slice:
                msq = total / sum(p.numel() for p in ps)
                for i, (p, g) in enumerate(zip(ps, gs)):
                    u = direction(g.to(f32), vr_n[i], vc_n[i], p.ndim, cuts)
                    put(*targets[i], apply(p, u, msq, cuts))
            return vr_n, vc_n

        vr, vc = {}, {}
        for key, names in groups.items():
            members = [names] if isinstance(names, str) else names
            cuts = []
            for axis, dims in sliced:
                at = {dims[n] for n in members}
                if len(at) != 1:
                    raise ValueError(f"{key}: layers sliced on dims {at} "
                                     f"over {axis.name!r}")
                dim = at.pop()
                if dim >= 0:
                    cuts.append((axis, dim))
            ps = [params[n] for n in members]
            gs = [grads[n] for n in members]
            numel = sum(p.numel() for p in ps)
            args = (state.vr[key], state.vc[key])
            if isinstance(names, str):
                p = ps[0]
                if cuts or p.ndim < 3 or numel <= CHUNKED_UPDATE_THRESHOLD:
                    new, vr[key], vc[key] = whole(p, gs[0], *args, cuts)
                    put(names, None, new)
                else:  # the reference's `_maybe_chunked`
                    vr[key], vc[key] = by_slice(
                        p.unbind(0), gs[0].unbind(0), *args,
                        [(names, i) for i in range(len(p))], (), True)
            elif ps[0].ndim >= 2:
                vr[key], vc[key] = by_slice(
                    ps, gs, *args, [(n, None) for n in names], cuts,
                    not cuts and numel > CHUNKED_UPDATE_THRESHOLD)
            else:  # [L, ...] of small leaves: stacked, as the reference
                new, vr[key], vc[key] = whole(
                    torch.stack(ps), torch.stack(gs), *args,
                    [(axis, dim + 1) for axis, dim in cuts])
                for n, v in zip(names, new.unbind(0)):
                    put(n, None, v)
        return (AdafactorState(step, vr, vc),
                {"grad_norm": gnorm, "learning_rate": lr})

    def state_axes(self, param_axes: Tree,
                   groups: dict | None = None) -> AdafactorState:
        """The state's logical axes from the stacked parameters' (a
        {stacked name: axes tuple} tree), or with ``groups`` from the
        per-layer parameters' ({name: axes}; a stack leads with
        "layers", as the reference's stacked leaves do)."""
        if groups is not None:
            param_axes = {
                k: (param_axes[names] if isinstance(names, str)
                    else ("layers",) + tuple(param_axes[names[0]]))
                for k, names in groups.items()}

        def vr_ax(ax):
            return tuple(ax[:-1]) if len(ax) >= 2 else tuple(ax)

        def vc_ax(ax):
            return tuple(ax[:-2]) + tuple(ax[-1:]) if len(ax) >= 2 else ()

        return AdafactorState((), {k: vr_ax(a) for k, a in param_axes.items()},
                              {k: vc_ax(a) for k, a in param_axes.items()})


def _groups(params: Tree, groups: dict | None) -> dict:
    """The layer grouping to use: `groups`, or every leaf alone."""
    return groups if groups is not None else {k: k for k in params}


def make_optimizer(kind: str, lr, *, total_steps: int = 10000,
                   warmup: int = 200, moment_dtype=torch.float32,
                   weight_decay: float = 0.1):
    sched = warmup_cosine(lr, warmup, total_steps)
    if kind == "adamw":
        return AdamW(learning_rate=sched, moment_dtype=moment_dtype,
                     weight_decay=weight_decay)
    if kind == "adafactor":
        return Adafactor(learning_rate=sched, weight_decay=weight_decay)
    raise ValueError(kind)
