"""Gradient compression with error feedback (counterpart of
`repro.distributed.compression`).

int8 quantization of each gradient leaf — one scale a leaf, its largest
magnitude over 127 — with an fp32 residual carried between steps (error
feedback keeps SGD convergence; Karimireddy et al. 2019).  The train
step applies it to the gradient it hands the optimizer, as the
reference's does (`repro/train/train_loop.py:169-170`): on the mesh that
is the gradient already summed over the data replicas, so the codes
change what the optimizer sees, not the bytes the step's collectives
move.  `torch.round`, like `jnp.round`, rounds half to even.

The port holds a layer list's parameters one leaf a layer where the
reference stacks them into one ``[L, ...]`` leaf; the train steps pass
``max_over`` = `stacked_max` of the model's layer groups, so a layer's
scale is its stack's, as the reference's.

On the mesh (`MeshTrainStep`) a rank holds a slice of each leaf (cut
over "model", over "data", or both), or the whole leaf.  The reference's
scale is the whole leaf's maximum, which GSPMD takes across the shards;
here the compressors take ``max_over``: a callable that turns each
leaf's maximum of ``|x|`` over this rank's slice into the whole leaf's
(`MeshTrainStep.whole_max`, at most two `all_max` calls; the stack's
maximum taken first), and they code
the rank's own slice with that scale, so every rank's codes are its
slice of the whole leaf's.  Without it (one device) the maximum is the
slice's, which is then the whole leaf.

Usage:
    comp = ErrorFeedbackCompressor()
    train_step = make_train_step(..., grad_compression=comp.bind())
or in stateless mode (no residual): `compress_int8_stateless`.  The
bound compressor sizes its residual from the first gradient it sees:
on the mesh that is the rank's slice after the step's reduction (under
ZeRO-1 a "data" slice of a leaf whose parameter the rank holds whole),
which ``comp.init(params)`` would not give.  ``comp.bind(state)``
starts from a given residual; a residual of another shape than its
gradient raises.  Trees are dicts ``{name: tensor}``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tree = dict  # {name: torch.Tensor}
# {name: max |x| over this rank's slice} -> {name: the whole leaf's}
MaxOver = Callable[[dict], dict]


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale) of an fp32 tensor: codes
    ``clip(round(x / scale), -127, 127)`` with ``scale = max(max |x|,
    1e-12) / 127``.  ``amax``: the whole leaf's ``max |x|`` where `x` is
    a rank's slice of it (module docstring)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    amax = torch.clamp(amax, min=1e-12)
    # divide by a tensor: on CUDA a Python-number divisor becomes a
    # multiplication by its reciprocal, which can round the scale (and
    # then a code) differently from the reference's division
    scale = amax / torch.full((), 127.0, dtype=amax.dtype,
                              device=amax.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def stacked_max(amax: dict, groups: dict) -> dict:
    """{name: max} with each layer's maximum replaced by its stack's
    (``groups``: `repro_torch.nn.layers.stack_groups`): the reference
    stacks a layer list into one ``[L, ...]`` leaf, whose one scale is
    the maximum over every layer."""
    out = dict(amax)
    for members in groups.values():
        if isinstance(members, str) or len(members) < 2:
            continue
        top = torch.max(torch.stack([amax[k] for k in members]))
        out.update((k, top) for k in members)
    return out


def _whole_amax(xs: Tree, max_over: MaxOver | None) -> dict:
    """{name: max |x|} of each fp32 leaf, over the whole leaf through
    `max_over` where the leaves are slices."""
    amax = {k: torch.max(torch.abs(x)) for k, x in xs.items()}
    return amax if max_over is None else max_over(amax)


def compress_int8_stateless(grads: Tree, *,
                            max_over: MaxOver | None = None) -> Tree:
    """Quantize, then dequantize, each leaf (int8 on the wire,
    simulated); ``max_over`` as in the module docstring."""
    xs = {k: g.to(torch.float32) for k, g in grads.items()}
    amax = _whole_amax(xs, max_over)
    return {k: _dequantize(*quantize_int8(xs[k], amax[k]), g.dtype)
            for k, g in grads.items()}


class EFState(NamedTuple):
    residual: Tree


class ErrorFeedbackCompressor:
    """int8 + error feedback; the residual accumulates the quantization
    error."""

    def init(self, params: Tree) -> EFState:
        return EFState({k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()})

    def compress(self, grads: Tree, state: EFState, *,
                 max_over: MaxOver | None = None) -> tuple[Tree, EFState]:
        """The dequantized codes of ``grads + residual`` and the new
        residual (``max_over`` as in the module docstring)."""
        xs = {}
        for k, g in grads.items():
            r = state.residual[k]
            if r.shape != g.shape:
                raise ValueError(
                    f"compress: the residual of {k!r} is {tuple(r.shape)}, "
                    f"its gradient {tuple(g.shape)} (on the mesh the "
                    "residual is the rank's gradient slice: bind() sizes "
                    "it from the first gradient)")
            xs[k] = g.to(torch.float32) + r
        amax = _whole_amax(xs, max_over)
        new_g, new_r = {}, {}
        for k, g in grads.items():
            x = xs[k]
            q, s = quantize_int8(x, amax[k])
            deq = q.to(torch.float32) * s
            new_g[k], new_r[k] = deq.to(g.dtype), x - deq
        return new_g, EFState(new_r)

    def bind(self, state: EFState | None = None) -> "BoundCompressor":
        """A ``grads -> grads`` callable for `make_train_step`'s
        ``grad_compression`` that carries the residual from call to call
        (the usage the reference's module docstring gives); without a
        `state` the residual starts at zero, shaped as the first
        gradient it compresses."""
        return BoundCompressor(self, state)


class BoundCompressor:
    """`ErrorFeedbackCompressor.compress` with its state held here:
    ``state`` is the residual after the latest call (None before the
    first call of an unsized one)."""

    def __init__(self, compressor: ErrorFeedbackCompressor,
                 state: EFState | None):
        self.compressor = compressor
        self.state = state

    def __call__(self, grads: Tree, *,
                 max_over: MaxOver | None = None) -> Tree:
        if self.state is None:
            self.state = self.compressor.init(grads)
        out, self.state = self.compressor.compress(grads, self.state,
                                                   max_over=max_over)
        return out


def takes_max_over(fn) -> bool:
    """Whether `fn` is one of this module's compressors, which code a
    rank's slices with the whole leaf's scale given ``max_over``; any
    other ``grads -> grads`` callable sees the slices as they are."""
    return fn is compress_int8_stateless or isinstance(fn, BoundCompressor)
