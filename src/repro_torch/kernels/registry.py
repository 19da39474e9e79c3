"""Kernel registry and eligibility (counterpart of
`repro.kernels.dispatch`).

Every segment-shaped reduction in `repro_torch.core.ops` and the fused
edge convolution in `repro_torch.core.convolutions` route through here,
which decides per call whether a hand-written CUDA kernel or the plain
PyTorch version runs, and says why (`Decision.reason`, surfaced by
`GraphUpdate.describe_dispatch`).

Eligibility on Hopper is the tensor's device alone: a CUDA tensor runs a
kernel, at any width and row count, and a CPU tensor takes the plain
version (that is how the CPU tests run).  On the card nothing falls back:
what a kernel does not take (a non-float dtype, a count beyond int32)
raises in its wrapper.  The reference's TPU VMEM model (segment caps,
width caps, edge-block sizing) has no counterpart, since the GPU kernels
accumulate in device memory with atomics.  `plain_versions()` routes the
calling thread to the plain versions, for comparisons on the card.

Within the kernel path the layout picks the variant, as the reference's
dispatch does: ids that arrive sorted (``sorted_ids=True``, or ``None``
inside ``layout(sorted_by_target=True)``, which the Trainer enters from
the batches' layout bit) run the CSR-run kernel (`segment_pool_runs`,
`edge_mpnn_runs`), any other order the any-order kernel of the first
slice.  The hint is performance-only: every kernel is correct for any
order.  Unlike the reference's trace-time global, `layout` and
`plain_versions` are read per call and per thread, so a server's engine
thread keeps the unsorted kernels while a training loop holds the hint.

Under ``use_autotune(True)`` (or ``REPRO_AUTOTUNE=1`` at import; off by
default, as the reference's dispatch, `kernels/dispatch.py:177-190`), a
decision that has its shape (`segment_reduce_decision`'s `n_segments`,
`edge_mpnn_decision`'s `h_tgt`, `w` and `n_edges`) first looks up the
exact key in `kernels/autotune`'s records, after eligibility and before
the layout rule: a record names a kernel and its tile
(``autotuned:<kernel>/<tile>[<layout>]``).  A record naming an unknown
kernel, a tile that is not built, or the any-order kernel on a sorted
key is ignored (the counterpart of the reference's re-validation,
`dispatch.py:492-500`).  The lookup is a memoized dict read with no host
sync, so a CUDA graph captures the tuned launch.

Under ``partitioned(data=n, model=m)`` (`MeshPlan.dispatch_context`, the
reference's trace-time context for steps that see global shapes,
`kernels/dispatch.py:95-138`) an autotune key counts one shard's work:
rows and segments ceil-divided by `n`, a pooled width by `m`
(`_per_shard`, `_per_shard_feature`).  Eligibility reads no shape on
Hopper, so the key is all the context moves.  Like `layout`, it is per
thread.

Every kernel call on the card goes through a `torch.autograd.Function`
(`SegmentPoolFunction`, `EdgeMpnnFunction`, `FlashAttentionFunction`)
whose backward is the plain version's gradient, recomputed from the
saved inputs — the counterpart of the reference's custom VJPs
(`kernels/dispatch.py:391-440,697-713`).  Serving takes the same route
under `torch.inference_mode()`.

`graph_attention` runs one node set as a single segment-masked
flash-attention sequence (the `GraphSelfAttention` conv).  It has no row
cap (the reference's 4096-row cap is a VMEM limit) and needs no sentinel
padding (the kernel masks its own ragged tiles).

Contract shared by kernels and plain versions: ids outside
``[0, n_segments)`` mark padding rows, and empty segments yield 0 for
every reduction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Callable

import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels.edge_mpnn import kernel as _mpnn_kernel
from repro_torch.kernels.edge_mpnn.ref import ACTIVATIONS, edge_mpnn_ref
from repro_torch.kernels.flash_attention import kernel as _flash_kernel
from repro_torch.kernels.flash_attention.ref import segment_attention_ref
from repro_torch.kernels.segment_pool import kernel as _seg_kernel
from repro_torch.kernels.segment_pool.ref import segment_pool_ref

_THREAD = threading.local()


@contextlib.contextmanager
def plain_versions():
    """Within this block, the calling thread's decisions pick the plain
    PyTorch versions (other threads, such as a server's engine, keep the
    kernels)."""
    prev = getattr(_THREAD, "plain", False)
    _THREAD.plain = True
    try:
        yield
    finally:
        _THREAD.plain = prev


@contextlib.contextmanager
def layout(sorted_by_target: bool = True):
    """Within this block, the calling thread's TARGET-keyed reductions
    report their ids as sorted (``sorted_ids=None`` reads this), so the
    kernel path picks the CSR-run variants.  Other threads keep their
    own hint (default: unsorted)."""
    prev = layout_sorted_by_target()
    _THREAD.sorted_by_target = bool(sorted_by_target)
    try:
        yield
    finally:
        _THREAD.sorted_by_target = prev


def layout_sorted_by_target() -> bool:
    return getattr(_THREAD, "sorted_by_target", False)


@contextlib.contextmanager
def partitioned(data: int = 1, model: int = 1):
    """Within this block, the calling thread's decisions count one
    shard's work in their autotune keys: rows and segments over `data`
    shards, pooled widths over `model` shards (the 2-D ("data",
    "model") mesh); the previous counts come back after."""
    prev = (data_shards(), model_shards())
    _THREAD.shards = (max(int(data), 1), max(int(model), 1))
    try:
        yield
    finally:
        _THREAD.shards = prev


def data_parallel(num_shards: int):
    """`partitioned` over the data axis alone."""
    return partitioned(data=num_shards)


def data_shards() -> int:
    return getattr(_THREAD, "shards", (1, 1))[0]


def model_shards() -> int:
    return getattr(_THREAD, "shards", (1, 1))[1]


def _per_shard(n: int) -> int:
    """A leading count split over the data shards (ceil: the largest
    shard decides)."""
    return -(-int(n) // data_shards())


def _per_shard_feature(d: int) -> int:
    """A feature width split over the model shards (ceil)."""
    return -(-int(d) // model_shards())


_AUTOTUNE = os.environ.get("REPRO_AUTOTUNE", "0") == "1"


def use_autotune(on: bool) -> None:
    """Let decisions consult the autotune records.  Off by default so
    test and training dispatch stays independent of whatever records the
    checkout happens to hold."""
    global _AUTOTUNE
    _AUTOTUNE = bool(on)


def autotune_enabled() -> bool:
    return _AUTOTUNE


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of an eligibility check: which path runs and why.
    `kernel` names the kernel that runs ("" for the plain version), at
    tile height `tile` (0: the kernel's default)."""
    use_kernel: bool
    reason: str
    kernel: str = ""
    tile: int = 0


def _no_tiles(library, dtype, width) -> tuple:
    return ()


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str
    kernels: dict        # {kernel name: wrapper}: any-order and run variant
    reference: Callable  # plain PyTorch version, identical contract
    decide: Callable     # (...) -> Decision
    # (kernel name, dtype, width) -> the tile heights built besides 0
    tiles: Callable = _no_tiles


_REGISTRY: dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> None:
    _REGISTRY[entry.name] = entry


def registry() -> dict[str, KernelEntry]:
    return dict(_REGISTRY)


def _plain_reason(t: torch.Tensor) -> str | None:
    """Why the plain version runs for `t` (None: a kernel runs): the one
    eligibility rule every kernel family shares."""
    if getattr(_THREAD, "plain", False):
        return "plain versions requested"
    if not t.is_cuda:
        return f"{t.device.type} tensor: plain version"
    return None


def _layout(sorted_ids: bool | None) -> str:
    if sorted_ids is None:
        sorted_ids = layout_sorted_by_target()
    return "sorted" if sorted_ids else "unsorted"


def _by_layout(name: str, layout: str) -> Decision:
    """The layout rule on the card: `name`_runs on sorted ids, `name`
    otherwise."""
    if layout == "sorted":
        return Decision(True, f"kernel:{name}_runs[sorted]", f"{name}_runs")
    return Decision(True, f"kernel:{name}[unsorted]", name)


def _autotuned(name: str, key: str, layout: str, dtype: torch.dtype,
               width: int) -> Decision | None:
    """The decision of family `name`'s record under `key`, or None when
    there is none or it names what cannot run here: an unknown kernel, a
    tile that is not built, or the any-order kernel on a sorted key (the
    run kernels alone are bit-repeatable there)."""
    rec = _autotune.lookup(key)
    if rec is None:
        return None
    entry = _REGISTRY[name]
    kernel, tile = rec.get("variant"), rec.get("tile", 0)
    if (kernel not in entry.kernels or (layout == "sorted" and kernel == name)
            or type(tile) is not int
            or (tile and tile not in entry.tiles(kernel, dtype, width))):
        return None
    return Decision(True, f"autotuned:{kernel}/{tile}[{layout}]", kernel,
                    tile)


# ---------------------------------------------------------------------------
# Autograd: the kernels have no backward of their own.  As in the
# reference, the forward runs the kernel and the backward is the plain
# version's gradient, recomputed from the saved inputs (one plain forward
# on the backward pass, no kernel launch).
# ---------------------------------------------------------------------------

class SegmentPoolFunction(torch.autograd.Function):
    """``apply(values [E, D], seg_ids [E] int32, n_segments, reduce,
    kernel[, tile])``: `kernel` (a wrapper of `segment_pool.kernel`, at
    tile height `tile`) forward, `segment_pool_ref`'s gradient backward.
    Differentiable in `values` only."""

    @staticmethod
    def forward(ctx, values, seg_ids, n_segments, reduce, kernel, tile=0):
        ctx.save_for_backward(values, seg_ids)
        ctx.n_segments, ctx.reduce = n_segments, reduce
        return kernel(values, seg_ids, n_segments=n_segments, reduce=reduce,
                      tile=tile)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        values, seg_ids = ctx.saved_tensors
        with torch.enable_grad():
            v = values.detach().requires_grad_(True)
            out = segment_pool_ref(v, seg_ids, n_segments=ctx.n_segments,
                                   reduce=ctx.reduce)
            (g,) = torch.autograd.grad(out, v, grad)
        return g, None, None, None, None, None


class EdgeMpnnFunction(torch.autograd.Function):
    """``apply(h_src, h_tgt, w, b, src, tgt, n_src, n_tgt, activation,
    kernel[, tile])``: `kernel` (a wrapper of `edge_mpnn.kernel`, at tile
    height `tile`) forward, `edge_mpnn_ref`'s gradient backward.
    Differentiable in h_src, h_tgt, w and b."""

    @staticmethod
    def forward(ctx, h_src, h_tgt, w, b, src, tgt, n_src, n_tgt, activation,
                kernel, tile=0):
        ctx.save_for_backward(h_src, h_tgt, w, b, src, tgt)
        ctx.n_src, ctx.n_tgt, ctx.activation = n_src, n_tgt, activation
        return kernel(h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt,
                      activation=activation, tile=tile)

    @staticmethod
    def backward(ctx, grad):
        h_src, h_tgt, w, b, src, tgt = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        grads = [None] * 4
        if any(needs):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(need)
                      for x, need in zip((h_src, h_tgt, w, b), needs)]
                out = edge_mpnn_ref(xs[0], xs[1], src, tgt, xs[2], xs[3],
                                    n_src=ctx.n_src, n_tgt=ctx.n_tgt,
                                    activation=ctx.activation)
                wanted = [i for i in range(4) if needs[i]]
                got = torch.autograd.grad(out, [xs[i] for i in wanted],
                                          grad, allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g if g is not None else torch.zeros_like(xs[i])
        return (*grads, None, None, None, None, None, None, None)


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v [N, H, D], segments [N] int32, kernel)``: `kernel`
    (`flash_attention.kernel.flash_attention`) forward over the node set
    as one segment-masked sequence, `segment_attention_ref`'s gradient
    backward (the reference's custom VJP, `dispatch.py:697-713`; the TPU
    kernel has no backward kernel either).  Differentiable in q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, segments, kernel):
        ctx.save_for_backward(q, k, v, segments)
        seg = segments[None]
        return kernel(q[None], k[None], v[None], seg, seg, causal=False)[0]

    @staticmethod
    def backward(ctx, grad):
        q, k, v, segments = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        grads = [None] * 3
        if any(needs):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(need)
                      for x, need in zip((q, k, v), needs)]
                out = segment_attention_ref(*xs, segments)
                wanted = [i for i in range(3) if needs[i]]
                got = torch.autograd.grad(out, [xs[i] for i in wanted], grad)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (*grads, None, None)


# ---------------------------------------------------------------------------
# segment_reduce: sum / mean / max / min over segments
# ---------------------------------------------------------------------------

def segment_reduce_decision(values: torch.Tensor,
                            sorted_ids: bool | None = None, *,
                            n_segments: int | None = None,
                            reduce: str = "sum") -> Decision:
    """A kernel on a CUDA tensor, the plain version anywhere else; with
    `n_segments` given, an autotune record of the exact shape first."""
    reason = _plain_reason(values)
    if reason is not None:
        return Decision(False, reason)
    layout = _layout(sorted_ids)
    if _AUTOTUNE and n_segments is not None:
        width = math.prod(values.shape[1:])
        tuned = _autotuned("segment_pool", _autotune.pool_key(
            n=_per_shard(n_segments), d=_per_shard_feature(width),
            dtype=values.dtype, reduce=reduce, layout=layout,
            e=_per_shard(values.shape[0]),
            sm=_autotune.device_sm(values.device)), layout, values.dtype,
            width)
        if tuned is not None:
            return tuned
    return _by_layout("segment_pool", layout)


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   n_segments: int, reduce: str = "sum", *,
                   sorted_ids: bool | None = None) -> torch.Tensor:
    """Route one segment reduction to a CUDA kernel or the plain
    version.  values [E, ...]; seg_ids [E] with ids outside
    [0, n_segments) marking padding rows.  Returns [n_segments, ...];
    empty segments yield 0; mean divides by max(count, 1) in fp32.
    sorted_ids hints that seg_ids arrive non-decreasing (performance
    only; None reads the calling thread's `layout()`)."""
    if reduce == "mean":
        total = segment_reduce(values, seg_ids, n_segments, "sum",
                               sorted_ids=sorted_ids)
        cnt = segment_count(seg_ids, n_segments)
        cnt = cnt.reshape(cnt.shape + (1,) * (values.ndim - 1))
        out_dtype = (total.dtype if total.is_floating_point()
                     else torch.float32)
        # divide in fp32: a bf16 count would saturate at 256
        return (total.to(torch.float32)
                / torch.clamp(cnt, min=1)).to(out_dtype)
    entry = _REGISTRY["segment_pool"]
    dec = entry.decide(values, sorted_ids, n_segments=n_segments,
                       reduce=reduce)
    if not dec.use_kernel:
        return entry.reference(values, seg_ids, n_segments=n_segments,
                               reduce=reduce)
    flat = values.reshape(values.shape[0],
                          math.prod(values.shape[1:])).contiguous()
    out = SegmentPoolFunction.apply(flat, kernel_ids(seg_ids), n_segments,
                                    reduce, entry.kernels[dec.kernel],
                                    dec.tile)
    return out.reshape((n_segments,) + values.shape[1:])


def segment_count(seg_ids: torch.Tensor, n_segments: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rows per segment (ids outside [0, n_segments) excluded), counted
    exactly in int64 and returned in `dtype`.  A fixed-size `index_add_`
    into n_segments + 1 slots, padding ids into the spare last one:
    `bincount` would read the ids' max back to the host to size its
    output, and so stall the host on every mean pool and degree."""
    ids = seg_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_segments)
    counts = torch.zeros(n_segments + 1, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, torch.where(valid, ids, n_segments),
                      torch.ones_like(ids))
    return counts[:n_segments].to(dtype)


def kernel_ids(ids: torch.Tensor) -> torch.Tensor:
    """Index vector in the kernels' layout: contiguous int32 (the model
    keeps int64 ids, torch's index type)."""
    return ids.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# edge_mpnn: fused gather -> per-edge MLP message -> segment-sum
# ---------------------------------------------------------------------------

def edge_mpnn_decision(h_src: torch.Tensor, activation: str = "relu",
                       sorted_ids: bool | None = None, *,
                       h_tgt: torch.Tensor | None = None,
                       w: torch.Tensor | None = None,
                       n_edges: int | None = None) -> Decision:
    """A kernel on a CUDA tensor, the plain version anywhere else; with
    `h_tgt`, `w` and `n_edges` given, an autotune record of the exact
    shape first."""
    if activation not in ACTIVATIONS:
        return Decision(False, f"unsupported activation {activation!r}")
    reason = _plain_reason(h_src)
    if reason is not None:
        return Decision(False, reason)
    layout = _layout(sorted_ids)
    if _AUTOTUNE and not (h_tgt is None or w is None or n_edges is None):
        tuned = _autotuned("edge_mpnn", _autotune.edge_key(
            n_src=_per_shard(h_src.shape[0]),
            n_tgt=_per_shard(h_tgt.shape[0]), ds=h_src.shape[1],
            dt=h_tgt.shape[1], m=w.shape[1], dtype=h_src.dtype,
            activation=activation, layout=layout, e=_per_shard(n_edges),
            sm=_autotune.device_sm(h_src.device)), layout, h_src.dtype,
            w.shape[1])
        if tuned is not None:
            return tuned
    return _by_layout("edge_mpnn", layout)


def edge_mpnn(h_src, h_tgt, src, tgt, w, b, *, n_src: int, n_tgt: int,
              activation: str = "relu",
              sorted_ids: bool | None = None) -> torch.Tensor:
    """Fused edge convolution (or its plain version on the CPU).

    h_src [n_src, Ds]; h_tgt [n_tgt, Dt]; src/tgt [E] with padding edges
    carrying tgt >= n_tgt; w [Ds+Dt, M]; b [M].  Returns [n_tgt, M].
    sorted_ids hints that tgt arrives non-decreasing (performance only;
    None reads the calling thread's `layout()`)."""
    entry = _REGISTRY["edge_mpnn"]
    dec = entry.decide(h_src, activation, sorted_ids, h_tgt=h_tgt, w=w,
                       n_edges=src.shape[0])
    if not dec.use_kernel:
        return entry.reference(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                               n_tgt=n_tgt, activation=activation)
    return EdgeMpnnFunction.apply(
        h_src.contiguous(), h_tgt.contiguous(), w.contiguous(),
        b.contiguous(), kernel_ids(src), kernel_ids(tgt), n_src, n_tgt,
        activation, entry.kernels[dec.kernel], dec.tile)


# ---------------------------------------------------------------------------
# graph_attention: within-component multi-head attention over a node set
# ---------------------------------------------------------------------------

def graph_attention_decision(q: torch.Tensor) -> Decision:
    """The flash kernel on a CUDA tensor (at any row count; what it does
    not take, a head width past 256 or a non-float dtype, raises in its
    wrapper), the plain version anywhere else."""
    reason = _plain_reason(q)
    if reason is not None:
        return Decision(False, reason)
    return Decision(True, "kernel:flash_attention[segments]",
                    "flash_attention")


def graph_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segments: torch.Tensor) -> torch.Tensor:
    """Within-component softmax attention (or its plain version).

    q/k/v: [N, H, D]; segments: [N] component ids, padding rows carrying
    the one-past-last id (`component_ids()` gives this), so they attend
    among themselves and downstream masks drop them.  Returns [N, H, D];
    a row attends exactly to the rows of its own component."""
    entry = _REGISTRY["graph_attention"]
    dec = entry.decide(q)
    if not dec.use_kernel:
        return entry.reference(q, k, v, segments)
    return FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kernel_ids(segments),
        entry.kernels[dec.kernel])


register(KernelEntry(
    "segment_pool",
    {"segment_pool": _seg_kernel.segment_pool,
     "segment_pool_runs": _seg_kernel.segment_pool_runs},
    segment_pool_ref, segment_reduce_decision, _seg_kernel.tiles))
register(KernelEntry(
    "edge_mpnn",
    {"edge_mpnn": _mpnn_kernel.edge_mpnn,
     "edge_mpnn_runs": _mpnn_kernel.edge_mpnn_runs},
    edge_mpnn_ref, edge_mpnn_decision, _mpnn_kernel.tiles))
register(KernelEntry(
    "graph_attention",
    {"flash_attention": _flash_kernel.flash_attention},
    segment_attention_ref, graph_attention_decision))
