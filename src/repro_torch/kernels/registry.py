"""Kernel registry and eligibility (counterpart of
`repro.kernels.dispatch`).

Every segment-shaped reduction in `repro_torch.core.ops` and the fused
edge convolution in `repro_torch.core.convolutions` route through here,
which decides per call whether the hand-written CUDA kernel or the plain
PyTorch version runs, and says why (`Decision.reason`, surfaced by
`GraphUpdate.describe_dispatch`).

Eligibility on Hopper is the tensor's device alone: a CUDA tensor runs
the kernel, at any width and row count, and a CPU tensor takes the plain
version (that is how the CPU tests run).  On the card nothing falls back:
what a kernel does not take (a non-float dtype, a count beyond int32)
raises in its wrapper.  The reference's TPU VMEM model (segment caps,
width caps, edge-block sizing) has no counterpart, since the GPU kernels
accumulate in device memory with atomics.  `plain_versions()` routes the
calling thread to the plain versions, for comparisons on the card.

Contract shared by kernels and plain versions: ids outside
``[0, n_segments)`` mark padding rows, and empty segments yield 0 for
every reduction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.kernels.edge_mpnn import kernel as _mpnn_kernel
from repro_torch.kernels.edge_mpnn.ref import ACTIVATIONS, edge_mpnn_ref
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


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of an eligibility check: which path runs and why."""
    use_kernel: bool
    reason: str


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str
    kernel: Callable     # wrapper of the CUDA kernel
    reference: Callable  # plain PyTorch version, identical contract
    decide: Callable     # (...) -> Decision


_REGISTRY: dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> None:
    _REGISTRY[entry.name] = entry


def registry() -> dict[str, KernelEntry]:
    return dict(_REGISTRY)


def _on_device(t: torch.Tensor, name: str) -> Decision:
    """The one eligibility rule both kernels share: kernel `name` on a
    CUDA tensor, the plain version anywhere else."""
    if getattr(_THREAD, "plain", False):
        return Decision(False, "plain versions requested")
    if not t.is_cuda:
        return Decision(False, f"{t.device.type} tensor: plain version")
    return Decision(True, f"kernel:{name}")


# ---------------------------------------------------------------------------
# segment_reduce: sum / mean / max / min over segments
# ---------------------------------------------------------------------------

def segment_reduce_decision(values: torch.Tensor) -> Decision:
    return _on_device(values, "segment_pool")


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   n_segments: int, reduce: str = "sum") -> torch.Tensor:
    """Route one segment reduction to the CUDA kernel or the plain
    version.  values [E, ...]; seg_ids [E] with ids outside
    [0, n_segments) marking padding rows.  Returns [n_segments, ...];
    empty segments yield 0; mean divides by max(count, 1) in fp32."""
    if reduce == "mean":
        total = segment_reduce(values, seg_ids, n_segments, "sum")
        cnt = segment_count(seg_ids, n_segments)
        cnt = cnt.reshape(cnt.shape + (1,) * (values.ndim - 1))
        out_dtype = (total.dtype if total.is_floating_point()
                     else torch.float32)
        # divide in fp32: a bf16 count would saturate at 256
        return (total.to(torch.float32)
                / torch.clamp(cnt, min=1)).to(out_dtype)
    entry = _REGISTRY["segment_pool"]
    if not entry.decide(values).use_kernel:
        return entry.reference(values, seg_ids, n_segments=n_segments,
                               reduce=reduce)
    flat = values.reshape(values.shape[0], -1).contiguous()
    out = entry.kernel(flat, kernel_ids(seg_ids), n_segments=n_segments,
                       reduce=reduce)
    return out.reshape((n_segments,) + values.shape[1:])


def segment_count(seg_ids: torch.Tensor, n_segments: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rows per segment (ids outside [0, n_segments) excluded), counted
    exactly in int64 and returned in `dtype`."""
    ids = seg_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_segments)
    counts = torch.bincount(torch.where(valid, ids, n_segments),
                            minlength=n_segments + 1)
    return counts[:n_segments].to(dtype)


def kernel_ids(ids: torch.Tensor) -> torch.Tensor:
    """Index vector in the kernels' layout: contiguous int32 (the model
    keeps int64 ids, torch's index type)."""
    return ids.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# edge_mpnn: fused gather -> per-edge MLP message -> segment-sum
# ---------------------------------------------------------------------------

def edge_mpnn_decision(h_src: torch.Tensor,
                       activation: str = "relu") -> Decision:
    if activation not in ACTIVATIONS:
        return Decision(False, f"unsupported activation {activation!r}")
    return _on_device(h_src, "edge_mpnn")


def edge_mpnn(h_src, h_tgt, src, tgt, w, b, *, n_src: int, n_tgt: int,
              activation: str = "relu") -> torch.Tensor:
    """Fused edge convolution (or its plain version on the CPU).

    h_src [n_src, Ds]; h_tgt [n_tgt, Dt]; src/tgt [E] with padding edges
    carrying tgt >= n_tgt; w [Ds+Dt, M]; b [M].  Returns [n_tgt, M]."""
    entry = _REGISTRY["edge_mpnn"]
    if not entry.decide(h_src, activation).use_kernel:
        return entry.reference(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                               n_tgt=n_tgt, activation=activation)
    return entry.kernel(h_src.contiguous(), h_tgt.contiguous(),
                        kernel_ids(src), kernel_ids(tgt), w.contiguous(),
                        b.contiguous(), n_src=n_src, n_tgt=n_tgt,
                        activation=activation)


register(KernelEntry("segment_pool", _seg_kernel.segment_pool,
                     segment_pool_ref, segment_reduce_decision))
register(KernelEntry("edge_mpnn", _mpnn_kernel.edge_mpnn, edge_mpnn_ref,
                     edge_mpnn_decision))
