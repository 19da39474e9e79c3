"""segment_pool and segment_pool_runs: the wrappers of the hand-written
Hopper kernels in `segment_pool.cu` and `runs.cu` (ports of the Pallas
kernels `segment_pool` and `segment_pool_runs` in
src/repro/kernels/segment_pool/kernel.py).

Both take the same arguments and compute the same function; the run
variant folds runs of equal ids before it scatters, which pays on sorted
ids (the training batches).  On a CUDA tensor a wrapper launches its
kernel, at any width — it checks device, dtype, shape and contiguity and
raises on what the kernel does not take (a non-float dtype among them);
on a CPU tensor it runs the plain version in `ref.py`.  Each wrapper's
`launches` counts the calls that launched (plain-version calls are not
counted).

One call is one ctypes call: the C entry zero-fills (or, for max/min,
sentinel-fills) the accumulator on the stream and launches the scatter,
plus a finalize pass for max/min or a 16-bit dtype.  For fp32 the
accumulator is the output itself, so an fp32 sum allocates one tensor
and runs one kernel.  The launch path does only what the launch needs:
the checks that raise, one or two `new_empty`, the dtype code from a
dict keyed by `torch.dtype`, and the stream of the values' device by
index (`torch.cuda.current_stream(int)`, the cheapest public route).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_pool.ref import REDUCES, segment_pool_ref

_REDUCE_CODES = {"sum": 0, "max": 1, "min": 2}
_DTYPE_CODES = {getattr(torch, name): code
                for name, code in build.DTYPE_CODES.items()}


@functools.cache
def _entry(library: str):
    fn = getattr(build.load(library), f"{library}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(library: str, values: torch.Tensor, seg_ids: torch.Tensor,
         n_segments: int, reduce: str):
    """Check the inputs and launch kernel `library`; returns (out,
    launched)."""
    if reduce not in REDUCES:
        raise ValueError(f"unsupported reduce {reduce!r}; expected one of "
                         f"{REDUCES}")
    if not values.is_cuda:
        return segment_pool_ref(values, seg_ids, n_segments=n_segments,
                                reduce=reduce), False
    if values.ndim != 2 or not values.is_contiguous():
        raise ValueError(f"{library} kernel takes contiguous [E, D] "
                         f"values, got shape {tuple(values.shape)}")
    e, d = values.shape
    index = values.get_device()
    if (seg_ids.dtype != torch.int32 or seg_ids.ndim != 1
            or seg_ids.shape[0] != e or seg_ids.get_device() != index
            or not seg_ids.is_contiguous()):
        raise ValueError(f"{library} kernel takes contiguous int32 "
                         f"seg_ids [{e}] on {values.device}")
    code = _DTYPE_CODES.get(values.dtype)
    if code is None:
        raise TypeError(f"{library} kernel takes "
                        f"{sorted(build.DTYPE_CODES)}, got {values.dtype}")
    # padding rows carry id n_segments, which must fit int32 as well
    build.check_int32(library, n_segments=n_segments + 1, width=d)
    out = values.new_empty((n_segments, d))
    if n_segments * d == 0:
        return out, False  # nothing to launch
    # fp32: the kernel accumulates straight into the output
    acc = out if values.dtype == torch.float32 else values.new_empty(
        (n_segments, d), dtype=torch.float32)
    rc = _entry(library)(values.data_ptr(), seg_ids.data_ptr(),
                         acc.data_ptr(), out.data_ptr(), e, d, n_segments,
                         code, _REDUCE_CODES[reduce],
                         torch.cuda.current_stream(index).cuda_stream)
    build.check_launch(rc, library)
    return out, True


def segment_pool(values: torch.Tensor, seg_ids: torch.Tensor, *,
                 n_segments: int, reduce: str = "sum") -> torch.Tensor:
    """values [E, D] float, seg_ids [E] int32 -> [n_segments, D] in
    values' dtype.  Ids outside [0, n_segments) are dropped; empty
    segments yield 0."""
    out, launched = _run("segment_pool", values, seg_ids, n_segments, reduce)
    if launched:
        segment_pool.launches += 1
    return out


def segment_pool_runs(values: torch.Tensor, seg_ids: torch.Tensor, *,
                      n_segments: int, reduce: str = "sum") -> torch.Tensor:
    """The run variant: same contract as `segment_pool`, one atomic per
    run of equal ids in a tile.  Correct for any id order; fastest when
    seg_ids is sorted."""
    out, launched = _run("segment_pool_runs", values, seg_ids, n_segments,
                         reduce)
    if launched:
        segment_pool_runs.launches += 1
    return out


segment_pool.launches = 0
segment_pool_runs.launches = 0
