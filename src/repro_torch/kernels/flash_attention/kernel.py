"""flash_attention: the wrapper of the hand-written Hopper kernel in
`flash_attention.cu` (port of the Pallas kernel `flash_attention` in
src/repro/kernels/flash_attention/kernel.py).

On a CUDA tensor the wrapper launches the kernel: it checks device,
dtype (fp32, bf16 or fp16), shapes (``H % K == 0``, head width 1 to
256), segment ids and contiguity, and raises on what the kernel does not
take.  On a CPU tensor it runs the plain version in `ref.py`.  Causal
attention over Sq != Skv raises on both paths (see `ref.check_causal`).
`flash_attention.launches` counts kernel launches (plain-version calls
are not counted).

The C entry chooses each call's CTA (row groups x kv splits) for the
card and reports it: `last_cta()` returns the last launch's.
`tile_plan` mirrors, in plain Python, the kernel's rule for which kv
tiles a CTA visits and which of them apply the element mask; the tests
hold the rule to brute force and emulate the kernel's arithmetic on it,
and chip_smoke.py counts the visited tiles and pairs with it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     check_causal)

MAX_HEAD_DIM = 256  # the reference envelope's MAX_FEATURE_DIM
# the source's constants
BLOCK_K = 32        # kv rows per tile (kBlockK)
WARP_ROWS = 16      # q rows per warp (a row group)
CHUNK = 128         # kv tiles ranged per pass (kChunk)

_CTA = (ctypes.c_int * 2)()  # (row groups, kv splits) of the last launch


@functools.cache
def _entry():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def last_cta() -> tuple:
    """(row groups, kv splits) of the CTA the C entry chose for the last
    kernel launch: q tiles of WARP_ROWS x row groups rows."""
    return tuple(_CTA)


class KvTile(NamedTuple):
    index: int     # kv rows [index * BLOCK_K, (index + 1) * BLOCK_K)
    masked: bool   # applies the element mask


def tile_plan(q_segments, kv_segments, sq: int, skv: int, causal: bool,
              block_q: int) -> list:
    """The kv tiles the kernel visits for each q tile of one batch row, in
    its order: [[KvTile, ...] per q tile].  Segment ids are sequences of
    ints (one batch row) or None.  A causal q tile stops at its diagonal
    tile; a segmented one skips every kv tile whose valid ids' [min, max]
    misses its valid ids' [min, max].  A tile applies the element mask
    when it is ragged past Skv, straddles the diagonal, or its ids and
    the q tile's are not all one id."""
    plan = []
    for q0 in range(0, sq, block_q):
        q_ids = (None if q_segments is None
                 else q_segments[q0:min(q0 + block_q, sq)])
        kv_end = min(skv, q0 + block_q) if causal else skv
        tiles = []
        for tile in range(-(-kv_end // BLOCK_K)):
            k0 = tile * BLOCK_K
            kend = min(k0 + BLOCK_K, skv)
            masked = kend - k0 < BLOCK_K or (causal and kend - 1 > q0)
            if q_ids is not None:
                kv_ids = kv_segments[k0:kend]
                qmin, qmax = min(q_ids), max(q_ids)
                kmin, kmax = min(kv_ids), max(kv_ids)
                if kmax < qmin or kmin > qmax:
                    continue
                masked = masked or not qmin == qmax == kmin == kmax
            tiles.append(KvTile(tile, masked))
        plan.append(tiles)
    return plan


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"flash_attention kernel: {name} must be a "
                         f"contiguous {list(shape)} tensor on {device}, got "
                         f"{list(t.shape)} on {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segments: torch.Tensor | None = None,
                    kv_segments: torch.Tensor | None = None, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, K, D] with H = K * G; optional
    q_segments [B, Sq] / kv_segments [B, Skv] int32 (kv_segments defaults
    to q_segments) restrict each query to the keys of its segment.
    Returns [B, Sq, H, D] in q's dtype; a query no key may reach emits 0."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k/v "
                         f"[B, Skv, K, D], got {list(q.shape)} and "
                         f"{list(k.shape)}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    check_causal(causal, sq, skv)
    if q_segments is not None and kv_segments is None:
        kv_segments = q_segments
    if not q.is_cuda:
        return attention_ref(q, k, v, q_segments, kv_segments, causal=causal)
    device = q.device
    _check("q", q, (b, sq, h, d), device)
    _check("k", k, (b, skv, kh, d), device)
    _check("v", v, (b, skv, kh, d), device)
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError("flash_attention kernel: q, k and v must share one "
                        "dtype")
    code = build.dtype_code(q)
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention kernel: {h} query heads are not "
                         f"a multiple of {kh} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head width {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("flash_attention kernel: kv_segments without "
                         "q_segments")
    if q_segments is not None:
        for name, seg, n in (("q_segments", q_segments, sq),
                             ("kv_segments", kv_segments, skv)):
            if seg.dtype != torch.int32:
                raise TypeError(f"flash_attention kernel: {name} must be "
                                f"int32, got {seg.dtype}")
            _check(name, seg, (b, n), device)
    build.check_int32("flash_attention", sq=sq, skv=skv, width=h * d,
                      kv_width=kh * d,
                      ctas=b * h * -(-sq // WARP_ROWS))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch
    stream = torch.cuda.current_stream(device).cuda_stream
    seg_ptrs = ((q_segments.data_ptr(), kv_segments.data_ptr())
                if q_segments is not None else (None, None))
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *seg_ptrs,
                  out.data_ptr(), b, sq, skv, h, kh, d, d ** -0.5,
                  int(causal), code, _CTA, stream)
    build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
