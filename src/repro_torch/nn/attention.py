"""Multi-head attention: GQA, RoPE, KV cache, causal / bidirectional /
cross (counterpart of `repro.nn.attention`).

Layouts are the reference's: activations ``[B, S, H, D]``, queries of a
GQA group reshaped to ``[B, S, K, G, D]`` so query head ``h`` reads kv
head ``h // G`` without repeating k/v.  The decode path keeps a
`KVCache` of static ``max_len``; new entries are written at ``length``
with the start clamped as ``jax.lax.dynamic_update_slice`` clamps it, and
masking handles validity.  A cache may be cut by sequence over a mesh
axis (the reference's ``"seq": "model"`` rule on its cache axes): rank
``r`` holds positions ``[r T / M, (r + 1) T / M)`` of every kv head, a
new token's K/V is written on the rank that owns its position, and
`merged_gqa_attention` merges the ranks' softmax terms over the axis.
On a mesh, `Attention.split_` splits a layer by whole heads over the
"model" axis where the axis divides its query and kv heads.  Where it
does not (qwen1.5-4b's 20 heads, granite's 24 / 8, arctic's 56 / 8 at
16), the layer computes whole on every model rank, as GSPMD runs the
reference's, but its weights are still cut at rest as the reference's
resolver cuts them: ``wq`` / ``wk`` / ``wv`` by the fused heads x
head_dim columns and ``wo`` by those rows, wherever the axis divides
that width.  Each call gathers the weights whole over the axis
(`Linear` cut at rest) rather than the activations: at training token
counts a layer's weights (4 d^2 at most) are fewer bytes than its
[B, S, heads x head_dim] projections, and a gathered weight is alike on
every rank, so its backward keeps the rank's slice of the gradient with
no collective.
With ``use_flash`` on, full-sequence
self-attention without a mask goes to the ported flash kernel
(`repro_torch.kernels.flash_attention.ops`) on the condition of
`repro/nn/attention.py:274-276`; everything else here is plain PyTorch,
as the reference leaves it to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch
from torch import nn

from repro_torch.distributed.collectives import (Axis, all_gather, all_max,
                                                 all_reduce, copy_to,
                                                 split_chunk)
from repro_torch.nn.layers import Linear, splits

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# float8_e4m3fn's largest finite value is 448 and it spends the next step
# (480) on NaN.  The reference's cast (ml_dtypes) rounds to nearest even,
# so |x| <= 464, the midpoint, goes to +-448 and anything larger (inf
# included) to NaN; torch saturates to +-448 instead.
E4M3_OVERFLOW = 464.0


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` cast to the cache's dtype as the reference casts it: for
    float8_e4m3fn, NaN past `E4M3_OVERFLOW`, where torch alone would give
    +-448."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    x32 = x.to(torch.float32)
    x32 = torch.where(x32.abs() > E4M3_OVERFLOW,
                      torch.full_like(x32, math.nan), x32)
    return x32.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / D)`` in fp32, [D/2].  The power is taken in
    fp32 as in the reference; torch's and XLA's can differ by an ulp at
    some (D, theta), which moves an angle at position p by ~p * 6e-8."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] absolute token positions.  Half
    split (the first D/2 features rotate with the last D/2), fp32 angles,
    the result in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings [S, dim]."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(dim // 2, dtype=torch.float32,
                                   device=device)
                    / max(dim // 2 - 1, 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def seq_offset(held: int, seq: Axis | None) -> int:
    """The first position of this rank's `held` positions of a sequence
    cut over `seq` (0 when whole)."""
    return 0 if seq is None else seq.index * held


def write_positions(dst: torch.Tensor, src: torch.Tensor, start: int,
                    seq: Axis | None = None) -> None:
    """Write `src` [B, S, ...] at positions ``[start, start + S)`` of the
    sequence `dst` [B, T, ...] holds: the whole of it, or with `seq` this
    rank's slice of one cut over that axis (the part of `src` that falls
    in it; nothing where none does)."""
    held = dst.shape[1]
    offset = seq_offset(held, seq)
    lo = max(start, offset)
    hi = min(start + src.shape[1], offset + held)
    if lo < hi:
        dst[:, lo - offset:hi - offset] = to_kv_dtype(
            src[:, lo - start:hi - start], dst.dtype)


def cut_by(cache, **axes):
    """`cache` (a cache dataclass) with the axes its sequences are cut
    over set (``seq=``, and whisper's ``enc_seq=``).  They are attributes
    of the instance, not dataclass fields: the fields stay the
    reference's."""
    for name, axis in axes.items():
        setattr(cache, name, axis)
    return cache


@dataclasses.dataclass
class KVCache:
    """Static-size decode cache for one attention layer or a stacked set
    (a leading layer dimension).  ``length`` is a host int: the number of
    valid positions (the reference keeps an int32 scalar; a host int
    spares the device a sync a step).  ``seq`` (`cut_by`): the axis the
    positions are cut over (module docstring), None when the cache is
    whole."""

    k: torch.Tensor  # [B, max_len, K, D] (+ leading layer dim when stacked)
    v: torch.Tensor
    length: int
    seq: ClassVar[Axis | None] = None

    @staticmethod
    def zeros(batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16, layers: int | None = None,
              device=None, seq: Axis | None = None) -> "KVCache":
        """A cache of `max_len` positions; with `seq`, this rank's
        ``max_len / seq.size`` of them."""
        held = max_len // seq.size if seq is not None else max_len
        shape = (batch, held, n_kv, head_dim)
        if layers is not None:
            shape = (layers,) + shape
        return cut_by(KVCache(torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device),
                              0), seq=seq)

    @property
    def max_len(self) -> int:
        """Positions of the whole cache (every rank's, when cut)."""
        return self.k.shape[-3] * (self.seq.size if self.seq else 1)

    def layer(self, i: int) -> "KVCache":
        """Layer `i`'s view of a stacked cache."""
        return cut_by(KVCache(self.k[i], self.v[i], self.length),
                      seq=self.seq)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write [B, S_new, K, D] at position ``length`` (one layer's
        view) and return the cache ``S_new`` longer.  The start clamps to
        ``[0, max_len - S_new]`` as ``dynamic_update_slice`` clamps it.
        Unlike the reference's, the write is in place (no copy of the
        whole cache a step): the returned cache shares k and v.  A cache
        cut by sequence writes only the positions this rank holds."""
        s_new = k_new.shape[1]
        start = min(max(int(self.length), 0), self.max_len - s_new)
        write_positions(self.k, k_new, start, self.seq)
        write_positions(self.v, v_new, start, self.seq)
        return cut_by(KVCache(self.k, self.v, int(self.length) + s_new),
                      seq=self.seq)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention in fp32, the result in q's dtype.

    q [B, Sq, H, D]; k, v [B, Skv, K, D] with H = K * G; query head h
    reads kv head h // G.  mask: broadcastable to [B, 1, 1, Sq, Skv]
    (True = attend); masked logits take DEFAULT_MASK_VALUE, not -inf."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, kheads, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          q_chunk: int = 512, kv_chunk: int = 1024,
                          kv_valid: int | None = None,
                          skip_masked_chunks: bool = False) -> torch.Tensor:
    """Online-softmax attention over (q chunk, kv chunk) blocks, never
    holding the [Sq, Skv] logits (`repro/nn/attention.py:113-196`, whose
    `lax.scan` loops are Python loops here).

    q [B, Sq, H, D]; k, v [B, Skv, K, D].  q_offset: the absolute position
    of q[0] relative to kv[0].  kv_valid: keys at or past it are masked.
    skip_masked_chunks: with causal, skip kv chunks wholly above the
    diagonal (the reference's `lax.cond`)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"chunked_gqa_attention: Sq {sq} and Skv {skv} "
                         f"must be multiples of their chunks {qc}, {kc}")
    nq, nk = sq // qc, skv // kc
    dev = q.device
    # the scale multiplies in q's dtype, then fp32 (as the reference)
    qg = (q.reshape(b, nq, qc, kh, g, d) * scale).to(torch.float32)
    kf = k.reshape(b, nk, kc, kh, d).to(torch.float32)
    vf = v.reshape(b, nk, kc, kh, d).to(torch.float32)
    qpos = (torch.arange(sq, device=dev) + q_offset).reshape(nq, qc)
    kpos = torch.arange(skv, device=dev).reshape(nk, kc)
    first_k = [kc * j for j in range(nk)]
    last_q = [q_offset + qc * (i + 1) - 1 for i in range(nq)]

    outs = []
    for i in range(nq):
        qi, qp = qg[:, i], qpos[i]
        m = torch.full((b, kh, g, qc), -math.inf, dtype=torch.float32,
                       device=dev)
        l_sum = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, qc, d), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            if causal and skip_masked_chunks and first_k[j] > last_q[i]:
                continue
            ki, kp, vi = kf[:, j], kpos[j], vf[:, j]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qi, ki)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (kp[None, :] <= qp[:, None])
            if kv_valid is not None:
                mask = mask & (kp < kv_valid)[None, :]
            logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bkgqs,bskd->bkgqd", p, vi))
            m = m_new
        outs.append(acc / torch.clamp(l_sum[..., None], min=1e-37))
    out = torch.stack(outs, dim=1)  # [B, nq, K, G, qc, D]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, d)
    return out.to(q.dtype)


def merged_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`gqa_attention` over a kv sequence cut over `axis`: each rank holds
    its positions of `k` and `v` (every kv head) and the whole `q`.  The
    row maxima are reduced over the axis first (`all_max`), then each
    rank's sums of the exponentials and of their product with V, so the
    softmax is the whole sequence's; masked logits take
    DEFAULT_MASK_VALUE as in `gqa_attention`.  ``mask`` broadcasts to
    [B, 1, 1, Sq, Skv] over this rank's positions."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, sq, kheads, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * d ** -0.5
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    top = all_max(logits.amax(dim=-1), axis)               # [B, K, G, Sq]
    p = torch.exp(logits - top[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(torch.float32))
    sums = all_reduce(torch.cat([acc, p.sum(dim=-1)[..., None]], dim=-1),
                      axis)
    out = sums[..., :d] / sums[..., d:]                    # [B, K, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def causal_mask(sq: int, skv: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, 1, Sq, Skv]: query i attends kv j iff j <= i + q_offset."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    return (kpos <= qpos)[None, None, None]


def length_mask(skv: int, valid_len: int, device=None) -> torch.Tensor:
    """[1, 1, 1, 1, Skv]: kv j is valid iff j < valid_len."""
    return (torch.arange(skv, device=device)
            < valid_len)[None, None, None, None, :]


# ---------------------------------------------------------------------------
# Attention layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention layer with optional RoPE, biases and the flash
    kernel; parameters ``wq``, ``wk``, ``wv``, ``wo`` as the
    reference's."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int | None = None, *, qkv_bias: bool = False,
                 out_bias: bool = False, rope: bool = True,
                 rope_theta: float = 10000.0, causal: bool = True,
                 use_flash: bool = False, chunk_threshold: int = 1024,
                 q_chunk: int = 512, kv_chunk: int = 1024,
                 skip_masked_chunks: bool = False):
        super().__init__()
        self.chunk_threshold = chunk_threshold
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.skip_masked_chunks = skip_masked_chunks
        self.n_heads = n_heads
        self.n_kv = n_kv_heads
        self.head_dim = head_dim or d_model // n_heads
        self.rope = rope
        self.rope_theta = rope_theta
        self.causal = causal
        self.use_flash = use_flash
        hd = self.head_dim
        self.wq = Linear(d_model, n_heads * hd, use_bias=qkv_bias,
                         kernel_axes=("embed", "heads"))
        self.wk = Linear(d_model, n_kv_heads * hd, use_bias=qkv_bias,
                         kernel_axes=("embed", "kv_heads"))
        self.wv = Linear(d_model, n_kv_heads * hd, use_bias=qkv_bias,
                         kernel_axes=("embed", "kv_heads"))
        self.wo = Linear(n_heads * hd, d_model, use_bias=out_bias,
                         kernel_axes=("heads", "embed"))
        self.axis: Axis | None = None

    def split_(self, axis: Axis) -> bool:
        """Split by whole heads over the axis: q, k and v by columns
        (this rank's query heads and the kv heads their GQA groups read,
        both contiguous), o by rows, its products summed over the axis.
        False (the layer computes whole) when the query or kv heads do
        not split evenly, which would cut a head or a group; its weights
        are then cut at rest wherever the axis divides their fused
        heads x head_dim width (module docstring, `cut_at_rest`)."""
        if not (splits(self.n_heads, axis) and splits(self.n_kv, axis)):
            hd = self.head_dim
            for lin, heads in ((self.wq, self.n_heads), (self.wk, self.n_kv),
                               (self.wv, self.n_kv)):
                if splits(heads * hd, axis):
                    lin.split_("column", axis, at_rest=True)
            if splits(self.n_heads * hd, axis):
                self.wo.split_("row", axis, at_rest=True)
            return False
        for lin in (self.wq, self.wk, self.wv):
            lin.split_("column", axis)
        self.wo.split_("row", axis)
        self.n_heads //= axis.size
        self.n_kv //= axis.size
        self.axis = axis
        return True

    def cut_at_rest(self) -> Axis | None:
        """The axis this whole layer's weights are cut over between
        calls (`split_`), or None."""
        cut = self.wq.rest_cut or self.wk.rest_cut
        return cut[1] if cut is not None else None

    def _project(self, x: torch.Tensor, positions: torch.Tensor,
                 reduce: bool = True):
        b, s, _ = x.shape
        q = self.wq(x, reduce).reshape(b, s, self.n_heads, self.head_dim)
        k = self.wk(x, reduce).reshape(b, s, self.n_kv, self.head_dim)
        v = self.wv(x, reduce).reshape(b, s, self.n_kv, self.head_dim)
        if self.rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, positions=None, mask=None,
                kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                reduce: bool = True) -> torch.Tensor:
        """Full-sequence (train / prefill) attention; kv: external (k, v)
        for cross attention.  With ``reduce=False`` (inside a
        sequence-parallel region: `x` the whole gathered sequence, its
        gradient summed by the gather) a split layer reads `x` as it is
        and gives this rank's part of ``wo``'s sum over the axis."""
        b, s, _ = x.shape
        if reduce:
            x = copy_to(x, self.axis)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if kv is None:
            q, k, v = self._project(x, positions, reduce)
        else:
            q = self.wq(x, reduce).reshape(b, s, self.n_heads, self.head_dim)
            if self.rope:
                q = apply_rope(q, positions, self.rope_theta)
            k, v = kv
        skv = k.shape[1]
        if self.use_flash and mask is None and kv is None:
            from repro_torch.kernels.flash_attention import ops as flash_ops
            out = flash_ops.flash_attention(q, k, v, causal=self.causal)
        elif mask is None and max(s, skv) >= self.chunk_threshold:
            out = chunked_gqa_attention(
                q, k, v, causal=(self.causal and kv is None),
                q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                skip_masked_chunks=self.skip_masked_chunks)
        else:
            if mask is None and self.causal and kv is None:
                mask = causal_mask(s, skv, 0, x.device)
            out = gqa_attention(q, k, v, mask)
        return self.wo(out.reshape(b, s, -1), reduce)

    def cross_kv(self, enc: torch.Tensor, reduce: bool = True):
        """Cross-attention K/V from an encoder output (this rank's kv heads
        where the layer is split); ``reduce=False`` as in `forward`."""
        b, s, _ = enc.shape
        if reduce:
            enc = copy_to(enc, self.axis)
        k = self.wk(enc, reduce).reshape(b, s, self.n_kv, self.head_dim)
        v = self.wv(enc, reduce).reshape(b, s, self.n_kv, self.head_dim)
        return k, v

    def decode_step(self, x: torch.Tensor, cache: KVCache, *,
                    positions=None) -> tuple[torch.Tensor, KVCache]:
        """x [B, S_new, d]: appends to the cache (in place) and attends to
        the whole valid prefix."""
        b, s, _ = x.shape
        if positions is None:
            positions = (cache.length + torch.arange(s, device=x.device)
                         )[None].expand(b, s)
        q, k, v = self._project(x, positions)
        if cache.seq is not None:
            return self._decode_cut(q, k, v, cache)
        cache = cache.update(k, v)
        skv = cache.k.shape[1]
        mask = (causal_mask(s, skv, cache.length - s, x.device)
                & length_mask(skv, cache.length, x.device))
        out = gqa_attention(q, cache.k, cache.v, mask)
        return self.wo(out.reshape(b, s, -1)), cache

    def all_heads(self, *xs):
        """[B, S, heads, D] tensors with every head: this rank's
        all-gathered over the axis when the layer is split."""
        if self.axis is None:
            return xs
        return tuple(all_gather(x, self.axis, 2) for x in xs)

    def _merged_out(self, q, k, v, mask, seq: Axis) -> torch.Tensor:
        """`merged_gqa_attention` of every head over a cache cut over
        `seq`, then ``wo`` on this rank's heads (all of them when
        whole)."""
        b, s = q.shape[:2]
        (q,) = self.all_heads(q)
        out = merged_gqa_attention(q, k, v, mask, seq)
        if self.axis is not None:
            out = split_chunk(out, self.axis, 2)
        return self.wo(out.reshape(b, s, -1))

    def _decode_cut(self, q, k, v, cache: KVCache):
        """`decode_step` over a cache cut by sequence, which holds every
        kv head of its positions: the step's k/v are written on the rank
        that owns their position, and every head's q attends to this
        rank's positions under the causal and length masks."""
        s = q.shape[1]
        cache = cache.update(*self.all_heads(k, v))
        held = cache.k.shape[1]
        dev = q.device
        qpos = cache.length - s + torch.arange(s, device=dev)
        kpos = seq_offset(held, cache.seq) + torch.arange(held, device=dev)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos < cache.length)[None, :])[None, None, None]
        return self._merged_out(q, cache.k, cache.v, mask, cache.seq), cache

    def cross_decode_step(self, x: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, kv_valid=None,
                          seq: Axis | None = None) -> torch.Tensor:
        """Cross attention during decode over cached encoder K/V (with
        `seq`, this rank's positions of a cross cache cut over it, every
        kv head)."""
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.n_heads, self.head_dim)
        if seq is not None:
            held = k.shape[1]
            kpos = seq_offset(held, seq) + torch.arange(held, device=x.device)
            valid = held * seq.size if kv_valid is None else kv_valid
            mask = (kpos < valid)[None, None, None, None, :]
            return self._merged_out(q, k, v, mask, seq)
        mask = (None if kv_valid is None
                else length_mask(k.shape[1], kv_valid, x.device))
        out = gqa_attention(q, k, v, mask)
        return self.wo(out.reshape(b, s, -1))
