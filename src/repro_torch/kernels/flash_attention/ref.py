"""Plain PyTorch version of the flash_attention kernel (exact softmax
attention; counterpart of `repro.kernels.flash_attention.ref`).

Same contract as the kernel: q [B, Sq, H, D], k/v [B, Skv, K, D] with
H = K * G (query head h reads kv head h // G), scale D^-0.5 applied to q
in fp32, optional causal mask and optional q/kv segment ids (a query
attends only to keys of its own segment), fp32 arithmetic, the result
cast back to q's dtype.  A query that no key is allowed to reach emits
an exact 0.

Causal attention is defined only for Sq == Skv: the reference's kernel
aligns the mask at the start of the sequences and its oracle at the end,
so for Sq != Skv they disagree, and both the kernel and this version
raise rather than pick one reading.
"""
from __future__ import annotations

import torch


def check_causal(causal: bool, sq: int, skv: int) -> None:
    """Raise for causal attention over sequences of different lengths."""
    if causal and sq != skv:
        raise ValueError(
            f"causal flash_attention needs Sq == Skv, got Sq={sq}, "
            f"Skv={skv}: the mask's alignment is undefined (the reference's "
            "kernel and oracle disagree on it)")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_segments: torch.Tensor | None = None,
                  kv_segments: torch.Tensor | None = None, *,
                  causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, K, D]; optional q_segments [B, Sq]
    and kv_segments [B, Skv] (kv_segments defaults to q_segments).
    Returns [B, Sq, H, D] in q's dtype."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    check_causal(causal, sq, skv)
    g = h // kh
    scale = d ** -0.5
    qg = q.reshape(b, sq, kh, g, d).to(torch.float32) * scale
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=q.device)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, neg_inf)
    if q_segments is not None:
        if kv_segments is None:
            kv_segments = q_segments
        smask = (q_segments[:, None, None, :, None]
                 == kv_segments[:, None, None, None, :])
        logits = torch.where(smask, logits, neg_inf)
        # safe softmax: a query whose segment matches no key has an all
        # -inf row; it emits 0 instead of NaN
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        finite = torch.isfinite(logits)
        p = torch.where(finite, torch.exp(torch.where(finite, logits, m) - m),
                        torch.zeros_like(logits))
        probs = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def segment_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segments: torch.Tensor) -> torch.Tensor:
    """Graph attention: q/k/v [N, H, D], segments [N].  Each row attends
    exactly to the rows sharing its segment id (its graph component).
    The backward of the flash graph-attention conv differentiates this."""
    seg = segments[None]
    return attention_ref(q[None], k[None], v[None], seg, seg,
                         causal=False)[0]
