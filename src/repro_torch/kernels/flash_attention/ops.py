"""The flash-attention entry point (counterpart of
`repro.kernels.flash_attention.ops`): the tensor's device picks the
CUDA kernel (a CUDA tensor) or the plain version (a CPU tensor), as the
registry decides for the other kernels; nothing falls back.  The LM
stack's flash prefill calls this; the graph-attention conv goes through
`repro_torch.kernels.registry.graph_attention` instead, which adds the
reference-gradient backward."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _k


def flash_attention(q, k, v, q_segments=None, kv_segments=None, *,
                    causal: bool = True):
    """q [B, Sq, H, D], k/v [B, Skv, K, D] -> [B, Sq, H, D]; raises for
    causal attention with Sq != Skv on both paths."""
    return _k.flash_attention(q, k, v, q_segments, kv_segments,
                              causal=causal)
