"""Flash-attention-backed graph attention over a node set (counterpart
of `repro.nn.graph_attention`).

`GraphSelfAttention` is the dense counterpart of the edge-wise attention
convs in `repro_torch.core.convolutions`: every node attends to every
node of its own graph component (a "graph transformer" block).  On the
fixed-capacity GraphTensor this is segment-masked softmax attention over
the padded [N, H, Dh] node tensor with `component_ids()` as the segment
vector, which the CUDA flash-attention kernel computes without forming
the [N, N] logit matrix.

Routing goes through `repro_torch.kernels.registry.graph_attention`: the
kernel on a CUDA tensor (backward: the plain version's gradient), the
plain version (`segment_attention_ref`) on the CPU or inside
`registry.plain_versions()`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.graph_tensor import GraphTensor, HIDDEN_STATE
from repro_torch.kernels import registry
from repro_torch.nn.layers import Linear


class GraphSelfAttention(nn.Module):
    """Multi-head within-component self-attention over one node set.

    q/k/v are bias-free Linear projections of the node feature, reshaped
    to [N, num_heads, per_head_channels]; attention is restricted to each
    node's graph component (padding rows carry the one-past-last
    component id, so they attend only among themselves and produce values
    that downstream masks discard).  Returns [N, num_heads *
    per_head_channels] after the output projection.  Parameter names
    (`wq`, `wk`, `wv`, `wo`) are the reference's, so `load_jax_params`
    copies its tree as it is.
    """

    def __init__(self, num_heads: int, per_head_channels: int, in_dim: int,
                 *, feature_name: str = HIDDEN_STATE,
                 use_out_proj: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.per_head = per_head_channels
        self.feature_name = feature_name
        out = num_heads * per_head_channels
        self.wq = Linear(in_dim, out, use_bias=False)
        self.wk = Linear(in_dim, out, use_bias=False)
        self.wv = Linear(in_dim, out, use_bias=False)
        self.wo = Linear(out, out, use_bias=False) if use_out_proj else None

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], self.num_heads, self.per_head)

    def forward(self, graph: GraphTensor,
                node_set_name: str) -> torch.Tensor:
        ns = graph.node_sets[node_set_name]
        x = ns[self.feature_name]
        q = self._split(self.wq(x))
        k = self._split(self.wk(x))
        v = self._split(self.wv(x))
        # component_ids() maps padding rows to num_components (one past
        # the last real component): they form their own segment
        out = registry.graph_attention(q, k, v, ns.component_ids())
        out = out.reshape(out.shape[0], -1)
        if self.wo is not None:
            out = self.wo(out)
        return out
