"""Graph convolutions (paper §4.2.2 Eq. 2, Appendix A.4; counterpart of
`repro.core.convolutions`).

`AnyToAnyConv` handles the broadcast/pool plumbing for every receiver
kind (the edge set's SOURCE or TARGET node set, or the CONTEXT);
`SimpleConv` is the paper's Fig. 7 `MyConv`; `GCNConv`, `SAGEConv`,
`GATv2Conv` (paper Appendix A.4) and `MultiHeadAttentionConv` complete
the reference's set, with its parameter names.  A conv is called as
``conv(graph, edge_set_name)`` and returns the pooled messages shaped
like a feature of the receiver set.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import ops
from repro_torch.core.graph_tensor import (CONTEXT, GraphTensor,
                                           HIDDEN_STATE, SOURCE, TARGET)
from repro_torch.kernels import registry
from repro_torch.nn.layers import ACTIVATIONS, Linear

_OTHER = {SOURCE: TARGET, TARGET: SOURCE}


def _component_softmax(value: torch.Tensor, comp: torch.Tensor,
                       mask: torch.Tensor, c: int) -> torch.Tensor:
    """Softmax of per-edge scores within each graph component."""
    comp = torch.clamp(comp, max=c - 1)
    mb = mask.reshape(mask.shape + (1,) * (value.ndim - 1))
    scores = torch.where(mb, value, torch.full_like(value, -torch.inf))
    index = comp.reshape(comp.shape + (1,) * (value.ndim - 1)) \
        .expand_as(value)
    m = torch.full((c,) + value.shape[1:], -torch.inf, dtype=value.dtype,
                   device=value.device)
    m = m.scatter_reduce(0, index, scores, "amax", include_self=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mb, torch.exp(scores - m[comp]), torch.zeros_like(value))
    z = torch.zeros_like(m).index_add_(0, comp, e)
    return e / torch.clamp(z[comp], min=1e-37)


class AnyToAnyConv(nn.Module):
    """Base class handling the broadcast/pool plumbing for all receiver
    kinds; subclasses implement `convolve`."""

    def __init__(self, *, receiver_tag: str = TARGET,
                 receiver_feature: str | None = HIDDEN_STATE,
                 sender_node_feature: str | None = HIDDEN_STATE,
                 sender_edge_feature: str | None = None):
        super().__init__()
        self.receiver_tag = receiver_tag
        self.receiver_feature = receiver_feature
        self.sender_node_feature = sender_node_feature
        self.sender_edge_feature = sender_edge_feature

    @property
    def takes_sender_node_input(self) -> bool:
        return self.sender_node_feature is not None

    @property
    def takes_sender_edge_input(self) -> bool:
        return self.sender_edge_feature is not None

    def forward(self, graph: GraphTensor, edge_set_name: str):
        tag = self.receiver_tag
        es = graph.edge_sets[edge_set_name]
        if tag == CONTEXT:
            # receivers are graph components; senders are the edges' items
            def broadcast_from_receiver(value):
                return ops.broadcast_context_to_edges(graph, edge_set_name,
                                                      feature_value=value)

            def pool_to_receiver(value, reduce_type="sum"):
                return ops.pool_edges_to_context(graph, edge_set_name,
                                                 reduce_type,
                                                 feature_value=value)

            def extra_softmax(value):
                return _component_softmax(value, es.component_ids(),
                                          es.mask(), graph.num_components)

            receiver_input = (graph.context[self.receiver_feature]
                              if self.receiver_feature else None)
            sender_node_input = None
            if self.takes_sender_node_input:
                sender_node_input = ops.broadcast_node_to_edges(
                    graph, edge_set_name, SOURCE,
                    feature_name=self.sender_node_feature)
        else:
            sender_tag = _OTHER[tag]

            def broadcast_from_receiver(value):
                return ops.broadcast_node_to_edges(graph, edge_set_name, tag,
                                                   feature_value=value)

            def pool_to_receiver(value, reduce_type="sum"):
                return ops.pool_edges_to_node(graph, edge_set_name, tag,
                                              reduce_type,
                                              feature_value=value)

            def extra_softmax(value):
                return ops.segment_softmax(graph, edge_set_name, tag,
                                           feature_value=value)

            receiver_name = (es.adjacency.target_name if tag == TARGET
                             else es.adjacency.source_name)
            receiver_input = (
                graph.node_sets[receiver_name][self.receiver_feature]
                if self.receiver_feature else None)
            sender_node_input = None
            if self.takes_sender_node_input:
                sender_node_input = ops.broadcast_node_to_edges(
                    graph, edge_set_name, sender_tag,
                    feature_name=self.sender_node_feature)
        sender_edge_input = (es[self.sender_edge_feature]
                             if self.takes_sender_edge_input else None)
        return self.convolve(
            sender_node_input=sender_node_input,
            sender_edge_input=sender_edge_input,
            receiver_input=receiver_input,
            broadcast_from_receiver=broadcast_from_receiver,
            pool_to_receiver=pool_to_receiver,
            extra_receiver_ops={"softmax": extra_softmax},
            edge_mask=es.mask())

    def convolve(self, *, sender_node_input, sender_edge_input,
                 receiver_input, broadcast_from_receiver, pool_to_receiver,
                 extra_receiver_ops, edge_mask):  # pragma: no cover
        raise NotImplementedError


class SimpleConv(AnyToAnyConv):
    """message = act(message(concat(sender inputs[, receiver state]))),
    then reduce — the paper's Fig. 7 `MyConv` generalised.

    When the conv has the fused shape (node-to-node, sum-pooled, no edge
    feature, receiver state combined) it routes the whole
    gather -> message MLP -> scatter round through an `edge_mpnn` kernel
    via `repro_torch.kernels.registry` (`edge_mpnn_runs` on target-sorted
    batches); otherwise (or when the registry deems the call ineligible)
    it runs the generic broadcast/pool path, whose pooling is a
    `segment_pool` kernel on the card.
    """

    def __init__(self, units: int, in_dim: int, *, reduce_type: str = "sum",
                 combine_receiver: bool = True, activation: str = "relu",
                 **kwargs):
        super().__init__(**kwargs)
        self.reduce_type = reduce_type
        self.combine_receiver = combine_receiver
        self.message = Linear(in_dim, units)
        self.activation_name = activation
        self.act = ACTIVATIONS[activation]

    def _fused_endpoints(self, es):
        if self.receiver_tag == TARGET:
            return es.adjacency.source_name, es.adjacency.target_name
        return es.adjacency.target_name, es.adjacency.source_name

    def fused_decision(self, graph: GraphTensor,
                       edge_set_name: str) -> registry.Decision:
        """Registry decision for running this conv as one fused kernel."""
        if self.receiver_tag == CONTEXT:
            return registry.Decision(False, "context receiver")
        if self.sender_edge_feature is not None:
            return registry.Decision(False, "edge feature input")
        if self.sender_node_feature is None:
            return registry.Decision(False, "no sender node input")
        if not (self.combine_receiver and self.receiver_feature):
            return registry.Decision(False, "no receiver state")
        if self.reduce_type != "sum":
            return registry.Decision(
                False, f"{self.reduce_type} pooling not fused")
        es = graph.edge_sets[edge_set_name]
        sender_name, recv_name = self._fused_endpoints(es)
        h_src = graph.node_sets[sender_name][self.sender_node_feature]
        h_tgt = graph.node_sets[recv_name][self.receiver_feature]
        if h_src.ndim != 2 or h_tgt.ndim != 2:
            return registry.Decision(False, "non-2D node states")
        if h_src.dtype != h_tgt.dtype:
            # the generic path would promote via concat; keep it there
            return registry.Decision(False, "mixed state dtypes")
        if self.message.in_dim != h_src.shape[1] + h_tgt.shape[1]:
            return registry.Decision(False, "in_dim mismatch")
        # the same inputs registry.edge_mpnn re-checks in forward, so the
        # two decisions cannot diverge
        return registry.edge_mpnn_decision(
            h_src, self.activation_name, self._sorted_hint(), h_tgt=h_tgt,
            w=self.message.w, n_edges=es.adjacency.source.shape[0])

    def _sorted_hint(self):
        """Batches sort edges by TARGET; a SOURCE receiver scatters by
        source ids, which that sort leaves unsorted (None reads the
        calling thread's `registry.layout()`)."""
        return None if self.receiver_tag == TARGET else False

    def forward(self, graph: GraphTensor, edge_set_name: str):
        if not self.fused_decision(graph, edge_set_name).use_kernel:
            return super().forward(graph, edge_set_name)
        es = graph.edge_sets[edge_set_name]
        adj = es.adjacency
        sender_idx, recv_idx = ((adj.source, adj.target)
                                if self.receiver_tag == TARGET
                                else (adj.target, adj.source))
        sender_name, recv_name = self._fused_endpoints(es)
        h_src = graph.node_sets[sender_name][self.sender_node_feature]
        h_tgt = graph.node_sets[recv_name][self.receiver_feature]
        n_tgt = graph.node_sets[recv_name].capacity
        tgt = torch.where(es.mask(), recv_idx,
                          torch.full_like(recv_idx, n_tgt))  # padding: drop
        return registry.edge_mpnn(
            h_src, h_tgt, sender_idx, tgt,
            self.message.w.to(h_src.dtype), self.message.b.to(h_src.dtype),
            n_src=graph.node_sets[sender_name].capacity, n_tgt=n_tgt,
            activation=self.activation_name, sorted_ids=self._sorted_hint())

    def convolve(self, *, sender_node_input, sender_edge_input,
                 receiver_input, broadcast_from_receiver, pool_to_receiver,
                 extra_receiver_ops, edge_mask):
        parts = []
        if sender_node_input is not None:
            parts.append(sender_node_input)
        if sender_edge_input is not None:
            parts.append(sender_edge_input)
        if self.combine_receiver and receiver_input is not None:
            parts.append(broadcast_from_receiver(receiver_input))
        msg = self.act(self.message(torch.cat(parts, dim=-1)))
        return pool_to_receiver(msg, reduce_type=self.reduce_type)


class GCNConv(AnyToAnyConv):
    """Kipf & Welling graph convolution with 1/sqrt(d_u d_v) normalisation
    (paper Eq. 4).  Self-loops are the caller's choice; degree counts
    include only valid edges."""

    def __init__(self, units: int, in_dim: int, *, use_bias: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.units = units
        self.w = Linear(in_dim, units, use_bias=use_bias)

    def forward(self, graph: GraphTensor, edge_set_name: str):
        tag = self.receiver_tag
        es = graph.edge_sets[edge_set_name]
        sender_tag = _OTHER[tag]
        h = graph.node_sets[es.adjacency.source_name
                            if sender_tag == SOURCE else
                            es.adjacency.target_name][HIDDEN_STATE]
        wh = self.w(h)
        deg_r = ops.node_degree(graph, edge_set_name, tag)
        deg_s = ops.node_degree(graph, edge_set_name, sender_tag)
        inv_r = torch.rsqrt(torch.clamp(deg_r, min=1).to(wh.dtype))
        inv_s = torch.rsqrt(torch.clamp(deg_s, min=1).to(wh.dtype))
        msg = ops.broadcast_node_to_edges(
            graph, edge_set_name, sender_tag,
            feature_value=wh * inv_s[:, None])
        pooled = ops.pool_edges_to_node(graph, edge_set_name, tag, "sum",
                                        feature_value=msg)
        return pooled * inv_r[:, None]

    def convolve(self, **kwargs):  # the unified entry is not used
        raise NotImplementedError


class SAGEConv(AnyToAnyConv):
    """GraphSAGE aggregator (mean, or max over an MLP for "pool";
    Hamilton et al.)."""

    def __init__(self, units: int, in_dim: int, *, aggregator: str = "mean",
                 hidden: int | None = None, **kwargs):
        super().__init__(**kwargs)
        self.aggregator = aggregator
        self.w = Linear(in_dim, units, use_bias=False)
        self.pool = (Linear(in_dim, hidden or in_dim)
                     if aggregator == "pool" else None)

    def convolve(self, *, sender_node_input, sender_edge_input,
                 receiver_input, broadcast_from_receiver, pool_to_receiver,
                 extra_receiver_ops, edge_mask):
        msg = sender_node_input
        if self.aggregator == "pool":
            msg = torch.relu(self.pool(msg))
            pooled = pool_to_receiver(msg, reduce_type="max")
        else:
            pooled = pool_to_receiver(msg, reduce_type="mean")
        return self.w(pooled)


class GATv2Conv(AnyToAnyConv):
    """GATv2 attention conv (paper Appendix A.4): per head, logits
    attn_logits . act(query(receiver) + value(sender)), softmax over each
    receiver's edges, then the sum of the weighted values."""

    def __init__(self, num_heads: int, per_head_channels: int, in_dim: int,
                 *, edge_in_dim: int | None = None,
                 attention_activation: str = "leaky_relu",
                 activation: str = "relu", **kwargs):
        super().__init__(**kwargs)
        self.num_heads = num_heads
        self.per_head = per_head_channels
        out = num_heads * per_head_channels
        self.w_query = Linear(in_dim, out)
        self.attn_logits = nn.Parameter(
            torch.zeros(num_heads, per_head_channels))
        self.w_sender_node = (Linear(in_dim, out)
                              if self.takes_sender_node_input else None)
        self.w_sender_edge = (Linear(edge_in_dim or in_dim, out,
                                     use_bias=False)
                              if self.takes_sender_edge_input else None)
        self.attention_activation = (
            (lambda x: F.leaky_relu(x, 0.2))
            if attention_activation == "leaky_relu"
            else ACTIVATIONS[attention_activation])
        self.act = ACTIVATIONS[activation]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """attn_logits ~ N(0, 1) / sqrt(per_head_channels), as the
        reference draws it (its Linears draw their own)."""
        with torch.no_grad():
            self.attn_logits.normal_(0.0, 1.0, generator=generator)
            self.attn_logits.mul_(self.per_head ** -0.5)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.num_heads, self.per_head)

    def convolve(self, *, sender_node_input, sender_edge_input,
                 receiver_input, broadcast_from_receiver, pool_to_receiver,
                 extra_receiver_ops, edge_mask):
        query = broadcast_from_receiver(
            self._split(self.w_query(receiver_input)))
        value_terms = []
        if sender_node_input is not None:
            value_terms.append(self._split(
                self.w_sender_node(sender_node_input)))
        if sender_edge_input is not None:
            value_terms.append(self._split(
                self.w_sender_edge(sender_edge_input)))
        value = sum(value_terms)
        feats = self.attention_activation(query + value)
        logits = torch.einsum("...hc,hc->...h", feats,
                              self.attn_logits.to(feats.dtype))
        coef = extra_receiver_ops["softmax"](logits)
        pooled = pool_to_receiver(value * coef[..., None], reduce_type="sum")
        return self.act(pooled.reshape(*pooled.shape[:-2], -1))


class MultiHeadAttentionConv(AnyToAnyConv):
    """Transformer-style dot-product attention on edges (paper §4.3)."""

    def __init__(self, num_heads: int, per_head_channels: int, in_dim: int,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_heads = num_heads
        self.per_head = per_head_channels
        out = num_heads * per_head_channels
        self.wq = Linear(in_dim, out, use_bias=False)
        self.wk = Linear(in_dim, out, use_bias=False)
        self.wv = Linear(in_dim, out, use_bias=False)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.num_heads, self.per_head)

    def convolve(self, *, sender_node_input, sender_edge_input,
                 receiver_input, broadcast_from_receiver, pool_to_receiver,
                 extra_receiver_ops, edge_mask):
        q = broadcast_from_receiver(self._split(self.wq(receiver_input)))
        k = self._split(self.wk(sender_node_input))
        v = self._split(self.wv(sender_node_input))
        logits = (q * k).sum(-1) * (self.per_head ** -0.5)
        coef = extra_receiver_ops["softmax"](logits)
        pooled = pool_to_receiver(v * coef[..., None], reduce_type="sum")
        return pooled.reshape(*pooled.shape[:-2], -1)
