"""GraphUpdate (paper §4.2.2, Eq. 1–3; counterpart of
`repro.core.graph_update`): one round of heterogeneous message passing
assembled from per-edge-set convs and per-node-set next-state maps, plus
the optional edge-set and context updates (full Graph Networks).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.core import ops
from repro_torch.core.graph_tensor import (GraphTensor, HIDDEN_STATE, SOURCE,
                                           TARGET)
from repro_torch.nn.layers import ACTIVATIONS, LayerNorm, Linear


class NextStateFromConcat(nn.Module):
    """next_state = fn(concat(old state, all inputs)) (paper Fig. 7)."""

    def __init__(self, in_dim: int, units: int, *, activation: str = "relu",
                 use_layer_norm: bool = False):
        super().__init__()
        self.dense = Linear(in_dim, units)
        self.act = ACTIVATIONS[activation]
        self.norm = LayerNorm(units) if use_layer_norm else None

    def forward(self, old_state, inputs: list):
        y = self.act(self.dense(torch.cat([old_state] + list(inputs),
                                          dim=-1)))
        if self.norm is not None:
            y = self.norm(y)
        return y


class ResidualNextState(nn.Module):
    """next_state = old + fn(concat(...)); used by deeper GNN stacks."""

    def __init__(self, in_dim: int, units: int, *, activation: str = "relu"):
        super().__init__()
        self.inner = NextStateFromConcat(in_dim, units, activation=activation)

    def forward(self, old_state, inputs: list):
        return old_state + self.inner(old_state, inputs)


class SingleInputNextState(nn.Module):
    """Passes through the single pooled message (paper GCN Eq. 4)."""

    def forward(self, old_state, inputs: list):
        if len(inputs) != 1:
            raise ValueError(f"expected one input, got {len(inputs)}")
        return inputs[0]


class NodeSetUpdate(nn.Module):
    """{edge_set_name: conv} + next state for one node set (paper Eq. 1).

    Convs that expose a fused kernel path (SimpleConv's `edge_mpnn`
    route) use it transparently; `describe_dispatch` reports which path
    each conv takes and why."""

    def __init__(self, convs: Mapping[str, nn.Module], next_state: nn.Module):
        super().__init__()
        self.convs = nn.ModuleDict(dict(sorted(convs.items())))
        self.next_state = next_state

    def describe_dispatch(self, graph: GraphTensor) -> dict:
        """{edge_set_name: registry Decision (or None for generic convs)}."""
        return {name: (conv.fused_decision(graph, name)
                       if hasattr(conv, "fused_decision") else None)
                for name, conv in self.convs.items()}

    def forward(self, graph: GraphTensor, node_set_name: str):
        old = graph.node_sets[node_set_name][HIDDEN_STATE]
        pooled = [conv(graph, name) for name, conv in self.convs.items()]
        return self.next_state(old, pooled)


class EdgeSetUpdate(nn.Module):
    """Materialised per-edge state update (paper Eq. 3, NextEdgeState):
    next_state(old edge state, [sender state], [receiver state]); without
    an old edge state the first input takes its place."""

    def __init__(self, in_dim: int, units: int, *, activation: str = "relu",
                 use_receiver_state: bool = True,
                 use_sender_state: bool = True):
        super().__init__()
        self.next_state = NextStateFromConcat(in_dim, units,
                                              activation=activation)
        self.use_receiver_state = use_receiver_state
        self.use_sender_state = use_sender_state

    def forward(self, graph: GraphTensor, edge_set_name: str):
        es = graph.edge_sets[edge_set_name]
        inputs = []
        if self.use_sender_state:
            inputs.append(ops.broadcast_node_to_edges(
                graph, edge_set_name, SOURCE, feature_name=HIDDEN_STATE))
        if self.use_receiver_state:
            inputs.append(ops.broadcast_node_to_edges(
                graph, edge_set_name, TARGET, feature_name=HIDDEN_STATE))
        old = es.features.get(HIDDEN_STATE)
        if old is None:
            old, inputs = inputs[0], inputs[1:]
        return self.next_state(old, inputs)


class ContextUpdate(nn.Module):
    """Pool node states per component (`reduce_type`, through the
    registry: context ids are sorted, so on the card `segment_pool_runs`)
    and update the context state; without an old context state the first
    pooled input takes its place."""

    def __init__(self, node_set_names: list[str], in_dim: int, units: int,
                 *, reduce_type: str = "mean", activation: str = "relu"):
        super().__init__()
        self.node_set_names = list(node_set_names)
        self.reduce_type = reduce_type
        self.next_state = NextStateFromConcat(in_dim, units,
                                              activation=activation)

    def forward(self, graph: GraphTensor):
        pooled = [ops.pool_nodes_to_context(graph, name, self.reduce_type,
                                            feature_name=HIDDEN_STATE)
                  for name in self.node_set_names]
        old = graph.context.features.get(HIDDEN_STATE)
        if old is None:
            old, pooled = pooled[0], pooled[1:]
        return self.next_state(old, pooled)


class GraphUpdate(nn.Module):
    """One message-passing round over the whole heterogeneous graph, in
    the Graph Networks schedule: edge-set updates, then node-set updates,
    then the context update.  Each stage reads the graph the stage before
    it returned (within a stage, every set reads the same graph), and the
    round returns a new GraphTensor with replaced hidden states.  On the
    card the hot path of a round runs through the kernels behind
    `repro_torch.kernels.registry`; `describe_dispatch` reports the
    per-conv routing decisions."""

    def __init__(self, *,
                 node_sets: Mapping[str, NodeSetUpdate] | None = None,
                 edge_sets: Mapping[str, EdgeSetUpdate] | None = None,
                 context: ContextUpdate | None = None):
        super().__init__()
        self.node_sets = nn.ModuleDict(dict(sorted((node_sets or {}).items())))
        self.edge_sets = nn.ModuleDict(dict(sorted((edge_sets or {}).items())))
        self.context = context

    def describe_dispatch(self, graph: GraphTensor) -> dict:
        """{node_set_name: {edge_set_name: Decision | None}} — which kernel
        path each conv of this round takes on `graph`."""
        return {name: upd.describe_dispatch(graph)
                for name, upd in self.node_sets.items()
                if hasattr(upd, "describe_dispatch")}

    def forward(self, graph: GraphTensor) -> GraphTensor:
        if self.edge_sets:
            new_edge_feats = {}
            for name, upd in self.edge_sets.items():
                feats = dict(graph.edge_sets[name].features)
                feats[HIDDEN_STATE] = upd(graph, name)
                new_edge_feats[name] = feats
            graph = graph.replace_features(edge_sets=new_edge_feats)
        if self.node_sets:
            new_node_feats = {}
            for name, upd in self.node_sets.items():
                feats = dict(graph.node_sets[name].features)
                feats[HIDDEN_STATE] = upd(graph, name)
                new_node_feats[name] = feats
            graph = graph.replace_features(node_sets=new_node_feats)
        if self.context is not None:
            feats = dict(graph.context.features)
            feats[HIDDEN_STATE] = self.context(graph)
            graph = graph.replace_features(context=feats)
        return graph


class MapFeatures(nn.Module):
    """Per-set feature transformations (paper §4.2.1): each module maps a
    set's feature dict to its new feature dict; used to build initial
    hidden states."""

    def __init__(self, node_sets: Mapping[str, nn.Module] | None = None,
                 edge_sets: Mapping[str, nn.Module] | None = None,
                 context: nn.Module | None = None):
        super().__init__()
        self.node_sets = nn.ModuleDict(dict(sorted((node_sets or {}).items())))
        self.edge_sets = nn.ModuleDict(dict(sorted((edge_sets or {}).items())))
        self.context = context

    def forward(self, graph: GraphTensor) -> GraphTensor:
        node_feats = {name: fn(graph.node_sets[name].features)
                      for name, fn in self.node_sets.items()}
        edge_feats = {name: fn(graph.edge_sets[name].features)
                      for name, fn in self.edge_sets.items()}
        ctx = (self.context(graph.context.features)
               if self.context is not None else None)
        return graph.replace_features(context=ctx,
                                      node_sets=node_feats or None,
                                      edge_sets=edge_feats or None)
