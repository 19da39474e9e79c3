"""Model collection (paper §4.3 / §8 and the Table 1 baselines;
counterpart of `repro.core.models`): `GNNStack`, the §8 `vanilla_mpnn`,
and `rgcn`, `gcn`, `graph_sage`, `gatv2` and `hgt_like` with the
reference's defaults.  Each factory takes the graph's structure and
widths and returns a `GNNStack`, whose forward maps a GraphTensor with
"hidden_state" features to the updated GraphTensor after `num_rounds`
rounds."""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from repro_torch.core.convolutions import (GATv2Conv, GCNConv,
                                           MultiHeadAttentionConv, SAGEConv,
                                           SimpleConv)
from repro_torch.core.graph_tensor import GraphTensor, TARGET
from repro_torch.core.graph_update import (GraphUpdate, NextStateFromConcat,
                                           NodeSetUpdate,
                                           SingleInputNextState)
from repro_torch.nn.layers import Linear


class GNNStack(nn.Module):
    """A sequence of GraphUpdate rounds."""

    def __init__(self, updates: Sequence[GraphUpdate]):
        super().__init__()
        self.rounds = nn.ModuleList(updates)

    def describe_dispatch(self, graph: GraphTensor) -> list:
        """Per round, {node_set: {edge_set: Decision | None}}, each round
        asked on the graph it receives (runs the stack once)."""
        decisions = []
        for upd in self.rounds:
            decisions.append(upd.describe_dispatch(graph))
            graph = upd(graph)
        return decisions

    def forward(self, graph: GraphTensor) -> GraphTensor:
        for upd in self.rounds:
            graph = upd(graph)
        return graph


def vanilla_mpnn(edges: Mapping[str, tuple[str, str]],
                 node_dims: Mapping[str, int], *,
                 message_dim: int = 128, hidden_dim: int = 128,
                 num_rounds: int = 4, reduce_type: str = "sum",
                 receiver_tag: str = TARGET,
                 use_layer_norm: bool = True,
                 skip_node_sets: Sequence[str] = ()) -> GNNStack:
    """The paper's §8 VanillaMPNN: per-edge-set SimpleConv + per-node-set
    NextStateFromConcat (Fig. 7/8), generalised over an arbitrary schema."""
    updates = []
    for rnd in range(num_rounds):
        node_updates = {}
        for ns, dim in node_dims.items():
            if ns in skip_node_sets:
                continue
            convs = {}
            for es, (src, tgt) in edges.items():
                if (tgt if receiver_tag == TARGET else src) != ns:
                    continue
                sender = src if receiver_tag == TARGET else tgt
                # after round 0 all states are hidden_dim wide
                sender_dim = node_dims[sender] if rnd == 0 else hidden_dim
                recv_dim = dim if rnd == 0 else hidden_dim
                convs[es] = SimpleConv(message_dim, sender_dim + recv_dim,
                                       reduce_type=reduce_type,
                                       receiver_tag=receiver_tag)
            if not convs:
                continue
            recv_dim = dim if rnd == 0 else hidden_dim
            next_in = recv_dim + message_dim * len(convs)
            node_updates[ns] = NodeSetUpdate(
                convs, NextStateFromConcat(next_in, hidden_dim,
                                           use_layer_norm=use_layer_norm))
        updates.append(GraphUpdate(node_sets=node_updates))
    return GNNStack(updates)


class RGCNNextState(nn.Module):
    """R-GCN's next state: relu(sum of the pooled messages + W_self h)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_self = Linear(in_dim, hidden_dim, use_bias=False)

    def forward(self, old_state, inputs: list):
        return torch.relu(sum(inputs) + self.w_self(old_state))


def _per_receiver(edges: Mapping[str, tuple[str, str]],
                  node_dims: Mapping[str, int], num_rounds: int, hidden: int,
                  conv_fn, next_state_fn) -> GNNStack:
    """`num_rounds` rounds in which every node set that some edge set
    targets gets one conv per incoming edge set: ``conv_fn(sender_dim,
    receiver_dim)`` and ``next_state_fn(receiver_dim, n_convs)``, the
    dims being the input widths (every state is `hidden` wide after
    round 0)."""
    updates = []
    for rnd in range(num_rounds):
        node_updates = {}
        for ns, dim in node_dims.items():
            recv_dim = dim if rnd == 0 else hidden
            convs = {es: conv_fn(node_dims[src] if rnd == 0 else hidden,
                                 recv_dim)
                     for es, (src, tgt) in edges.items() if tgt == ns}
            if convs:
                node_updates[ns] = NodeSetUpdate(
                    convs, next_state_fn(recv_dim, len(convs)))
        updates.append(GraphUpdate(node_sets=node_updates))
    return GNNStack(updates)


def rgcn(edges: Mapping[str, tuple[str, str]],
         node_dims: Mapping[str, int], *, hidden_dim: int = 128,
         num_rounds: int = 2) -> GNNStack:
    """R-GCN (paper Eq. 5): per-edge-set mean-pooled linear messages plus
    a self-transform, summed."""
    return _per_receiver(
        edges, node_dims, num_rounds, hidden_dim,
        lambda sender, recv: SAGEConv(hidden_dim, sender, aggregator="mean"),
        lambda recv, n: RGCNNextState(recv, hidden_dim))


def gcn(edge_set: str, node_set: str, in_dim: int, *,
        hidden_dim: int = 64, num_rounds: int = 2) -> GNNStack:
    """Homogeneous GCN (paper Eq. 4); expects self-loops in the data."""
    return GNNStack([
        GraphUpdate(node_sets={node_set: NodeSetUpdate(
            {edge_set: GCNConv(hidden_dim,
                               in_dim if rnd == 0 else hidden_dim)},
            SingleInputNextState())})
        for rnd in range(num_rounds)])


def graph_sage(edges: Mapping[str, tuple[str, str]],
               node_dims: Mapping[str, int], *, hidden_dim: int = 128,
               num_rounds: int = 2, aggregator: str = "mean") -> GNNStack:
    return _per_receiver(
        edges, node_dims, num_rounds, hidden_dim,
        lambda sender, recv: SAGEConv(hidden_dim, sender,
                                      aggregator=aggregator),
        lambda recv, n: NextStateFromConcat(recv + hidden_dim * n,
                                            hidden_dim))


def gatv2(edges: Mapping[str, tuple[str, str]],
          node_dims: Mapping[str, int], *, num_heads: int = 4,
          per_head: int = 32, num_rounds: int = 2) -> GNNStack:
    """Heterogeneous GATv2 (paper §4.3): attention within each edge set,
    relation importance through separate weights.  A conv's projections
    take the receiver's width (the reference's choice)."""
    hidden = num_heads * per_head
    return _per_receiver(
        edges, node_dims, num_rounds, hidden,
        lambda sender, recv: GATv2Conv(num_heads, per_head, recv),
        lambda recv, n: NextStateFromConcat(recv + hidden * n, hidden))


def hgt_like(edges: Mapping[str, tuple[str, str]],
             node_dims: Mapping[str, int], *, num_heads: int = 4,
             per_head: int = 32, num_rounds: int = 2) -> GNNStack:
    """Heterogeneous transformer-conv stack (the paper's Table 1
    competitor family: per-edge-set dot-product attention, per-type
    projections)."""
    hidden = num_heads * per_head
    return _per_receiver(
        edges, node_dims, num_rounds, hidden,
        lambda sender, recv: MultiHeadAttentionConv(num_heads, per_head,
                                                    recv),
        lambda recv, n: NextStateFromConcat(recv + hidden * n, hidden))
