"""Model collection (paper §4.3 / §8; counterpart of `repro.core.models`):
`GNNStack` and the §8 `vanilla_mpnn`.  The other models of the reference
come with a later slice."""
from __future__ import annotations

from typing import Mapping, Sequence

from torch import nn

from repro_torch.core.convolutions import SimpleConv
from repro_torch.core.graph_tensor import GraphTensor, TARGET
from repro_torch.core.graph_update import (GraphUpdate, NextStateFromConcat,
                                           NodeSetUpdate)


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
