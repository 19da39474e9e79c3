"""Quickstart (the port's twin of `examples/quickstart.py`): the paper's
recommender example (Fig. 2/3 + Appendix A.3).

Builds the heterogeneous users/items graph by hand, runs the
data-exchange ops (total spend per user, each user's fraction of the
largest spend), then one GraphUpdate round of two `SimpleConv`s into the
users.  On the card the pooling runs through `segment_pool` (the
purchases, in any order) and `segment_pool_runs` (the context max, on
sorted component ids), and each conv through `edge_mpnn` (rows of 3 and
4 floats, 8 messages wide); on the CPU all of it is the plain versions.

    from repro_torch.orchestration import quickstart
    print(quickstart.run(device="cuda"))
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ops
from repro_torch.core.convolutions import SimpleConv
from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, HIDDEN_STATE,
                                           NodeSet, SOURCE, TARGET,
                                           resolve_device, to_device)
from repro_torch.core.graph_update import (GraphUpdate, NextStateFromConcat,
                                           NodeSetUpdate)
from repro_torch.nn.layers import init_params, load_jax_params

PRICES = [22.34, 27.99, 89.99, 24.99, 350.00, 45.13]
AGES = [24, 32, 27, 38]


def example_graph() -> GraphTensor:
    """The paper's example graph (Appendix A.1), on the host."""
    i32 = np.int32
    return GraphTensor.from_pieces(
        context=Context(np.asarray([1], i32), {"scores": np.asarray(
            [[0.45, 0.98, 0.10, 0.25]], np.float32)}),
        node_sets={
            "items": NodeSet(np.asarray([6], i32), {
                "latest_price": np.asarray(PRICES, np.float32)[:, None],
            }, 6),
            "users": NodeSet(np.asarray([4], i32), {
                "age": np.asarray(AGES, i32),
            }, 4),
        },
        edge_sets={
            "purchased": EdgeSet(
                np.asarray([7], i32),
                Adjacency(np.asarray([0, 1, 2, 3, 4, 5, 5], i32),
                          np.asarray([1, 1, 0, 0, 2, 3, 0], i32),
                          "items", "users"), {}, 7),
            "is-friend": EdgeSet(
                np.asarray([3], i32),
                Adjacency(np.asarray([1, 2, 3], i32),
                          np.asarray([0, 0, 0], i32), "users", "users"),
                {}, 3),
        })


def update_module() -> GraphUpdate:
    """The example's round: two SimpleConvs into the users (8 messages
    each, from 1 + 2 and 2 + 2 wide inputs) and a 16-wide next state."""
    return GraphUpdate(node_sets={
        "users": NodeSetUpdate(
            {"purchased": SimpleConv(8, 1 + 2, receiver_tag=TARGET),
             "is-friend": SimpleConv(8, 2 + 2, receiver_tag=TARGET)},
            NextStateFromConcat(2 + 16, 16)),
    })


@dataclasses.dataclass
class QuickstartResult:
    """The example's numbers, on the host."""
    total_spend: np.ndarray          # [4] per user
    max_spend_fraction: np.ndarray   # [4] per user
    user_states: np.ndarray          # [4, 16] after the round


def run(device=None, *, params=None, seed: int = 0) -> QuickstartResult:
    """The example on `device` (CUDA by default; raises without a card).
    Parameters of the round: `params`, a tree in the reference's layout
    (the numpy leaves of ``split_params(update.init(key))[0]``), or else
    ``init_params(update, seed)``."""
    device = resolve_device(device)
    graph = to_device(example_graph(), device)

    # Appendix A.3: total and relative user spending
    purchase_prices = ops.broadcast_node_to_edges(
        graph, "purchased", SOURCE, feature_name="latest_price")
    total_user_spend = ops.pool_edges_to_node(
        graph, "purchased", TARGET, "sum", feature_value=purchase_prices)
    max_spend = ops.pool_nodes_to_context(graph, "users", "max",
                                          feature_value=total_user_spend)
    frac = total_user_spend / ops.broadcast_context_to_nodes(
        graph, "users", feature_value=max_spend)

    # one message-passing round (paper Fig. 7 style)
    graph = graph.replace_features(node_sets={
        "users": {HIDDEN_STATE: torch.cat(
            [total_user_spend,
             graph.node_sets["users"]["age"][:, None].to(torch.float32)],
            1)},
        "items": {HIDDEN_STATE: graph.node_sets["items"]["latest_price"]},
    })
    update = update_module()
    if params is not None:
        load_jax_params(update, params)
    else:
        init_params(update, seed)
    update.to(device)
    with torch.no_grad():
        out = update(graph)
    return QuickstartResult(
        total_spend=total_user_spend[:, 0].cpu().numpy(),
        max_spend_fraction=frac[:, 0].cpu().numpy(),
        user_states=out.node_sets["users"][HIDDEN_STATE].cpu().numpy())
