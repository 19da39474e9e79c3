"""Data-exchange ops (paper §4.1, API Level 2; counterpart of
`repro.core.ops`).

Broadcast and pool between node sets, edge sets and context.  All ops work
on the fixed-capacity GraphTensor: padding items are masked out of every
reduction by remapping their segment ids to `n_segments` (the registry
contract: out-of-range ids are dropped, empty segments yield 0).  Every
segment-shaped reduction routes through `repro_torch.kernels.registry`,
which runs a CUDA `segment_pool` kernel on the card (the run variant on
sorted ids) and the plain PyTorch version on the CPU.  The reference's
model-axis feature split comes with the parallelism slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph_tensor import GraphTensor, SOURCE, TARGET
from repro_torch.kernels import registry

_REDUCE_TYPES = ("sum", "mean", "max", "min")


def _edge_endpoint(graph: GraphTensor, edge_set_name: str, tag: str):
    adj = graph.edge_sets[edge_set_name].adjacency
    if tag == SOURCE:
        return adj.source, adj.source_name
    if tag == TARGET:
        return adj.target, adj.target_name
    raise ValueError(f"tag must be SOURCE or TARGET, got {tag!r}")


def _resolve_feature(piece, feature_name, feature_value):
    if (feature_name is None) == (feature_value is None):
        raise ValueError("exactly one of feature_name/feature_value required")
    return piece[feature_name] if feature_name is not None else feature_value


def _sorted_hint(tag: str):
    """The registry's layout hint for ids keyed by endpoint `tag`: None
    (the calling thread's `registry.layout()`) for TARGET, False for
    SOURCE, as the reference passes it (`core/ops.py:126-128,141`)."""
    return None if tag == TARGET else False


def _masked_ids(mask: torch.Tensor, idx: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Segment ids with padding items remapped to `n_segments`."""
    return torch.where(mask, idx, torch.full_like(idx, n_segments))


# ---------------------------------------------------------------------------
# node <-> edge
# ---------------------------------------------------------------------------

def broadcast_node_to_edges(graph: GraphTensor, edge_set_name: str, tag: str,
                            *, feature_name: str | None = None,
                            feature_value=None) -> torch.Tensor:
    """For each edge, the feature value at its `tag` endpoint node."""
    idx, node_set_name = _edge_endpoint(graph, edge_set_name, tag)
    value = _resolve_feature(graph.node_sets[node_set_name], feature_name,
                             feature_value)
    return value[idx]


def pool_edges_to_node(graph: GraphTensor, edge_set_name: str, tag: str,
                       reduce_type: str = "sum", *,
                       feature_name: str | None = None,
                       feature_value=None) -> torch.Tensor:
    """Aggregate per-edge values at each `tag` endpoint node (paper Eq. 3).

    Padding edges are excluded; nodes with no (valid) incident edges
    yield 0 for every reduce_type.
    """
    if reduce_type not in _REDUCE_TYPES:
        raise ValueError(f"unknown reduce_type {reduce_type!r}")
    es = graph.edge_sets[edge_set_name]
    idx, node_set_name = _edge_endpoint(graph, edge_set_name, tag)
    value = _resolve_feature(es, feature_name, feature_value)
    num_nodes = graph.node_sets[node_set_name].capacity
    seg_ids = _masked_ids(es.mask(), idx, num_nodes)
    # batches sort edges by (component, target) and pad last, so
    # TARGET-keyed ids are non-decreasing exactly when the calling
    # thread's registry.layout() says so; SOURCE-keyed ids never are
    return registry.segment_reduce(value, seg_ids, num_nodes, reduce_type,
                                   sorted_ids=_sorted_hint(tag))


def segment_softmax(graph: GraphTensor, edge_set_name: str, tag: str,
                    *, feature_value: torch.Tensor) -> torch.Tensor:
    """Softmax of per-edge scores within each receiver node's edge segment
    (the attention-pooling primitive)."""
    es = graph.edge_sets[edge_set_name]
    idx, node_set_name = _edge_endpoint(graph, edge_set_name, tag)
    num_nodes = graph.node_sets[node_set_name].capacity
    emask = es.mask()
    emask_b = emask.reshape(emask.shape + (1,) * (feature_value.ndim - 1))
    seg_ids = _masked_ids(emask, idx, num_nodes)
    sorted_ids = _sorted_hint(tag)
    # max-shift for stability, then exp-sum — both registry reductions
    seg_max = registry.segment_reduce(feature_value, seg_ids, num_nodes,
                                      "max", sorted_ids=sorted_ids)
    shifted = torch.where(emask_b, feature_value - seg_max[idx],
                          torch.full_like(feature_value, -torch.inf))
    exp = torch.where(emask_b, torch.exp(shifted),
                      torch.zeros_like(feature_value))
    seg_sum = registry.segment_reduce(exp, seg_ids, num_nodes, "sum",
                                      sorted_ids=sorted_ids)
    return exp / torch.clamp(seg_sum[idx], min=1e-37)


# ---------------------------------------------------------------------------
# context <-> node/edge
# ---------------------------------------------------------------------------

def _broadcast_context(value: torch.Tensor, comp: torch.Tensor):
    return value[torch.clamp(comp, max=value.shape[0] - 1)]


def broadcast_context_to_nodes(graph: GraphTensor, node_set_name: str, *,
                               feature_name: str | None = None,
                               feature_value=None) -> torch.Tensor:
    value = _resolve_feature(graph.context, feature_name, feature_value)
    return _broadcast_context(
        value, graph.node_sets[node_set_name].component_ids())


def broadcast_context_to_edges(graph: GraphTensor, edge_set_name: str, *,
                               feature_name: str | None = None,
                               feature_value=None) -> torch.Tensor:
    value = _resolve_feature(graph.context, feature_name, feature_value)
    return _broadcast_context(
        value, graph.edge_sets[edge_set_name].component_ids())


def _pool_items_to_context(piece, num_components, reduce_type, value):
    if reduce_type not in _REDUCE_TYPES:
        raise ValueError(f"unknown reduce_type {reduce_type!r}")
    comp = _masked_ids(piece.mask(), piece.component_ids(), num_components)
    # component ids are non-decreasing by construction and padding rows
    # map to num_components at the end: context pooling is always sorted
    return registry.segment_reduce(value, comp, num_components, reduce_type,
                                   sorted_ids=True)


def pool_nodes_to_context(graph: GraphTensor, node_set_name: str,
                          reduce_type: str = "sum", *,
                          feature_name: str | None = None,
                          feature_value=None) -> torch.Tensor:
    """Aggregate node values per graph component."""
    ns = graph.node_sets[node_set_name]
    value = _resolve_feature(ns, feature_name, feature_value)
    return _pool_items_to_context(ns, graph.num_components, reduce_type,
                                  value)


def pool_edges_to_context(graph: GraphTensor, edge_set_name: str,
                          reduce_type: str = "sum", *,
                          feature_name: str | None = None,
                          feature_value=None) -> torch.Tensor:
    es = graph.edge_sets[edge_set_name]
    value = _resolve_feature(es, feature_name, feature_value)
    return _pool_items_to_context(es, graph.num_components, reduce_type,
                                  value)


def node_degree(graph: GraphTensor, edge_set_name: str,
                tag: str) -> torch.Tensor:
    """Valid-edge degree of each node at endpoint `tag`, as an exact
    int32 count."""
    es = graph.edge_sets[edge_set_name]
    idx, node_set_name = _edge_endpoint(graph, edge_set_name, tag)
    num_nodes = graph.node_sets[node_set_name].capacity
    seg_ids = _masked_ids(es.mask(), idx, num_nodes)
    return registry.segment_count(seg_ids, num_nodes, dtype=torch.int32)
