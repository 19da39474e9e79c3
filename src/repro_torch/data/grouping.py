"""Group merge/pad — the part of `repro.data.grouping` the serving path
runs (`merge_and_pad`, `sort_edges_by_target`), copied and held to the
original by tests/test_torch_host_parity.py.  `BatchPlan`/`build_batch`
come with the training slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.graph_tensor import Adjacency, EdgeSet, GraphTensor
from repro_torch.data.batching import (SizeConstraints, merge_graphs,
                                       pad_to_sizes)


def sort_edges_by_target(graph: GraphTensor) -> GraphTensor:
    """Stable-sort every edge set of a merged (unpadded) scalar graph by
    (component, target id).  Component node-id offsets are monotone, so
    the result is also globally non-decreasing in target — the layout
    segment reductions can scan as contiguous runs.

    Edge sets whose adjacency arrays carry dummy slots (an input graph
    with 0 valid edges still contributes 1 array slot, so
    ``len(src) != sizes.sum()``) are left untouched: their segmentation
    is not recoverable here.  The check is a pure function of the data,
    so every producer skips (or sorts) identically."""
    edge_sets = {}
    for name, es in graph.edge_sets.items():
        src = np.asarray(es.adjacency.source)
        tgt = np.asarray(es.adjacency.target)
        sizes = np.asarray(es.sizes)
        if len(src) != int(sizes.sum()):
            edge_sets[name] = es
            continue
        comp = np.repeat(np.arange(len(sizes)), sizes)
        order = np.lexsort((tgt, comp))  # stable; primary comp, then tgt
        edge_sets[name] = EdgeSet(
            es.sizes,
            Adjacency(src[order], tgt[order],
                      es.adjacency.source_name, es.adjacency.target_name),
            {k: np.asarray(v)[order] for k, v in es.features.items()},
            es.capacity)
    return GraphTensor(graph.context, dict(graph.node_sets), edge_sets)


def merge_and_pad(graphs: Sequence[GraphTensor], sizes: SizeConstraints, *,
                  sort_by_target: bool = False) -> GraphTensor:
    """One component group: merge (each graph -> one component),
    optionally reorder edges by target, then pad."""
    merged = merge_graphs(graphs)
    if sort_by_target:
        merged = sort_edges_by_target(merged)
    return pad_to_sizes(merged, sizes)
