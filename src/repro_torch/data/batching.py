"""Host-side batching: merge a batch of graphs into one scalar GraphTensor
with components (paper §3.2), then pad to fixed SizeConstraints — a copy
of `repro.data.batching`, held to the original by
tests/test_torch_host_parity.py.

All functions here operate on numpy (the ragged world); the output
GraphTensor contains numpy arrays ready for `repro_torch.core.graph_tensor.to_device`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                     GraphTensor, NodeSet)


@dataclasses.dataclass(frozen=True)
class SizeConstraints:
    """Static capacities for the padded GraphTensor (paper §3.2/§8.4:
    'padding inputs to fixed sizes (as required for Cloud TPUs)')."""

    total_num_components: int
    total_num_nodes: Mapping[str, int]
    total_num_edges: Mapping[str, int]

    def validate(self, graph: GraphTensor):
        """Raise ValueError naming the offending set when `graph` cannot fit
        these constraints (a bare assert would vanish under ``python -O``,
        and the batcher is where a user-facing shape error must be
        actionable)."""
        for name, ns in graph.node_sets.items():
            if name not in self.total_num_nodes:
                raise ValueError(
                    f"node set {name!r} has no capacity in "
                    f"SizeConstraints.total_num_nodes "
                    f"(known: {sorted(self.total_num_nodes)})")
            if ns.capacity > self.total_num_nodes[name]:
                raise ValueError(
                    f"node set {name!r}: {ns.capacity} nodes exceed "
                    f"total_num_nodes[{name!r}] = "
                    f"{self.total_num_nodes[name]}")
        for name, es in graph.edge_sets.items():
            if name not in self.total_num_edges:
                raise ValueError(
                    f"edge set {name!r} has no capacity in "
                    f"SizeConstraints.total_num_edges "
                    f"(known: {sorted(self.total_num_edges)})")
            if es.capacity > self.total_num_edges[name]:
                raise ValueError(
                    f"edge set {name!r}: {es.capacity} edges exceed "
                    f"total_num_edges[{name!r}] = "
                    f"{self.total_num_edges[name]}")


def merge_graphs(graphs: Sequence[GraphTensor]) -> GraphTensor:
    """Concatenate a list of (numpy) GraphTensors into one scalar
    GraphTensor; each input graph becomes one component.  Node indices on
    edges are offset by the cumulative node counts (paper §3.2)."""
    assert graphs, "empty batch"
    g0 = graphs[0]
    ctx_sizes = np.concatenate([np.asarray(g.context.sizes) for g in graphs])
    ctx_feats = {
        k: np.concatenate([np.asarray(g.context.features[k]) for g in graphs])
        for k in g0.context.features}

    node_sets = {}
    offsets = {name: np.zeros(len(graphs) + 1, np.int64)
               for name in g0.node_sets}
    for name in g0.node_sets:
        sizes_list, feats_list = [], []
        for i, g in enumerate(graphs):
            ns = g.node_sets[name]
            n_valid = int(np.asarray(ns.sizes).sum())
            assert n_valid == ns.capacity, \
                "merge expects unpadded inputs (valid == capacity)"
            offsets[name][i + 1] = offsets[name][i] + n_valid
            sizes_list.append(np.asarray(ns.sizes))
            feats_list.append(ns.features)
        feats = {k: np.concatenate([np.asarray(f[k]) for f in feats_list])
                 for k in g0.node_sets[name].features}
        sizes = np.concatenate(sizes_list).astype(np.int32)
        node_sets[name] = NodeSet(sizes, feats,
                                  int(offsets[name][len(graphs)]))

    edge_sets = {}
    for name in g0.edge_sets:
        es0 = g0.edge_sets[name]
        src_name = es0.adjacency.source_name
        tgt_name = es0.adjacency.target_name
        sizes_list, feats_list, srcs, tgts = [], [], [], []
        for i, g in enumerate(graphs):
            es = g.edge_sets[name]
            sizes_list.append(np.asarray(es.sizes))
            feats_list.append(es.features)
            srcs.append(np.asarray(es.adjacency.source)
                        + offsets[src_name][i])
            tgts.append(np.asarray(es.adjacency.target)
                        + offsets[tgt_name][i])
        sizes = np.concatenate(sizes_list).astype(np.int32)
        feats = {k: np.concatenate([np.asarray(f[k]) for f in feats_list])
                 for k in es0.features}
        src = np.concatenate(srcs).astype(np.int32)
        tgt = np.concatenate(tgts).astype(np.int32)
        edge_sets[name] = EdgeSet(sizes, Adjacency(src, tgt, src_name,
                                                   tgt_name),
                                  feats, len(src))

    return GraphTensor(Context(ctx_sizes.astype(np.int32), ctx_feats),
                       node_sets, edge_sets)


def pad_to_sizes(graph: GraphTensor, sizes: SizeConstraints) -> GraphTensor:
    """Pad to static capacities.  Padding nodes/edges go into one trailing
    padding component with context weight 0; padding edges point at the
    first padding node (or node 0 when a set is full) so indices stay in
    range but are masked out of every pooled reduction."""
    c_real = graph.num_components
    c_total = sizes.total_num_components
    if c_real >= c_total:
        raise ValueError(
            f"{c_real} components leave no slot for the padding component "
            f"(total_num_components = {c_total}); raise "
            "total_num_components to at least batch_size + 1")
    sizes.validate(graph)

    ctx_sizes = np.concatenate([
        np.asarray(graph.context.sizes),
        np.zeros(c_total - c_real, np.int32)])  # 0 => padding component
    ctx_feats = {
        k: _pad_leading(np.asarray(v), c_total)
        for k, v in graph.context.features.items()}

    node_sets = {}
    pad_node_idx = {}
    for name, ns in graph.node_sets.items():
        cap = sizes.total_num_nodes[name]
        n_valid = int(np.asarray(ns.sizes).sum())
        if n_valid > cap:
            raise ValueError(
                f"node set {name!r}: {n_valid} valid nodes exceed "
                f"total_num_nodes[{name!r}] = {cap}")
        pad_node_idx[name] = min(n_valid, cap - 1)
        new_sizes = np.concatenate([
            np.asarray(ns.sizes),
            np.zeros(c_total - c_real - 1, np.int32),
            np.asarray([cap - n_valid], np.int32)])
        feats = {k: _pad_leading(np.asarray(v), cap)
                 for k, v in ns.features.items()}
        node_sets[name] = NodeSet(new_sizes.astype(np.int32), feats, cap)

    edge_sets = {}
    for name, es in graph.edge_sets.items():
        cap = sizes.total_num_edges[name]
        e_valid = int(np.asarray(es.sizes).sum())
        if e_valid > cap:
            raise ValueError(
                f"edge set {name!r}: {e_valid} valid edges exceed "
                f"total_num_edges[{name!r}] = {cap}")
        new_sizes = np.concatenate([
            np.asarray(es.sizes),
            np.zeros(c_total - c_real - 1, np.int32),
            np.asarray([cap - e_valid], np.int32)])
        src = _pad_leading(np.asarray(es.adjacency.source), cap,
                           fill=pad_node_idx[es.adjacency.source_name])
        tgt = _pad_leading(np.asarray(es.adjacency.target), cap,
                           fill=pad_node_idx[es.adjacency.target_name])
        feats = {k: _pad_leading(np.asarray(v), cap)
                 for k, v in es.features.items()}
        edge_sets[name] = EdgeSet(new_sizes.astype(np.int32),
                                  Adjacency(src.astype(np.int32),
                                            tgt.astype(np.int32),
                                            es.adjacency.source_name,
                                            es.adjacency.target_name),
                                  feats, cap)

    return GraphTensor(Context(ctx_sizes.astype(np.int32), ctx_feats),
                       node_sets, edge_sets)


def _pad_leading(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    if arr.shape[0] >= total:
        return arr[:total]
    pad_shape = (total - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])


def find_size_constraints(graphs: Sequence[GraphTensor], batch_size: int,
                          *, slack: float = 1.1) -> SizeConstraints:
    """Derive capacities covering any `batch_size` of the given graphs —
    the dataset-profiling step the paper's Runner does before training."""
    max_nodes = {n: 0 for n in graphs[0].node_sets}
    max_edges = {n: 0 for n in graphs[0].edge_sets}
    for g in graphs:
        for n, ns in g.node_sets.items():
            max_nodes[n] = max(max_nodes[n], ns.capacity)
        for n, es in g.edge_sets.items():
            max_edges[n] = max(max_edges[n], es.capacity)
    return SizeConstraints(
        total_num_components=batch_size + 1,
        total_num_nodes={n: int(v * batch_size * slack) + 1
                         for n, v in max_nodes.items()},
        total_num_edges={n: int(v * batch_size * slack) + 1
                         for n, v in max_edges.items()})
