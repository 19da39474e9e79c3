"""Batch planning + group merge/pad — a copy of `repro.data.grouping`,
held to the original by tests/test_torch_host_parity.py.

    (dataset order, seed, epoch, step, rank/world, num_replicas)
        -> one padded (super-)batch

`BatchPlan` owns the pure index math: the per-epoch permutation, the
per-rank step slice, and the per-replica component-group split.
`build_batch` owns the array work: merge each group into one scalar
GraphTensor (paper §3.2) and pad it to `SizeConstraints`, stacking groups
on a leading ``[R, ...]`` axis when `num_replicas` is set.  Every batch is
a pure function of the plan and the item list, so every producer — the
in-process `GraphBatcher`, a `StoreProvider` — emits the reference's
batches array for array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph_tensor import (Adjacency, EdgeSet, GraphTensor,
                                           stack_graphs)
from repro_torch.data.batching import (SizeConstraints, merge_graphs,
                                       pad_to_sizes)


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The epoch-shuffle generator: (seed, epoch) -> Generator.  The one
    owner of this derivation — every producer that re-derives an epoch's
    permutation keys the generator identically."""
    return np.random.default_rng((seed, epoch))


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Deterministic mapping from (epoch, step) to dataset indices.

    * ``batch_size`` — global batch (across all ranks).
    * ``rank``/``world`` — this consumer's shard of each step (world=1 on
      one device).
    * ``num_replicas=R`` — this rank's items are split into R contiguous
      component groups, stacked ``[R, ...]``; ``None`` keeps the
      one-scalar-batch contract.
    * ``edges_sorted_by_target`` — emit merged batches with each edge
      set's edges stable-sorted by (component, target id): a pure
      reordering of the same edge multiset (message passing is
      permutation-invariant over edges), and the layout bit the kernel
      registry reads to pick the CSR-run kernels.
    """

    batch_size: int
    seed: int = 0
    rank: int = 0
    world: int = 1
    num_replicas: Optional[int] = None
    edges_sorted_by_target: bool = False

    def __post_init__(self):
        if self.batch_size % self.world:
            raise ValueError(f"batch_size {self.batch_size} not divisible "
                             f"by world {self.world}")
        if self.num_replicas is not None:
            if self.num_replicas < 1:
                raise ValueError(f"num_replicas must be >= 1, "
                                 f"got {self.num_replicas}")
            if self.per_rank % self.num_replicas:
                raise ValueError(
                    f"per-rank batch {self.per_rank} not divisible by "
                    f"num_replicas {self.num_replicas}")

    @property
    def per_rank(self) -> int:
        return self.batch_size // self.world

    @property
    def per_group(self) -> int:
        return self.per_rank // (self.num_replicas or 1)

    def order(self, epoch: int, n_items: int) -> np.ndarray:
        """The epoch's dataset permutation: (seed, epoch) -> order."""
        return epoch_rng(self.seed, epoch).permutation(n_items)

    def num_steps(self, n_items: int) -> int:
        return n_items // self.batch_size

    def step_indices(self, order: np.ndarray, step: int) -> np.ndarray:
        """This rank's dataset indices for one step."""
        lo = step * self.batch_size + self.rank * self.per_rank
        return order[lo:lo + self.per_rank]


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
    optionally reorder edges per `BatchPlan.edges_sorted_by_target`,
    then pad."""
    merged = merge_graphs(graphs)
    if sort_by_target:
        merged = sort_edges_by_target(merged)
    return pad_to_sizes(merged, sizes)


def step_size_constraints(plan: BatchPlan,
                          sizes: SizeConstraints) -> SizeConstraints:
    """The constraints one step's batch is actually padded to.

    Super-batch mode (``num_replicas`` set): `sizes` is already the
    PER-GROUP constraint, used as given.  Otherwise `sizes` is the GLOBAL
    batch constraint and this rank pads to its 1/world share."""
    if plan.num_replicas is not None or plan.world == 1:
        return sizes
    return SizeConstraints(
        total_num_components=plan.per_rank + 1,
        total_num_nodes={k: max(v // plan.world, 8)
                         for k, v in sizes.total_num_nodes.items()},
        total_num_edges={k: max(v // plan.world, 8)
                         for k, v in sizes.total_num_edges.items()})


def build_batch(graphs: Sequence[GraphTensor], plan: BatchPlan,
                sizes: SizeConstraints) -> GraphTensor:
    """Assemble one step's batch from this rank's `per_rank` graphs (in
    plan order).  With ``num_replicas=R``: R groups merged+padded to the
    per-group `sizes` and stacked ``[R, ...]``; otherwise one scalar
    GraphTensor padded to `sizes`."""
    if len(graphs) != plan.per_rank:
        raise ValueError(f"expected {plan.per_rank} graphs for one step, "
                         f"got {len(graphs)}")
    if plan.num_replicas is None:
        return merge_and_pad(graphs, sizes,
                             sort_by_target=plan.edges_sorted_by_target)
    groups = [
        merge_and_pad(graphs[r * plan.per_group:(r + 1) * plan.per_group],
                      sizes, sort_by_target=plan.edges_sorted_by_target)
        for r in range(plan.num_replicas)]
    return stack_graphs(groups)
