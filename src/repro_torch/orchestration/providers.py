"""DatasetProviders — the stream-owning piece of the orchestration layer
(counterpart of `repro.orchestration.providers`).

One iterator contract (the `GraphBatcher` shape) in front of every batch
source the port has:

  * `BatcherProvider`   — in-memory pre-sampled graphs via `GraphBatcher`;
  * `ServiceProvider`   — a sampler fleet
    (`repro_torch.sampling_service.SamplingService`: forked, threaded or
    out-of-core dial-in workers), or anything else already speaking the
    batcher contract; sampling then runs off the trainer's thread;
  * `StoreProvider`     — any `GraphStore` (in-memory OR an out-of-core
    `repro_torch.storage.MmapGraphStore`): samples each step's roots on
    the fly through Algorithm 1 and batches them with the shared
    `BatchPlan`/`build_batch` math, so its stream is bit-identical to a
    `BatcherProvider` over the same roots' subgraphs;
  * `IteratorProvider`  — wraps any ``fn(epoch) -> iterator`` (what
    `runner.run(train_batches=)` compiles down to).

The contract:

  * ``num_steps`` — steps per epoch (may raise if the source cannot know);
  * ``epoch(e, start_step=s)`` — deterministic stream for epoch ``e``,
    skipping ``s`` steps (the ``(seed, epoch, step) -> batch`` purity
    every producer honours);
  * each item is a padded numpy GraphTensor — or a ``(graph, labels)``
    pair for sources that pre-compute labels (the Trainer then skips
    `Task.labels`);
  * ``edges_sorted_by_target`` — the stream's edge-layout bit (a
    performance-only hint for `kernels.registry.layout`; None = unknown);
  * ``close()`` — release owned resources (idempotent).
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import (BatchPlan, build_batch,
                                       step_size_constraints)
from repro_torch.data.pipeline import GraphBatcher
from repro_torch.data.sampling import (GraphStore, SamplingSpec,
                                       sample_subgraph, seed_rng)


class DatasetProvider:
    """The stream contract the Trainer consumes (see module docstring)."""

    edges_sorted_by_target: Optional[bool] = None

    @property
    def num_steps(self) -> int:
        raise NotImplementedError

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "DatasetProvider":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BatcherProvider(DatasetProvider):
    """Pre-sampled in-memory graphs behind the contract (wraps
    `GraphBatcher` — same constructor surface)."""

    def __init__(self, graphs: Sequence[GraphTensor], batch_size: int,
                 sizes: SizeConstraints, *, seed: int = 0, rank: int = 0,
                 world: int = 1, num_replicas: Optional[int] = None,
                 edges_sorted_by_target: bool = True):
        self.batcher = GraphBatcher(
            graphs, batch_size, sizes, seed=seed, rank=rank, world=world,
            num_replicas=num_replicas,
            edges_sorted_by_target=edges_sorted_by_target)
        self.edges_sorted_by_target = edges_sorted_by_target

    @property
    def num_steps(self) -> int:
        return self.batcher.num_steps

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator:
        return self.batcher.epoch(epoch, start_step=start_step)


class ServiceProvider(DatasetProvider):
    """A sampler fleet behind the contract.

    ``source`` is anything with the batcher shape — a `SamplingService`
    or another provider.  ``own=True`` makes `close()` close the source
    (the Trainer closes providers it is handed only through this flag,
    so a service shared across runs stays up).  ``label_fn`` computes
    labels host-side per batch (the ``runner.run(label_fn=)`` contract);
    without it the Task extracts labels itself.  The layout bit is the
    source's plan's, None when the source carries no plan."""

    def __init__(self, source, *, own: bool = False,
                 label_fn: Optional[Callable] = None):
        self.source = source
        self.own = own
        self.label_fn = label_fn
        plan = getattr(source, "plan", None)
        self.edges_sorted_by_target = getattr(
            plan, "edges_sorted_by_target", None)

    @property
    def num_steps(self) -> int:
        return self.source.num_steps

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator:
        stream = self.source.epoch(epoch, start_step=start_step)
        if self.label_fn is None:
            return stream
        return ((g, self.label_fn(g)) for g in stream)

    def close(self) -> None:
        if self.own:
            self.source.close()


class StoreProvider(DatasetProvider):
    """Sample-on-demand provider over any `GraphStore` — including an
    out-of-core `repro_torch.storage.MmapGraphStore`.

    Each step samples exactly that step's roots (Algorithm 1 with the
    per-root `seed_rng(base_seed, root)` generators) and builds the batch
    through the shared `BatchPlan`/`build_batch` math, so the stream is
    bit-identical to a `BatcherProvider` over those roots' subgraphs with
    the same plan — while holding at most one step's subgraphs in
    memory."""

    def __init__(self, store: GraphStore, spec: SamplingSpec,
                 roots: Sequence[int], *, batch_size: int,
                 sizes: SizeConstraints, seed: int = 0, rank: int = 0,
                 world: int = 1, num_replicas: Optional[int] = None,
                 base_seed: int = 0, edges_sorted_by_target: bool = True):
        self.store = store
        self.spec = spec
        self.roots = np.asarray(roots)
        self.plan = BatchPlan(batch_size, seed=seed, rank=rank, world=world,
                              num_replicas=num_replicas,
                              edges_sorted_by_target=edges_sorted_by_target)
        self.sizes = sizes
        self.base_seed = base_seed
        self.edges_sorted_by_target = edges_sorted_by_target

    @property
    def num_steps(self) -> int:
        return self.plan.num_steps(len(self.roots))

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator:
        order = self.plan.order(epoch, len(self.roots))
        sizes = step_size_constraints(self.plan, self.sizes)
        for step in range(start_step, self.num_steps):
            idx = self.plan.step_indices(order, step)
            graphs = [sample_subgraph(self.store, self.spec, int(r),
                                      seed_rng(self.base_seed, int(r)))
                      for r in (self.roots[i] for i in idx)]
            yield build_batch(graphs, self.plan, sizes)


class IteratorProvider(DatasetProvider):
    """Wrap any ``fn(epoch) -> iterator`` of graphs or (graph, labels)
    pairs.  ``num_steps`` is optional (raises when unknown);
    ``start_step`` skips by consuming the iterator."""

    def __init__(self, fn: Callable[[int], Iterator], *,
                 num_steps: Optional[int] = None,
                 edges_sorted_by_target: Optional[bool] = None):
        self.fn = fn
        self._num_steps = num_steps
        self.edges_sorted_by_target = edges_sorted_by_target

    @property
    def num_steps(self) -> int:
        if self._num_steps is None:
            raise ValueError("this IteratorProvider source does not "
                             "declare steps-per-epoch (pass num_steps=)")
        return self._num_steps

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator:
        it = self.fn(epoch)
        return itertools.islice(it, start_step, None) if start_step else it
