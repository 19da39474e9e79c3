"""Input pipeline: sampled graphs -> merged+padded fixed-shape batches — a
copy of `repro.data.pipeline`, held to the original by
tests/test_torch_host_parity.py.

`GraphBatcher` shuffles, batches, merges and pads, shards per
data-parallel rank, and `prefetch` runs any such stream on a background
thread.  Deterministic: (seed, epoch, step) -> batch.  The index math and
the group merge/pad live in `repro_torch.data.grouping`, shared with
`repro_torch.orchestration.providers.StoreProvider`, so every producer
emits the same batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import (BatchPlan, build_batch,
                                       step_size_constraints)


class GraphBatcher:
    """Batches sampled graphs into padded fixed-shape GraphTensors.

    * ``num_replicas=None``: each step merges ``batch_size`` graphs into
      ONE scalar GraphTensor padded to ``sizes``.
    * ``num_replicas=R``: this rank's ``batch_size // world`` graphs are
      split into ``R`` contiguous component groups, each merged and
      padded to ``sizes`` (the PER-GROUP constraint in this mode) and
      stacked on a leading ``[R, ...]`` axis.

    ``edges_sorted_by_target`` (default True) makes every merged batch
    ship each edge set's edges stable-sorted by (component, target id) —
    the layout the run kernels exploit (`registry.layout`).  Pure edge
    reordering: pooled results are identical either way.
    """

    def __init__(self, graphs: Sequence[GraphTensor], batch_size: int,
                 sizes: SizeConstraints, *, seed: int = 0,
                 rank: int = 0, world: int = 1, drop_remainder: bool = True,
                 num_replicas: Optional[int] = None,
                 edges_sorted_by_target: bool = True):
        self.graphs = list(graphs)
        self.plan = BatchPlan(batch_size, seed=seed, rank=rank, world=world,
                              num_replicas=num_replicas,
                              edges_sorted_by_target=edges_sorted_by_target)
        self.batch_size = batch_size
        self.sizes = sizes
        self.seed = seed
        self.rank = rank
        self.world = world
        self.per_rank = self.plan.per_rank
        self.num_replicas = num_replicas
        self.per_group = self.plan.per_group

    @property
    def num_steps(self) -> int:
        """Steps per epoch (the shared batch-source contract)."""
        return self.plan.num_steps(len(self.graphs))

    def epoch(self, epoch: int, *, start_step: int = 0
              ) -> Iterator[GraphTensor]:
        """Deterministic epoch stream; `start_step` skips ahead."""
        order = self.plan.order(epoch, len(self.graphs))
        sizes = step_size_constraints(self.plan, self.sizes)
        for step in range(start_step, self.plan.num_steps(len(self.graphs))):
            idx = self.plan.step_indices(order, step)
            yield build_batch([self.graphs[i] for i in idx], self.plan,
                              sizes)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run iterator `it` on a background thread, up to `depth` items
    ahead (host-side pipelining).

    * an exception in the source iterator is re-raised in the consumer
      (after any already-buffered items) — never a silent early end;
    * closing the generator early (``break``/``.close()``/GC) unblocks
      and JOINS the worker thread instead of leaking it blocked on a
      full queue.
    Items and the stop mark cross threads only through the queue, and the
    worker's error is read only after the worker has been joined.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    cancel = threading.Event()
    err: list[BaseException] = []

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer cancelled."""
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            err.append(e)
        finally:
            _put(stop)

    t = threading.Thread(target=worker, daemon=True, name="graph-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                t.join()
                if err:
                    raise err[0]
                return
            yield item
    finally:
        cancel.set()
        t.join(timeout=10.0)
