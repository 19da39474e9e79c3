"""StreamClient — the consumer half: GraphBatcher's exact iterator
contract, backed by the sampler fleet (a copy of
`repro.sampling_service.client`).

``client.epoch(epoch, start_step=...)`` yields the same deterministic
step-ordered stream of padded (super-)batches that
``GraphBatcher.epoch`` produces in-process — bit-identical content, any
worker count — so the trainer cannot tell the two apart.

Delivery: the client knows which worker owns the step it needs next
(coordinator ownership map) and reads frames only from that worker's
socket; workers that are ahead simply block in ``sendall`` against their
bounded socket buffer (the per-client backpressure queue).  Frames for
later steps that arrive early (only after a rebalance reshuffles
ownership) go into a small reorder buffer.  A read timeout triggers a
liveness check; a dead worker's undelivered steps are rebalanced to the
survivors and the stream continues without a gap.
"""
from __future__ import annotations

import socket
from typing import Iterator

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.grouping import BatchPlan
from repro_torch.sampling_service import frames as wire
from repro_torch.sampling_service.coordinator import Coordinator, WorkerHandle


class StreamClient:
    def __init__(self, coordinator: Coordinator, plan: BatchPlan,
                 n_items: int, *, poll_interval: float = 0.2):
        self.coordinator = coordinator
        self.plan = plan
        self.n_items = n_items
        self.poll_interval = poll_interval
        self._closed = False

    @property
    def num_steps(self) -> int:
        return self.plan.num_steps(self.n_items)

    def epoch(self, epoch: int, *, start_step: int = 0
              ) -> Iterator[GraphTensor]:
        """Deterministic epoch stream; `start_step` skips ahead (restart),
        matching ``GraphBatcher.epoch``."""
        if self._closed:
            raise RuntimeError("StreamClient is closed")
        steps = list(range(start_step, self.num_steps))
        self.coordinator.assign_epoch(epoch, steps)
        buffer: dict[int, GraphTensor] = {}
        delivered: set[int] = set()
        for step in steps:
            while step not in buffer:
                self._pump(epoch, self.coordinator.owner_of(step), buffer,
                           delivered)
            delivered.add(step)
            yield buffer.pop(step)

    def close(self) -> None:
        """Idempotent shutdown: stop reading and close every worker
        socket so a blocked `recv` (or a worker blocked in `sendall`)
        unblocks immediately.  The client owns no reader threads — reads
        happen inline in `epoch` with a bounded `poll_interval` timeout —
        so pytest teardown / interpreter exit can never block on a dead
        coordinator: any in-flight `_pump` wakes within `poll_interval`
        and the next `epoch` call raises instead of hanging."""
        if self._closed:
            return
        self._closed = True
        for w in self.coordinator.workers.values():
            w.close()

    # -- receive loop --------------------------------------------------------

    def _pump(self, epoch: int, w: WorkerHandle, buffer: dict,
              delivered: set) -> None:
        """Read one frame from `w`, or handle its death."""
        if self._closed:
            raise RuntimeError("StreamClient closed mid-epoch")
        try:
            kind, meta, graph = wire.recv_frame(w.sock,
                                                timeout=self.poll_interval)
        except socket.timeout:
            if w.process_alive():
                return  # just slow — keep waiting
            self.coordinator.rebalance(w.worker_id)
            return
        except (EOFError, wire.WireError, OSError):
            # died mid-frame / closed: drop the partial step too — it is
            # still in `outstanding`, so rebalance re-executes it
            self.coordinator.rebalance(w.worker_id)
            return
        if kind == wire.BATCH:
            b_epoch, b_step = int(meta["epoch"]), int(meta["step"])
            self.coordinator.record_batch(int(meta["worker"]), b_epoch,
                                          b_step)
            if b_epoch != epoch:
                return  # stale frame from an abandoned epoch — skim off
            if b_step in delivered or b_step in buffer:
                return  # duplicate after a racy rebalance — idempotent drop
            buffer[b_step] = graph
        elif kind == wire.DONE:
            self.coordinator.record_batch(int(meta["worker"]),
                                          int(meta["epoch"]),
                                          int(meta["step"]))
        elif kind == wire.ERROR:
            raise RuntimeError(
                f"sampler worker {meta.get('worker')} failed: "
                f"{meta.get('error')}")
        else:
            raise wire.WireError(f"unexpected frame kind {kind!r}")
