"""Coordinator — shard-ownership, liveness and rebalance for the fleet
(a copy of `repro.sampling_service.coordinator`).

The coordinator is pure control plane: it never touches batch payloads.
It assigns each epoch's steps to workers (round-robin striping, the same
``steps[w::W]`` idiom as `distributed_sample`'s seed shards), tracks a
per-worker watermark — the latest (epoch, step) each worker has delivered
— and, when a worker dies, reassigns that worker's undelivered steps to
the survivors.  Because every step's batch is a pure function of the
shared `BatchPlan` (see `repro_torch.data.grouping`), re-execution is
idempotent: the same fault-tolerance semantics as
`repro_torch.distributed.fault_tolerance` checkpoints and the sampler's
on-disk shards (re-run the unit, get the identical bytes).

With a ``respawn_fn`` the coordinator additionally *replaces* a dead
worker with a freshly spawned one under the same worker id (at most once
per worker per epoch — a replacement that dies immediately falls back to
the survivors), so the fleet returns to full width instead of survivors
permanently absorbing the dead worker's share of the stream.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import Optional

from repro_torch.sampling_service import frames as wire


@dataclasses.dataclass
class WorkerHandle:
    """Trainer-side view of one sampler worker."""

    worker_id: int
    sock: socket.socket             # trainer end of the pair
    process: object = None          # mp.Process, threading.Thread, or None
    alive: bool = True
    watermark: Optional[tuple[int, int]] = None   # latest (epoch, step) seen

    def process_alive(self) -> bool:
        if not self.alive:
            return False
        if self.process is None:
            return True
        return bool(self.process.is_alive())

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class DeadFleetError(RuntimeError):
    """Every worker is gone — the epoch cannot complete."""


class Coordinator:
    def __init__(self, workers: list[WorkerHandle],
                 respawn_fn: Optional[callable] = None):
        self.workers = {w.worker_id: w for w in workers}
        self.epoch: Optional[int] = None
        # step -> worker_id (current ownership; rewritten on rebalance)
        self.owner: dict[int, int] = {}
        # worker_id -> steps assigned but not yet delivered
        self.outstanding: dict[int, set[int]] = {}
        # worker_id -> fresh WorkerHandle (None = no respawn)
        self.respawn_fn = respawn_fn
        # dead handles kept for lifecycle cleanup (process joins)
        self.retired: list[WorkerHandle] = []
        self._respawned_this_epoch: set[int] = set()

    # -- assignment ----------------------------------------------------------

    def alive(self) -> list[WorkerHandle]:
        return [w for w in self.workers.values() if w.alive]

    def assign_epoch(self, epoch: int, steps: list[int]) -> None:
        """Stripe `steps` over the live workers and send ASSIGN frames.
        A send that fails (worker already dead — EPIPE) marks the worker
        and redistributes its stripe; only an empty fleet raises."""
        self.epoch = epoch
        self.owner = {}
        self.outstanding = {}
        self._respawned_this_epoch = set()
        # sweep silent deaths: a worker that died AFTER flushing its whole
        # stripe is never caught by the client's read path (nothing blocks
        # on its socket), so detect-and-respawn here — epoch starts always
        # begin at full width when a respawn_fn is configured
        for wid, w in list(self.workers.items()):
            if w.alive and not w.process_alive():
                self.mark_dead(wid)
                self.respawn(wid)
        self._distribute(steps)

    def _distribute(self, steps: list[int]) -> None:
        pending = list(steps)
        while pending:
            live = self.alive()
            if not live:
                raise DeadFleetError(
                    f"no live sampler workers for {len(pending)} steps")
            failed: list[int] = []
            for i, w in enumerate(live):
                mine = pending[i::len(live)]
                if not mine:
                    continue
                try:
                    wire.send_frame(w.sock, wire.ASSIGN,
                                    {"epoch": self.epoch, "steps": mine})
                except OSError:
                    self.mark_dead(w.worker_id)
                    self.respawn(w.worker_id)  # next round may assign to it
                    failed += mine
                    continue
                self.owner.update({s: w.worker_id for s in mine})
                self.outstanding.setdefault(w.worker_id, set()).update(mine)
            pending = failed

    def owner_of(self, step: int) -> WorkerHandle:
        return self.workers[self.owner[step]]

    # -- bookkeeping (driven by the client's receive loop) -------------------

    def record_batch(self, worker_id: int, epoch: int, step: int) -> None:
        w = self.workers[worker_id]
        w.watermark = (epoch, step)
        if epoch == self.epoch:
            self.outstanding.get(worker_id, set()).discard(step)

    def watermarks(self) -> dict[int, Optional[tuple[int, int]]]:
        """Per-worker (epoch, step) progress — the liveness/lag signal a
        monitoring loop would export."""
        return {wid: w.watermark for wid, w in self.workers.items()}

    # -- failure handling ----------------------------------------------------

    def mark_dead(self, worker_id: int) -> None:
        w = self.workers[worker_id]
        if w.alive:
            w.close()

    def respawn(self, worker_id: int) -> bool:
        """Replace a dead worker with a fresh handle under the same id
        (coordinator-driven respawn).  At most once per worker per epoch,
        so a replacement that dies immediately cannot respawn-loop; the
        stream then continues on the survivors as before."""
        if (self.respawn_fn is None
                or worker_id in self._respawned_this_epoch):
            return False
        self._respawned_this_epoch.add(worker_id)
        try:
            fresh = self.respawn_fn(worker_id)
        except Exception:  # noqa: BLE001 — spawn failure = no respawn
            return False
        if fresh is None:
            return False
        self.retired.append(self.workers[worker_id])
        self.workers[worker_id] = fresh
        return True

    def rebalance(self, worker_id: int) -> list[int]:
        """Reassign a dead worker's undelivered steps — to a freshly
        respawned replacement (when a respawn_fn is configured) plus the
        survivors.  Returns the reassigned steps.  Idempotent
        re-execution: the new owner rebuilds identical batches from the
        shared plan."""
        self.mark_dead(worker_id)
        pending = sorted(self.outstanding.pop(worker_id, set()))
        self.respawn(worker_id)
        if not pending:
            return []
        if not self.alive():
            raise DeadFleetError(
                f"worker {worker_id} died with {len(pending)} undelivered "
                "steps and no surviving workers to take them")
        self._distribute(pending)
        return pending

    def stop_all(self) -> None:
        for w in self.alive():
            try:
                wire.send_frame(w.sock, wire.STOP)
            except OSError:
                pass
