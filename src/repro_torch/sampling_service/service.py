"""SamplingService — spawn a sampler fleet and stream super-batches (a
copy of `repro.sampling_service.service`).

The user-facing handle that ties the pieces together: it derives the
shared `BatchPlan`, forks `num_workers` `SamplerWorker` processes (each
with a copy-on-write replica of the read-only `GraphStore` and one
socketpair to the trainer), and exposes the `GraphBatcher`-shaped
iterator through a `StreamClient` + `Coordinator`.

    service = SamplingService(store, spec, seeds, batch_size=16,
                              sizes=sizes, num_workers=2, num_replicas=8)
    for super_batch in service.epoch(0):
        ...                       # bit-identical to GraphBatcher's stream
    service.close()

Backends: ``"process"`` (default; `fork` multiprocessing — samplers never
import torch, so forking a CUDA-initialized trainer is safe: the child
runs numpy and sockets only, and freezes every object it inherits out of
its garbage collector, so it never frees an inherited tensor), ``"thread"``
(same protocol over the same sockets, for platforms without fork — no
parallel speedup, but identical semantics and wire path), or ``"dial"``
(out-of-core: workers are NOT spawned here — they connect over TCP
knowing only this service's address plus a `GraphDirectory` path, and
receive their shard assignment and sampling config over the wire; see
`repro_torch.storage.fleet`/`repro_torch.storage.dial_worker`.
``store`` may be ``None``
— the trainer never needs the graph).

``respawn=True`` enables coordinator-driven worker respawn: a dead
worker is replaced in place by a freshly spawned one under the same id
(at most once per worker per epoch), so the fleet returns to full width
instead of survivors permanently absorbing its share of the stream.
"""
from __future__ import annotations

import atexit
import gc
import multiprocessing as mp
import os
import threading
import warnings
import weakref
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import BatchPlan
from repro_torch.data.sampling import GraphStore, SamplingSpec
from repro_torch.sampling_service.client import StreamClient
from repro_torch.sampling_service.coordinator import (Coordinator,
                                                      WorkerHandle)
from repro_torch.sampling_service.sampler_worker import worker_main
from repro_torch.sampling_service.transport import (InProcessTransport,
                                                    Transport)

# Fleets still alive at interpreter exit get a bounded close() BEFORE
# multiprocessing's own atexit hook runs — that hook join()s children
# with NO timeout, so one wedged worker would hang exit forever (the
# exact pytest-teardown failure mode a hung worker would cause).
# atexit runs handlers LIFO: this one registers after multiprocessing's
# (imported above), so it runs first.
#
# Belt AND suspenders: `_SPAWNED` records every worker process this
# process ever forked, independent of coordinator handle bookkeeping —
# a worker can survive SIGTERM (observed: a child forked off a
# signal-masked thread swallows it; only SIGKILL is unconditional), so
# the reaper kills stragglers by registry, not by fleet state.
_LIVE_FLEETS: "weakref.WeakSet[SamplingService]" = weakref.WeakSet()
_SPAWNED: list = []  # (owner_pid, mp.Process) for every forked worker


def _kill_stragglers(procs, timeout: float = 1.0) -> None:
    me = os.getpid()
    for owner, p in procs:
        if owner != me or not hasattr(p, "kill"):
            continue  # not ours to reap / thread backend
        try:
            if p.is_alive():
                p.kill()
            p.join(timeout)
        except (OSError, ValueError):
            # ESRCH/closed-handle races with normal exit; nothing to reap
            pass


def _proc_dead(owner: int, p) -> bool:
    """True when `p` is our child and verifiably gone (prunable)."""
    if owner != os.getpid():
        return False  # fork-inherited handle: not ours to test or prune
    try:
        return not p.is_alive()
    except (OSError, ValueError):
        return False  # closed/foreign handles stay listed


def _prune_spawn_registry() -> None:
    """Drop joined workers from the global registry — respawn churn in a
    long-lived trainer must not grow it without bound."""
    _SPAWNED[:] = [(o, p) for (o, p) in _SPAWNED if not _proc_dead(o, p)]


def _reap_fleets_at_exit() -> None:
    for svc in list(_LIVE_FLEETS):
        try:
            svc.close(timeout=1.0)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
    _kill_stragglers(_SPAWNED)


atexit.register(_reap_fleets_at_exit)


def _forked_worker_main(*args) -> None:
    """Entry of a forked worker.  The parent may hold CUDA tensors,
    streams and events (a trainer that already ran on the card); the
    child must never free one, since a CUDA call in a forked child is
    undefined.  `gc.freeze()` moves everything inherited out of the
    child's collector, so only objects the worker itself creates (numpy
    arrays, sockets) are ever collected."""
    gc.freeze()
    worker_main(*args)


class SamplingService:
    def __init__(self, store: Optional[GraphStore], spec: SamplingSpec,
                 seeds: Sequence[int], *, batch_size: int,
                 sizes: SizeConstraints, num_workers: int = 2,
                 num_replicas: Optional[int] = None, seed: int = 0,
                 rank: int = 0, world: int = 1, base_seed: int = 0,
                 backend: str = "process", respawn: bool = False,
                 transport: Optional[Transport] = None,
                 edges_sorted_by_target: bool = True,
                 num_shards: Optional[int] = None, listen_port: int = 0,
                 accept_timeout: float = 60.0,
                 on_listen: Optional[callable] = None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.plan = BatchPlan(batch_size, seed=seed, rank=rank, world=world,
                              num_replicas=num_replicas,
                              edges_sorted_by_target=edges_sorted_by_target)
        self.seeds = np.asarray(seeds)
        self.sizes = sizes
        if backend == "process" and "fork" not in mp.get_all_start_methods():
            backend = "thread"  # no fork (e.g. some non-POSIX hosts)
        self.backend = backend
        # worker channels come from the Transport (default: socketpair);
        # TcpTransport runs the identical protocol over loopback TCP
        self.transport = transport or InProcessTransport()
        self._worker_args = (store, spec, base_seed)
        self._closed = False
        self._owner_pid = os.getpid()
        self._spawned: list = []  # every process ever forked by this fleet
        self._lsock = None
        self.address = None
        if backend == "dial":
            if store is not None:
                raise ValueError(
                    "backend='dial': workers open the GraphDirectory "
                    "themselves; pass store=None")
            if respawn:
                raise ValueError("backend='dial' cannot respawn workers "
                                 "(the service does not own their spawn)")
            handles = self._accept_dial_fleet(
                spec, num_workers, num_shards or 1, base_seed,
                listen_port, accept_timeout, on_listen)
        elif store is None:
            raise ValueError(f"backend={backend!r} requires a store")
        else:
            handles = [self._spawn_worker(wid)
                       for wid in range(num_workers)]
        # respawn=True: a dead worker is replaced in place (the fleet
        # returns to full width) instead of survivors absorbing its steps
        self.coordinator = Coordinator(
            handles, respawn_fn=self._respawn_worker if respawn else None)
        self.client = StreamClient(self.coordinator, self.plan,
                                   len(self.seeds))
        _LIVE_FLEETS.add(self)

    def _accept_dial_fleet(self, spec, num_workers: int, num_shards: int,
                           base_seed: int, listen_port: int,
                           accept_timeout: float,
                           on_listen) -> list[WorkerHandle]:
        """Out-of-core fleet admission: listen, publish the address via
        `on_listen(address)` (the launcher's hook to spawn/point workers
        at us), then run the JOIN/SHARD/READY/CONFIG handshake."""
        # function-level import keeps the package dependency one-way at
        # import time (repro_torch.storage imports sampling_service, not
        # the other way round)
        from repro_torch.storage.fleet import accept_dial_workers
        transport = self.transport
        if not hasattr(transport, "listen"):
            from repro_torch.sampling_service.transport import TcpTransport
            transport = self.transport = TcpTransport()
        self._lsock = transport.listen(listen_port)
        self.address = self._lsock.getsockname()[:2]
        try:
            if on_listen is not None:
                on_listen(self.address)
            return accept_dial_workers(
                self._lsock, num_workers, num_shards=num_shards, spec=spec,
                plan=self.plan, sizes=self.sizes, seeds=self.seeds,
                base_seed=base_seed, accept_timeout=accept_timeout)
        except BaseException:  # noqa: BLE001 — admission failed: no fleet
            # object is returned to close the listener, so close it here
            self._lsock.close()
            raise

    def _spawn_worker(self, wid: int) -> WorkerHandle:
        store, spec, base_seed = self._worker_args
        # opportunistic registry pruning keeps both lists bounded by the
        # number of currently-live workers under respawn churn
        _prune_spawn_registry()
        me = os.getpid()
        self._spawned = [p for p in self._spawned
                         if not _proc_dead(me, p)]
        trainer_sock, worker_sock = self.transport.pair()
        args = (wid, worker_sock, store, spec, self.seeds, self.plan,
                self.sizes, base_seed)
        if self.backend == "process":
            proc = mp.get_context("fork").Process(
                target=_forked_worker_main, args=args, daemon=True,
                name=f"sampler-worker-{wid}")
            with warnings.catch_warnings():
                # Python warns that fork() in a multi-threaded process
                # (torch and CUDA start threads) may deadlock the child
                # if it takes a lock another thread held.  Sampler
                # workers are numpy+sockets only by contract (see
                # sampler_worker.py), which is what makes the
                # CoW-GraphStore fork safe.
                warnings.filterwarnings(
                    "ignore", message=".*multi-threaded, use of fork\\(\\)",
                    category=DeprecationWarning)
                proc.start()
            worker_sock.close()  # child owns its end now
        elif self.backend == "thread":
            proc = threading.Thread(target=worker_main, args=args,
                                    daemon=True,
                                    name=f"sampler-worker-{wid}")
            proc.start()
        else:
            raise ValueError(f"unknown backend {self.backend!r}")
        _SPAWNED.append((os.getpid(), proc))
        self._spawned.append(proc)
        return WorkerHandle(wid, trainer_sock, process=proc)

    def _respawn_worker(self, wid: int) -> Optional[WorkerHandle]:
        if self._closed:
            return None
        return self._spawn_worker(wid)

    # -- the GraphBatcher contract -------------------------------------------

    @property
    def num_steps(self) -> int:
        return self.client.num_steps

    def epoch(self, epoch: int, *, start_step: int = 0
              ) -> Iterator[GraphTensor]:
        return self.client.epoch(epoch, start_step=start_step)

    # -- lifecycle -----------------------------------------------------------

    def watermarks(self):
        return self.coordinator.watermarks()

    def kill_worker(self, worker_id: int) -> None:
        """Hard-kill one worker (test/chaos hook for the rebalance path).
        For dial-in workers (no process handle) the closest equivalent is
        dropping their stream: the worker exits on EOF and the
        coordinator rebalances on the dead socket."""
        w = self.coordinator.workers[worker_id]
        if w.process is not None and hasattr(w.process, "kill"):
            w.process.kill()
        elif w.process is None:
            w.close()

    def close(self, timeout: float = 5.0) -> None:
        if self._closed:
            return
        if os.getpid() != self._owner_pid:
            # a fork child inherited this handle (sampler workers fork
            # while sibling fleets exist): only the owning process may
            # close — a child sending STOP over inherited trainer-end
            # sockets would corrupt the live protocol
            return
        self._closed = True
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        self.coordinator.stop_all()
        self.client.close()  # then close sockets: unblocks stuck peers
        handles = (list(self.coordinator.workers.values())
                   + list(self.coordinator.retired))
        # closing the trainer ends unblocks any worker mid-sendall (EPIPE)
        for w in handles:
            w.close()
        for w in handles:
            p = w.process
            if p is None:
                continue
            p.join(timeout)
            if hasattr(p, "terminate") and p.is_alive():
                p.terminate()
                p.join(timeout)
            if hasattr(p, "kill") and p.is_alive():
                # SIGKILL escalation: a worker that survived EOF + STOP +
                # SIGTERM (e.g. wedged on a lock inherited mid-fork, or
                # blocked on an fd a sibling fork still holds open) must
                # not be able to stall trainer shutdown — or interpreter
                # exit, where multiprocessing's atexit join()s children
                # WITHOUT a timeout
                p.kill()
                p.join(timeout)
        # registry sweep: every process this fleet EVER forked, even one
        # whose coordinator handle was lost (respawn races, spawn errors)
        _kill_stragglers([(self._owner_pid, p) for p in self._spawned],
                         timeout)
        self._spawned = []
        _prune_spawn_registry()

    def __enter__(self) -> "SamplingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak a fleet
        try:
            self.close(timeout=0.5)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
