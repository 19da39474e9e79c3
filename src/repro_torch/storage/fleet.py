"""Dial-in fleet admission — the service side of out-of-core workers (a
copy of `repro.storage.fleet`).

Forked workers inherit the graph; dial-in workers DON'T: they connect
over TCP knowing only ``(service address, GraphDirectory path)`` and
receive everything else — worker id, shard assignment, peer shard-server
addresses, and the full sampling configuration (spec/plan/sizes/seeds/
base_seed) — over the wire.  That is what lets the fleet outgrow one
machine: no fork, no full-graph copy, just a path every host can mmap.

Handshake (all `repro_torch.sampling_service.frames` frames)::

    worker  -> service   JOIN   {}
    service -> worker    SHARD  {worker, shard, num_shards}
    worker  -> service   READY  {host, port}   (its GraphShardServer;
                                {} when num_shards == 1)
    service -> worker    CONFIG {spec, plan, sizes, base_seed, peers}
                                + raw payload {seeds}

After CONFIG both sides speak the ordinary fleet protocol
(ASSIGN/BATCH/DONE/STOP) through the unmodified `Coordinator` /
`StreamClient` / `SamplerWorker`.  A dial worker's `WorkerHandle` has
``process=None`` — death is detected by socket EOF (the kernel FINs on
process exit), which feeds the same rebalance path as forked workers.
"""
from __future__ import annotations

import dataclasses
import socket
import time
from typing import Sequence

import numpy as np

from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import BatchPlan
from repro_torch.data.sampling import SamplingOp, SamplingSpec
from repro_torch.sampling_service import frames as wire
from repro_torch.sampling_service.coordinator import WorkerHandle

# -- JSON-able config codecs (CONFIG frame meta) ----------------------------


def spec_to_meta(spec: SamplingSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_meta(meta: dict) -> SamplingSpec:
    return SamplingSpec(
        seed_node_set=meta["seed_node_set"],
        seed_op_name=meta["seed_op_name"],
        sampling_ops=tuple(
            SamplingOp(op["op_name"], tuple(op["input_op_names"]),
                       op["edge_set_name"], op["sample_size"],
                       op["strategy"])
            for op in meta["sampling_ops"]))


def plan_to_meta(plan: BatchPlan) -> dict:
    return dataclasses.asdict(plan)


def plan_from_meta(meta: dict) -> BatchPlan:
    return BatchPlan(**meta)


def sizes_to_meta(sizes: SizeConstraints) -> dict:
    return {
        "total_num_components": sizes.total_num_components,
        "total_num_nodes": dict(sizes.total_num_nodes),
        "total_num_edges": dict(sizes.total_num_edges),
    }


def sizes_from_meta(meta: dict) -> SizeConstraints:
    return SizeConstraints(
        total_num_components=meta["total_num_components"],
        total_num_nodes=dict(meta["total_num_nodes"]),
        total_num_edges=dict(meta["total_num_edges"]))


# -- admission --------------------------------------------------------------


def accept_dial_workers(lsock: socket.socket, num_workers: int, *,
                        num_shards: int, spec: SamplingSpec,
                        plan: BatchPlan, sizes: SizeConstraints,
                        seeds: Sequence[int], base_seed: int = 0,
                        accept_timeout: float = 60.0,
                        frame_timeout: float = 30.0
                        ) -> list[WorkerHandle]:
    """Admit `num_workers` dial-in workers on the listening socket and
    run the JOIN/SHARD/READY/CONFIG handshake.  Returns their
    `WorkerHandle`s (``process=None``), ready for a `Coordinator`.

    Shard assignment is 1:1 (worker w owns shard w) — ``num_shards``
    must equal ``num_workers``, or be 1 (unsharded: every worker samples
    from its own full mmap, no shard servers)."""
    if num_shards not in (1, num_workers):
        raise ValueError(
            f"num_shards must be 1 or num_workers ({num_workers}), "
            f"got {num_shards}")
    lsock.settimeout(0.25)
    deadline = time.monotonic() + accept_timeout
    conns: list[socket.socket] = []
    try:
        while len(conns) < num_workers:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {len(conns)}/{num_workers} workers dialed in "
                    f"within {accept_timeout:.0f}s")
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, _, _ = wire.recv_frame(conn, timeout=frame_timeout,
                                         frame_timeout=frame_timeout)
            if kind != wire.JOIN:
                conn.close()
                continue
            wid = len(conns)
            wire.send_frame(conn, wire.SHARD,
                            {"worker": wid,
                             "shard": wid if num_shards > 1 else 0,
                             "num_shards": num_shards})
            conns.append(conn)

        peers: dict[str, tuple[str, int]] = {}
        for wid, conn in enumerate(conns):
            kind, meta, _ = wire.recv_frame(conn, timeout=frame_timeout,
                                            frame_timeout=frame_timeout)
            if kind != wire.READY:
                raise wire.ProtocolError(
                    f"worker {wid}: expected READY, got {kind!r}")
            if num_shards > 1:
                # the READY host is how the worker reached us, which may
                # be loopback-only; the address we actually observed on
                # accept is what OTHER workers can dial
                peer_host = meta.get("host") or conn.getpeername()[0]
                peers[str(wid)] = (peer_host, int(meta["port"]))

        config = {
            "spec": spec_to_meta(spec),
            "plan": plan_to_meta(plan),
            "sizes": sizes_to_meta(sizes),
            "base_seed": int(base_seed),
            "peers": peers,
        }
        seeds_arr = np.asarray(seeds, np.int64)
        for conn in conns:
            wire.send_frame(conn, wire.CONFIG, config,
                            arrays={"seeds": seeds_arr})
    except BaseException:  # noqa: BLE001 — admission failed: close every
        # half-admitted connection (incl. on KeyboardInterrupt) and rethrow
        for conn in conns:
            conn.close()
        raise
    return [WorkerHandle(wid, conn, process=None)
            for wid, conn in enumerate(conns)]
