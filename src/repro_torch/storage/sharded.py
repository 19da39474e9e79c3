"""Cross-shard partitioned GraphStore (a copy of `repro.storage.sharded`).

Each worker owns one contiguous node-range partition of EVERY node set
(`ShardMap`: shard s of S owns ``[s*n//S, (s+1)*n//S)``).  All shards
open the same `GraphDirectory` mmap, so "owning" a range costs nothing —
it only decides which shard ANSWERS a lookup, which is what keeps each
worker's resident set bounded by the pages its partition actually
touches while the fleet as a whole covers the graph.

Lookups for nodes outside the local range batch into one `NBR` / `FEAT`
request frame per owning peer over the `sampling_service` wire protocol
(`GraphShardServer` answers them from its own mmap), with a per-worker
remote-neighbor LRU so frontier-heavy hops don't storm the network.

Determinism: every shard serves slices of the SAME CSR files, so a
neighbor list is byte-identical whether it came from the local mmap, a
peer, the LRU, or the local fallback after a peer died — which is why
`ShardedGraphStore` keeps the `(plan, seeds, base_seed, epoch, step)`
bit-identical sampling contract at any shard count, including across a
kill-one-shard-worker rebalance.
"""
from __future__ import annotations

import socket
import threading
import time
from collections import OrderedDict
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.data.sampling import GraphStore
from repro_torch.sampling_service import frames as wire
from repro_torch.sampling_service.transport import Address, TcpTransport
from repro_torch.storage.format import MmapGraphStore


def shard_bounds(n: int, num_shards: int) -> np.ndarray:
    """Partition boundaries: shard s owns ``[bounds[s], bounds[s+1])``."""
    return (np.arange(num_shards + 1, dtype=np.int64) * n) // num_shards


class ShardMap:
    """Pure node-id -> owning-shard arithmetic for every node set."""

    def __init__(self, num_nodes: Mapping[str, int], num_shards: int):
        self.num_shards = num_shards
        self.bounds = {ns: shard_bounds(n, num_shards)
                       for ns, n in num_nodes.items()}

    def owner(self, node_set: str, nodes: np.ndarray) -> np.ndarray:
        b = self.bounds[node_set]
        return np.searchsorted(b, np.asarray(nodes, np.int64),
                               side="right") - 1

    def node_range(self, node_set: str, shard: int) -> tuple[int, int]:
        b = self.bounds[node_set]
        return int(b[shard]), int(b[shard + 1])


class GraphShardServer:
    """Serve batched NBR/FEAT lookups from a local store over TCP.

    One accept thread polls the listener; each connection gets its own
    handler thread.  All threads are daemons AND joined in `close()`
    (repro-lint THR001/THR002), and every receiving socket runs under a
    timeout (SOC001)."""

    def __init__(self, store, *, host: str = "127.0.0.1",
                 poll_interval: float = 0.25,
                 frame_timeout: float = 30.0):
        self.store = store
        self.poll_interval = poll_interval
        self.frame_timeout = frame_timeout
        self._lsock = TcpTransport(host).listen()
        self._lsock.settimeout(poll_interval)
        self.address: Address = self._lsock.getsockname()[:2]
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self.requests_served = 0
        accept = threading.Thread(target=self._accept_loop,
                                  name="graph-shard-accept", daemon=True)
        accept.start()
        self._threads.append(accept)

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="graph-shard-conn", daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                try:
                    kind, meta, payload = wire.recv_frame(
                        conn, timeout=self.poll_interval,
                        frame_timeout=self.frame_timeout)
                except socket.timeout:
                    continue
                except (EOFError, OSError, wire.WireError):
                    return
                try:
                    self._answer(conn, kind, meta, payload)
                except OSError:
                    return  # peer went away mid-reply
        finally:
            conn.close()

    def _answer(self, conn: socket.socket, kind: str, meta: dict,
                payload) -> None:
        if kind == wire.NBR:
            nodes = np.asarray(payload["nodes"], np.int64)
            nbrs = self.store.neighbors_batch(meta["edge_set"], nodes)
            counts = np.asarray([len(x) for x in nbrs], np.int64)
            flat = (np.concatenate(nbrs).astype(np.int64, copy=False)
                    if nbrs else np.zeros(0, np.int64))
            reply = (wire.NBRS, {"counts": counts, "neighbors": flat})
        elif kind == wire.FEAT:
            nodes = np.asarray(payload["nodes"], np.int64)
            rows = self.store.gather_node_features(meta["node_set"], nodes)
            reply = (wire.FEATS, rows)
        else:
            raise wire.ProtocolError(f"unexpected frame kind {kind!r} on "
                                     "a shard-lookup connection")
        # count BEFORE the reply hits the wire: a client that has the
        # answer must observe the count (stats would otherwise lag reads)
        self.requests_served += 1
        wire.send_frame(conn, reply[0], {}, arrays=reply[1])

    def close(self) -> None:
        self._closed.set()
        self._lsock.close()
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for c in conns:
            c.close()
        for t in threads:
            t.join(timeout=5.0)


class RemoteShardClient:
    """Blocking request/response channel to one peer's `GraphShardServer`.

    One socket, one in-flight request (serialized under a lock — the
    sampler's frontier loop is sequential anyway).  Any transport error
    poisons the channel and surfaces as `ConnectionError`; the caller
    (`ShardedGraphStore`) decides whether to fall back locally."""

    def __init__(self, address: Address, *, request_timeout: float = 30.0,
                 connect_deadline: float = 20.0):
        self.address = (address[0], int(address[1]))
        self.request_timeout = request_timeout
        self.connect_deadline = connect_deadline
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def request(self, kind: str, meta: dict,
                arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = TcpTransport.connect(
                        self.address,
                        deadline=time.monotonic() + self.connect_deadline)
                wire.send_frame(self._sock, kind, meta, arrays=arrays)
                _, _, payload = wire.recv_frame(
                    self._sock, timeout=self.request_timeout,
                    frame_timeout=self.request_timeout)
            except (EOFError, OSError, wire.WireError) as exc:
                if self._sock is not None:
                    self._sock.close()
                    self._sock = None
                raise ConnectionError(
                    f"shard lookup to {self.address} failed: {exc}") from exc
            return payload if payload is not None else {}

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


class _LRU:
    """Bounded OrderedDict LRU (single-threaded: the sampler loop)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        try:
            self._d.move_to_end(key)
        except KeyError:
            self.misses += 1
            return None
        self.hits += 1
        return self._d[key]

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)


class ShardedGraphStore(GraphStore):
    """Partitioned `GraphStore` view: shard-local lookups hit the local
    mmap, remote ones batch into one request per owning peer.

    ``fallback_local=True`` (the default) answers from the local mmap
    when a peer is unreachable — byte-identical data (all shards map the
    same `GraphDirectory`), so a dead peer costs locality, never
    correctness.  Peers that fail once are remembered dead; nothing here
    retries them (the fleet's rebalance owns recovery policy)."""

    def __init__(self, local: MmapGraphStore, shard: int, num_shards: int,
                 peers: Mapping[int, Address], *,
                 cache_entries: int = 1 << 16,
                 request_timeout: float = 30.0,
                 fallback_local: bool = True):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range 0..{num_shards-1}")
        self.local = local
        self.shard = shard
        self.shard_map = ShardMap(local.num_nodes, num_shards)
        self.fallback_local = fallback_local
        self.request_timeout = request_timeout
        # the GraphStore surface, delegated to the local mmap
        self.schema = local.schema
        self.num_nodes = local.num_nodes
        self.node_features = local.node_features
        self.edges = local.edges
        self._index: dict = {}  # unused: neighbors* delegate below
        self._peers = {int(s): (a[0], int(a[1]))
                       for s, a in peers.items() if int(s) != shard}
        self._clients: dict[int, RemoteShardClient] = {}
        self._dead_peers: set[int] = set()
        self._cache = _LRU(cache_entries)
        self.stats = {"local": 0, "remote": 0, "cache_hits": 0,
                      "fallbacks": 0}

    # -- lookup plumbing -----------------------------------------------------

    def _client(self, shard: int) -> RemoteShardClient:
        if shard not in self._clients:
            self._clients[shard] = RemoteShardClient(
                self._peers[shard], request_timeout=self.request_timeout)
        return self._clients[shard]

    def _peer_usable(self, shard: int) -> bool:
        return shard in self._peers and shard not in self._dead_peers

    def _mark_dead(self, shard: int) -> None:
        self._dead_peers.add(shard)
        client = self._clients.pop(shard, None)
        if client is not None:
            client.close()

    def neighbors(self, edge_set: str, node: int) -> np.ndarray:
        return self.neighbors_batch(edge_set, np.asarray([node]))[0]

    def neighbors_batch(self, edge_set: str,
                        nodes: Sequence[int]) -> list[np.ndarray]:
        nodes = np.asarray(nodes, np.int64)
        src_set = self.schema.edge_sets[edge_set].source
        owners = self.shard_map.owner(src_set, nodes)
        out: list = [None] * len(nodes)
        remote: dict[int, list[int]] = {}
        for i, (u, s) in enumerate(zip(nodes, owners)):
            s = int(s)
            if s == self.shard or not self._peer_usable(s):
                out[i] = self.local.neighbors(edge_set, int(u))
                self.stats["local" if s == self.shard else "fallbacks"] += 1
                continue
            hit = self._cache.get((edge_set, int(u)))
            if hit is not None:
                out[i] = hit
                self.stats["cache_hits"] += 1
            else:
                remote.setdefault(s, []).append(i)
        for s, idxs in remote.items():
            req = nodes[idxs]
            try:
                reply = self._client(s).request(
                    wire.NBR, {"edge_set": edge_set}, {"nodes": req})
            except ConnectionError:
                if not self.fallback_local:
                    raise
                self._mark_dead(s)
                for i in idxs:
                    out[i] = self.local.neighbors(edge_set, int(nodes[i]))
                self.stats["fallbacks"] += len(idxs)
                continue
            self.stats["remote"] += len(idxs)
            offsets = np.zeros(len(idxs) + 1, np.int64)
            np.cumsum(np.asarray(reply["counts"], np.int64),
                      out=offsets[1:])
            flat = np.asarray(reply["neighbors"], np.int64)
            for j, i in enumerate(idxs):
                arr = flat[offsets[j]:offsets[j + 1]]
                out[i] = arr
                self._cache.put((edge_set, int(nodes[i])), arr)
        return out

    def gather_node_features(self, node_set: str,
                             ids: np.ndarray) -> dict[str, np.ndarray]:
        ids = np.asarray(ids, np.int64)
        spec = self.node_features.get(node_set, {})
        if not spec or ids.size == 0:
            return self.local.gather_node_features(node_set, ids)
        owners = self.shard_map.owner(node_set, ids)
        out = {k: np.empty((len(ids),) + v.shape[1:], v.dtype)
               for k, v in spec.items()}
        usable = np.asarray([s == self.shard or self._peer_usable(int(s))
                             for s in owners])
        local_mask = (owners == self.shard) | ~usable
        if local_mask.any():
            rows = self.local.gather_node_features(node_set,
                                                   ids[local_mask])
            for k in out:
                out[k][local_mask] = rows[k]
            self.stats["local"] += int((owners == self.shard).sum())
            self.stats["fallbacks"] += int((~usable).sum())
        for s in np.unique(owners[~local_mask]):
            s = int(s)
            mask = owners == s
            try:
                rows = self._client(s).request(
                    wire.FEAT, {"node_set": node_set}, {"nodes": ids[mask]})
            except ConnectionError:
                if not self.fallback_local:
                    raise
                self._mark_dead(s)
                rows = self.local.gather_node_features(node_set, ids[mask])
                self.stats["fallbacks"] += int(mask.sum())
            else:
                self.stats["remote"] += int(mask.sum())
            for k in out:
                out[k][mask] = rows[k]
        return out

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()
