"""Multi-host streaming: SamplerEndpoint (serve) + RemoteStreamClient (a
copy of `repro.sampling_service.remote`, over the port's `frames` and
`transport`: the same HELLO / META / BATCH / HEARTBEAT / DONE / ERROR
frames, so either package's client reads the other's endpoint).

The single-host service (`service.py`) connects trainer and fleet by
inherited socketpairs.  Across processes that do not share a parent,
nothing can be inherited, so this module adds the two TCP-facing
pieces:

* :class:`SamplerEndpoint` — runs next to the sampler fleet (rank 0 of a
  `torch.distributed` job, or a dedicated sampler host), listens on an
  OS-assigned TCP port, and serves each trainer rank its deterministic
  epoch stream.  One connection per rank; per-rank batch sources are
  anything with the `GraphBatcher.epoch` contract (`GraphBatcher`
  itself, or a `SamplingService` fleet).
* :class:`RemoteStreamClient` — the trainer-side consumer with the exact
  `GraphBatcher.epoch(e, start_step=...)` iterator contract.  A reader
  thread receives and decodes frames into a small bounded queue (so wire
  decode overlaps the train step), detects a dead endpoint by heartbeat
  silence, reconnects with backoff, and resumes from its delivery
  watermark.

Fault tolerance is watermark + determinism, nothing else: a batch is a
pure function of ``(plan, seeds, base_seed, epoch, step)`` (see
`repro_torch.data.grouping`), so "resume" is just HELLO with ``start =
last delivered step + 1`` — the endpoint re-enters the epoch stream
there and the re-served prefix is bit-identical to what a never-broken
connection would have carried.  No server-side per-client state
survives a reconnect, which is what makes the endpoint restartable too.

Dead-peer detection is heartbeat-based in both directions: the endpoint
sends HEARTBEAT frames between batches (a silent endpoint is declared
dead after ``heartbeat_timeout`` and the client redials); a dead client
surfaces to the endpoint as a send error, which tears down only that
connection.  Worker death below a `SamplingService` source stays handled
by the coordinator's rebalance/respawn machinery — the TCP layer never
sees it, the stream just keeps coming.

Numpy and sockets only, as the rest of the package: nothing here
imports torch.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import TYPE_CHECKING, Callable, Iterator, Optional

from repro_torch.sampling_service import frames
from repro_torch.sampling_service.transport import Address, TcpTransport

if TYPE_CHECKING:
    from repro_torch.core.graph_tensor import GraphTensor

_END = object()

# The reference's defaults, fixed: the frames decide interop, not these.
HEARTBEAT_INTERVAL_S = 0.5  # endpoint: HEARTBEAT cadence between batches
HELLO_TIMEOUT_S = 300.0     # endpoint: idle connection / rank lock wait
REPLAY_STEPS = 8            # endpoint: encoded frames cached a rank
RECONNECT_BACKOFF_S = 0.05  # client: pause between dials
QUEUE_DEPTH = 2             # client: decoded batches ahead of the consumer
JOIN_TIMEOUT_S = 5.0        # client: reader join at close


class _ReplayWindow:
    """Per-rank bounded cache of the most recent encoded BATCH frames.

    A flapping client resumes with HELLO ``start = watermark + 1``; when
    the requested steps are still in this window the endpoint re-serves
    the cached frame BYTES instead of resampling the batches — the
    determinism contract makes both bit-identical, the cache just skips
    the sampling work.  One epoch at a time (a resume never crosses an
    epoch boundary), capacity-bounded, and only ever touched while the
    rank's stream lock is held — so no locking of its own."""

    def __init__(self):
        self.epoch: Optional[int] = None
        self.frames: "dict[int, bytes]" = {}
        self.replayed = 0  # steps served from cache (stats/tests)

    def put(self, epoch: int, step: int, frame: bytes) -> None:
        if epoch != self.epoch:
            self.epoch = epoch
            self.frames = {}
        self.frames[step] = frame
        while len(self.frames) > REPLAY_STEPS:
            del self.frames[min(self.frames)]

    def take(self, epoch: int, start: int) -> list[bytes]:
        """Cached frames for the CONTIGUOUS run start, start+1, ... —
        a hole means the rest must be produced live anyway, and serving
        a non-prefix from cache would reorder the stream."""
        if epoch != self.epoch:
            return []
        out = []
        step = start
        while step in self.frames:
            out.append(self.frames[step])
            step += 1
        return out


def source_num_steps(source) -> int:
    """Steps per epoch of a batch source (GraphBatcher / SamplingService /
    anything exposing the shared contract)."""
    n = getattr(source, "num_steps", None)
    if n is not None:
        return int(n)
    return int(source.plan.num_steps(len(source.graphs)))


# ---------------------------------------------------------------------------
# Endpoint (server side)
# ---------------------------------------------------------------------------

class SamplerEndpoint:
    """Serve per-rank epoch streams over TCP.

    ``source_factory(rank)`` builds rank ``r``'s batch source on first
    use (cached).  Each rank holds at most one live connection: a new
    HELLO for a rank supersedes the old connection (closing it unblocks
    a handler wedged in ``sendall`` toward a vanished client), and a
    per-rank lock serializes stream production so stateful sources
    (a `SamplingService` fleet) are never iterated concurrently.

    The endpoint owns the sources it created: ``close()`` closes them
    (when they have a ``close``), the listener, and every live
    connection, then joins its threads with a timeout — endpoint
    shutdown never hangs on a stuck peer.
    """

    def __init__(self, source_factory: Callable[[int], object], *,
                 transport: Optional[TcpTransport] = None, port: int = 0):
        self._source_factory = source_factory
        self._sources: dict[int, object] = {}
        self._rank_locks: dict[int, threading.Lock] = {}
        # per-rank step-range replay cache: a client resuming from its
        # watermark re-serves recent batches from memory instead of
        # resampling them (memory cost is up to REPLAY_STEPS encoded
        # frames per rank)
        self._replay: dict[int, _ReplayWindow] = {}
        self._conns: dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self.transport = transport or TcpTransport()
        self._lsock = self.transport.listen(port)
        self.address: Address = self._lsock.getsockname()[:2]
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        accept = threading.Thread(target=self._accept_loop, daemon=True,
                                  name="sampler-endpoint-accept")
        accept.start()
        self._threads.append(accept)

    # -- connection plumbing -------------------------------------------------

    def _accept_loop(self) -> None:
        # the listener runs with a poll timeout: on Linux, close()ing a
        # socket does NOT wake a thread blocked in accept() on it (the
        # kernel wait is on the file description, not the fd), so a
        # purely-blocking accept would leak this thread at shutdown
        try:
            self._lsock.settimeout(0.25)
        except OSError:
            return  # close() won the race before the first poll
        while not self._closed.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue  # poll the closed flag
            except OSError:
                return  # listener closed — shutdown
            conn.settimeout(None)  # accepted socks inherit the timeout
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="sampler-endpoint-conn")
            t.start()
            self._track_thread(t)

    def _track_thread(self, t: threading.Thread) -> None:
        """Record for close()-time joins, pruning the dead — connection
        and heartbeat churn over a long-lived endpoint must not grow the
        list without bound."""
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _source(self, rank: int):
        with self._lock:
            if rank not in self._sources:
                self._sources[rank] = self._source_factory(rank)
                self._rank_locks[rank] = threading.Lock()
                self._replay[rank] = _ReplayWindow()
            return self._sources[rank], self._rank_locks[rank]

    def replay_stats(self) -> dict[int, int]:
        """Per-rank count of steps served from the replay cache."""
        with self._lock:
            return {rank: win.replayed
                    for rank, win in self._replay.items()}

    def _adopt(self, rank: int, conn: socket.socket) -> None:
        """Make `conn` the rank's single live connection; closing the old
        one aborts any handler still sending to a vanished client."""
        with self._lock:
            old = self._conns.get(rank)
            self._conns[rank] = conn
        if old is not None and old is not conn:
            _close_quietly(old)

    def _owns(self, rank: int, conn: socket.socket) -> bool:
        with self._lock:
            return self._conns.get(rank) is conn

    # -- per-connection protocol ---------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        rank = None
        try:
            while not self._closed.is_set():
                kind, meta, _ = frames.recv_frame(
                    conn, timeout=HELLO_TIMEOUT_S,
                    frame_timeout=HELLO_TIMEOUT_S)
                if kind != frames.HELLO:
                    raise frames.ProtocolError(
                        f"expected HELLO, got {kind!r}")
                rank = int(meta["rank"])
                source, rank_lock = self._source(rank)
                if meta.get("probe"):
                    # probes answer META without adopting the connection —
                    # they must not supersede the rank's live stream
                    frames.send_frame(conn, frames.META,
                                    {"epoch": None,
                                     "num_steps": source_num_steps(source)})
                    continue
                self._adopt(rank, conn)
                if not rank_lock.acquire(  # noqa: LCK001 — `with` cannot
                        # express acquire-with-timeout; release is in the
                        # finally below, so no path leaks the lock
                        timeout=HELLO_TIMEOUT_S):
                    raise frames.ProtocolError(
                        f"rank {rank} stream lock unavailable")
                try:
                    self._stream_epoch(conn, rank, source,
                                       int(meta["epoch"]),
                                       int(meta.get("start", 0)))
                except (OSError, frames.WireError):
                    raise  # connection-level: just tear down this conn
                except Exception as exc:  # noqa: BLE001 — source failed
                    # a batch-source error (dead fleet, bad plan) is not
                    # retryable by reconnecting — ship it to the trainer
                    # (surfaces as RuntimeError at the consumer) and
                    # retire this connection cleanly
                    frames.send_frame(conn, frames.ERROR,
                                    {"rank": rank,
                                     "error": f"{type(exc).__name__}: "
                                              f"{exc}"})
                    return
                finally:
                    rank_lock.release()  # noqa: LCK001 — pairs with the
                    # timeout-acquire above; finally guarantees release
        except socket.timeout:
            pass  # idle connection with no HELLO — reap it
        except (EOFError, OSError, frames.WireError):
            pass  # peer went away / desynced: this connection is done
        finally:
            if rank is not None:
                with self._lock:
                    if self._conns.get(rank) is conn:
                        del self._conns[rank]
            _close_quietly(conn)

    def _stream_epoch(self, conn: socket.socket, rank: int, source,
                      epoch: int, start: int) -> None:
        """META, then BATCH frames from `start` — recent steps replayed
        from the rank's cache, the rest produced live — then DONE, with a
        heartbeat pump covering every production gap.  Runs under the
        rank lock, which is also what makes the replay window safe to
        touch without its own locking."""
        send_lock = threading.Lock()
        frames.send_frame(conn, frames.META,
                        {"epoch": epoch,
                         "num_steps": source_num_steps(source)})
        hb_stop = threading.Event()

        def pump():
            while not hb_stop.wait(HEARTBEAT_INTERVAL_S):
                try:
                    with send_lock:
                        frames.send_frame(conn, frames.HEARTBEAT)
                except OSError:
                    return

        hb = threading.Thread(target=pump, daemon=True,
                              name=f"sampler-endpoint-hb-{rank}")
        hb.start()
        self._track_thread(hb)
        with self._lock:
            win = self._replay.get(rank)
        cached = win.take(epoch, start) if win is not None else []
        stream = None
        try:
            for frame in cached:
                if not self._owns(rank, conn) or self._closed.is_set():
                    raise OSError("connection superseded")
                with send_lock:
                    conn.sendall(frame)
                win.replayed += 1
            live_start = start + len(cached)
            step = live_start - 1
            stream = source.epoch(epoch, start_step=live_start)
            for step, batch in enumerate(stream, live_start):
                if not self._owns(rank, conn) or self._closed.is_set():
                    raise OSError("connection superseded")
                frame = frames.encode_frame(frames.BATCH,
                                          {"epoch": epoch, "step": step},
                                          batch)
                with send_lock:
                    conn.sendall(frame)
                if win is not None:
                    win.put(epoch, step, frame)
            with send_lock:
                frames.send_frame(conn, frames.DONE,
                                {"epoch": epoch, "step": step})
        finally:
            hb_stop.set()
            if stream is not None and hasattr(stream, "close"):
                stream.close()  # a generator source left mid-epoch

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        _close_quietly(self._lsock)
        with self._lock:
            conns = list(self._conns.values())
            threads = list(self._threads)
            sources = list(self._sources.values())
        for c in conns:
            _close_quietly(c)
        for t in threads:
            t.join(timeout)
        for s in sources:
            if hasattr(s, "close"):
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def __enter__(self) -> "SamplerEndpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak the listener/threads
        try:
            self.close(timeout=0.5)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------------------
# Remote client (trainer side)
# ---------------------------------------------------------------------------

class RemoteStreamClient:
    """`GraphBatcher.epoch` contract over TCP, with reconnect+resume.

    A per-epoch reader thread owns the socket: it dials (with retry —
    launch order between trainer and endpoint is irrelevant), sends
    HELLO ``{rank, epoch, start}``, and decodes frames into a bounded
    queue the generator drains in step order.  Endpoint silence longer
    than ``heartbeat_timeout`` (no batches, no heartbeats, or a stall
    mid-frame) drops the connection and redials with
    ``start = delivered watermark + 1``; an endpoint that stays
    unreachable past ``connect_deadline`` raises `ConnectionError` at
    the consumer instead of hanging.

    ``close()`` (and generator close) aborts the socket and joins the
    reader with a timeout, so pytest teardown / interpreter exit never
    block on a dead endpoint.
    """

    def __init__(self, address: Address, rank: int = 0, *,
                 heartbeat_timeout: float = 5.0,
                 connect_deadline: float = 20.0):
        self.address = (str(address[0]), int(address[1]))
        self.rank = rank
        self.heartbeat_timeout = heartbeat_timeout
        self.connect_deadline = connect_deadline
        self._num_steps: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._sock_lock = threading.Lock()
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- the GraphBatcher contract -------------------------------------------

    @property
    def num_steps(self) -> int:
        if self._num_steps is None:
            # probe: HELLO{probe} -> META, no stream started server-side
            deadline = time.monotonic() + self.connect_deadline
            sock = TcpTransport.connect(self.address, deadline=deadline)
            try:
                frames.send_frame(sock, frames.HELLO,
                                {"rank": self.rank, "probe": True})
                kind, meta, _ = frames.recv_frame(
                    sock, timeout=self.connect_deadline,
                    frame_timeout=self.connect_deadline)
                if kind != frames.META:
                    raise frames.ProtocolError(f"probe got {kind!r}")
                self._num_steps = int(meta["num_steps"])
            finally:
                _close_quietly(sock)
        return self._num_steps

    def epoch(self, epoch: int, *, start_step: int = 0
              ) -> Iterator[GraphTensor]:
        """Deterministic epoch stream; `start_step` skips ahead (restart),
        matching ``GraphBatcher.epoch``."""
        if self._closed.is_set():
            raise RuntimeError("RemoteStreamClient is closed")
        q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        self._threads = [t for t in self._threads if t.is_alive()]
        reader = threading.Thread(
            target=self._receive_epoch, args=(epoch, start_step, q, stop),
            daemon=True, name=f"remote-stream-reader-{self.rank}")
        reader.start()
        self._threads.append(reader)
        try:
            while True:
                try:
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    if not reader.is_alive():
                        try:
                            # TOCTOU drain: the reader may have enqueued
                            # its final item (DONE / error) between our
                            # empty poll and its exit
                            item = q.get_nowait()
                        except queue.Empty:
                            raise RuntimeError(
                                "stream reader died without a result"
                            ) from None
                    else:
                        continue
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            self._drop_sock()
            reader.join(JOIN_TIMEOUT_S)

    # -- reader thread -------------------------------------------------------

    def _receive_epoch(self, epoch: int, start: int, q: queue.Queue,
                       stop: threading.Event) -> None:
        """Connect / receive / reconnect until DONE.  `delivered` is the
        watermark — the last step ENQUEUED toward the consumer — and is
        what a resume HELLO advertises: everything at or below it is
        safe in the queue, everything above it is re-served."""
        delivered = start - 1
        try:
            while not stop.is_set() and not self._closed.is_set():
                sock = self._connect(epoch, delivered + 1, stop)
                if sock is None:
                    return  # stopped while dialing
                try:
                    while not stop.is_set():
                        kind, meta, graph = frames.recv_frame(
                            sock, timeout=self.heartbeat_timeout,
                            frame_timeout=self.heartbeat_timeout)
                        if kind == frames.HEARTBEAT:
                            continue
                        if kind == frames.META:
                            self._num_steps = int(meta["num_steps"])
                            continue
                        if kind == frames.BATCH:
                            b_epoch = int(meta["epoch"])
                            step = int(meta["step"])
                            if b_epoch != epoch or step <= delivered:
                                continue  # stale frame after a racy resume
                            if step != delivered + 1:
                                raise frames.ProtocolError(
                                    f"step gap: got {step}, expected "
                                    f"{delivered + 1}")
                            if not self._put(q, graph, stop):
                                return
                            delivered = step
                        elif kind == frames.DONE:
                            if int(meta["epoch"]) == epoch:
                                self._put(q, _END, stop)
                                return
                        elif kind == frames.ERROR:
                            raise RuntimeError(
                                "sampler endpoint reported: "
                                f"{meta.get('error')}")
                        else:
                            raise frames.ProtocolError(
                                f"unexpected frame kind {kind!r}")
                except (socket.timeout, EOFError, OSError, frames.WireError):
                    self._drop_sock()
                    continue  # reconnect, resume from delivered + 1
        except BaseException as exc:  # noqa: BLE001 — surface at consumer
            self._put(q, exc, stop)

    def _connect(self, epoch: int, next_step: int,
                 stop: threading.Event) -> Optional[socket.socket]:
        """Dial + HELLO + META, retrying until `connect_deadline`."""
        deadline = time.monotonic() + self.connect_deadline
        while not stop.is_set() and not self._closed.is_set():
            try:
                sock = TcpTransport.connect(
                    self.address, deadline=deadline,
                    retry_interval=RECONNECT_BACKOFF_S)
                frames.send_frame(sock, frames.HELLO,
                                {"rank": self.rank, "epoch": epoch,
                                 "start": next_step})
                kind, meta, _ = frames.recv_frame(
                    sock, timeout=self.heartbeat_timeout,
                    frame_timeout=self.heartbeat_timeout)
                if kind != frames.META:
                    raise frames.ProtocolError(f"HELLO ack was {kind!r}")
                self._num_steps = int(meta["num_steps"])
                with self._sock_lock:
                    self._sock = sock
                return sock
            except (socket.timeout, EOFError, OSError, frames.WireError):
                self._drop_sock()
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"sampler endpoint {self.address} unreachable for "
                        f"{self.connect_deadline:.1f}s")
                time.sleep(RECONNECT_BACKOFF_S)
        return None

    def _put(self, q: queue.Queue, item, stop: threading.Event) -> bool:
        """Bounded put that gives up once the consumer went away."""
        while not stop.is_set() and not self._closed.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return isinstance(item, BaseException) and _force_put(q, item)

    def _drop_sock(self) -> None:
        with self._sock_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            _close_quietly(sock)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Idempotent: abort the socket, join reader threads with a
        timeout — never blocks on a dead endpoint."""
        self._closed.set()
        self._drop_sock()
        for t in self._threads:
            t.join(JOIN_TIMEOUT_S)
        self._threads = [t for t in self._threads if t.is_alive()]

    def __enter__(self) -> "RemoteStreamClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak a reader thread blocked
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _force_put(q: queue.Queue, item) -> bool:
    try:
        q.put_nowait(item)
        return True
    except queue.Full:
        return False


def _close_quietly(sock: socket.socket) -> None:
    """Shut the connection down, then close this process's descriptor.
    A sampler fleet forked in this process after the socket was opened
    holds a copy of the descriptor, and close() alone neither ends the
    connection while a copy lives nor wakes a thread blocked in recv()
    on it; shutdown() does both (the reference's close() alone left the
    endpoint's handler waiting out its join timeout)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # not connected, or already shut down
    try:
        sock.close()
    except OSError:
        pass
