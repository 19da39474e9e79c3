"""Transport — how two peers of the sampling service obtain a connected
byte stream speaking `frames.py` frames (a copy of
`repro.sampling_service.transport`).

The wire format is transport-agnostic (length-prefixed frames over any
connected stream socket).  What differs between deployments is how the
two ends get connected:

* :class:`InProcessTransport` — `socket.socketpair()`: trainer and
  forked sampler workers share one host, the pair is created
  before the fork and each side inherits its end.  Zero configuration,
  kernel-buffer backpressure, no names or ports.
* :class:`TcpTransport` — real TCP sockets.  `pair()` keeps the exact
  socketpair semantics over a loopback connection (so the whole fleet
  protocol — ASSIGN/BATCH/rebalance/respawn — runs over TCP unchanged,
  which is what the determinism suite exercises), while `listen()` /
  `connect()` serve the dial-in fleet: the service listens on an
  OS-assigned port and out-of-core workers (and the shard servers'
  peers) dial it with retry+backoff (`repro_torch.storage`).

Ports are OS-assigned by default (``port=0``) — fixed port numbers are a
de-flake hazard on shared CI boxes and are never required: the listener
reports its bound address and the caller publishes it (the dial fleet's
`on_listen` hook hands it to the workers it spawns).
"""
from __future__ import annotations

import socket
import time
from typing import Optional, Tuple

Address = Tuple[str, int]


class Transport:
    """Factory for connected frame-stream sockets between service peers."""

    def pair(self) -> tuple[socket.socket, socket.socket]:
        """A connected (trainer_end, worker_end) stream pair, created
        up-front on one host (the fork-inheritance idiom of
        `SamplingService`)."""
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class InProcessTransport(Transport):
    """`socket.socketpair()` — the single-host default.  The kernel
    buffer on each end is the backpressure bound; we leave the OS default
    (a few hundred KB–MB ≈ a couple of batches in flight)."""

    def pair(self) -> tuple[socket.socket, socket.socket]:
        return socket.socketpair()


class TcpTransport(Transport):
    """TCP sockets: loopback pairs for a local fleet, listen/connect for
    the dial-in fleet and the shard servers.  `TCP_NODELAY` is set on
    every socket — the stream is request/response-shaped control frames
    interleaved with multi-MB batch frames, and Nagle delays the small
    ones for nothing.
    """

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host

    # -- socketpair-shaped (local fleet over TCP) ----------------------------

    def pair(self) -> tuple[socket.socket, socket.socket]:
        """A connected (trainer_end, worker_end) pair over a one-shot
        loopback listener on an OS-assigned port.  Same semantics as
        `socketpair()` — both ends exist before any fork — but the bytes
        cross the real TCP stack, which is what the TCP determinism tests
        pin down."""
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as lsock:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((self.host, 0))
            lsock.listen(1)
            # our own connect is already in the backlog, so accept()
            # returns immediately — the timeout only bounds the
            # pathological case (host firewalling loopback mid-pair)
            # instead of hanging forever (repro-lint SOC001)
            lsock.settimeout(5.0)
            worker_end = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            worker_end.connect(lsock.getsockname())
            trainer_end, _ = lsock.accept()
            trainer_end.settimeout(None)
        for s in (trainer_end, worker_end):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return trainer_end, worker_end

    # -- endpoint-shaped (dial-in) -------------------------------------------

    def listen(self, port: int = 0, backlog: int = 16) -> socket.socket:
        """A listening socket on (host, port); ``port=0`` (the default,
        and the only mode the tests use) lets the OS assign one — read it
        back from ``sock.getsockname()``."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, port))
        sock.listen(backlog)
        return sock

    @staticmethod
    def connect(address: Address, *, deadline: Optional[float] = None,
                retry_interval: float = 0.1,
                attempt_timeout: float = 2.0) -> socket.socket:
        """Dial `address` with retry until `deadline` (an absolute
        `time.monotonic()` instant; None = single attempt).  Retrying the
        dial is what makes launch order irrelevant: a worker may start
        before the service has bound its port.

        `attempt_timeout` bounds ONE handshake and is independent of the
        `retry_interval` backoff — a cross-host SYN-ACK can take far
        longer than the tight backoff a client uses between redials."""
        while True:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                sock.settimeout(max(attempt_timeout, 0.05)
                                if deadline is not None else None)
                sock.connect(address)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                sock.close()
                if deadline is None or time.monotonic() >= deadline:
                    raise
                time.sleep(retry_interval)
