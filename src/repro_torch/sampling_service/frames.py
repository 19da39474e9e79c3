"""Wire format: length-prefixed frames carrying flat-dict GraphTensors
(a copy of `repro.sampling_service.wire`: the same magic, header, array
codec and limits, so a frame's bytes equal the reference's for the same
graph; held to it by tests/test_torch_sampling_service.py).

One frame on the wire::

    MAGIC(4) | header_len: u32 BE | header JSON | payload_len: u64 BE | payload

* ``header`` is UTF-8 JSON: ``{"kind": ..., "meta": {...}}`` — small
  control data (epoch/step/worker id, commands, error strings).
* ``payload`` is the batch's flat dict from
  `repro_torch.data.serialization.graph_to_flat` — the same flat naming
  scheme the on-disk sampler shards use — serialized with a raw per-array
  codec (name | dtype descr | shape | bytes, each length-prefixed).  Raw, not
  ``.npz``: the wire is a local pipe/socket, and zipfile framing + CRC
  costs several ms per batch — comparable to sampling itself — while this
  codec is a handful of memcpys (decode is zero-copy ``np.frombuffer``).
  Empty for control frames.

Transport is any connected stream socket (we use `socket.socketpair()`
between the trainer process and each sampler worker).  Backpressure is
structural: the producer writes with ``sendall`` into a bounded kernel
socket buffer and the consumer reads frames only when it wants the next
batch, so a sampler that runs ahead of the trainer blocks in ``sendall``
after at most SNDBUF+RCVBUF bytes (plus whatever the client-side prefetch
queue admits) — the "bounded per-client queue" of the service contract.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.data.serialization import flat_to_graph, graph_to_flat

MAGIC = b"GTS1"  # GraphTensor Stream, wire version 1
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
# A control frame is ~100 bytes and a batch frame a few MB; anything
# bigger than this is a corrupt/desynced stream, not a real message.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 34

# frame kinds
BATCH = "batch"          # meta: {worker, epoch, step}; payload: stacked batch
DONE = "done"            # meta: {worker, epoch, step} — assignment drained
                         # (step = last step produced, a watermark update)
ASSIGN = "assign"        # meta: {epoch, steps: [...], start? } -> worker
STOP = "stop"            # -> worker: drain and exit
ERROR = "error"          # meta: {worker, error} — worker-side exception
# multi-host stream kinds (the reference's sampling_service.remote; the
# port keeps them so its frames stay the reference's)
HELLO = "hello"          # client -> endpoint: {rank, epoch, start} — open /
                         # resume one rank's epoch stream from a watermark
META = "meta"            # endpoint -> client: {epoch, num_steps} — HELLO ack
HEARTBEAT = "heartbeat"  # endpoint -> client keepalive: {} — dead-peer
                         # detection (a client that sees neither frames nor
                         # heartbeats for its timeout declares the peer dead)
# dial-in fleet handshake (repro_torch.storage.fleet /
# repro_torch.storage.dial_worker):
# workers connect over TCP knowing only (address, GraphDirectory path)
JOIN = "join"            # worker -> service: {} — request admission
SHARD = "shard"          # service -> worker: {worker, shard, num_shards}
READY = "ready"          # worker -> service: {host, port} once its shard
                         # server is bound ({} when the fleet is unsharded)
CONFIG = "config"        # service -> worker: sampling config meta (spec/
                         # plan/sizes/base_seed/peers); raw payload {seeds}
# cross-shard graph lookups (repro_torch.storage.sharded):
NBR = "nbr"              # client -> shard server: {edge_set}; raw payload
                         # {nodes} — batched neighbor request
NBRS = "nbrs"            # shard server reply: raw {counts, neighbors}
FEAT = "feat"            # client -> shard server: {node_set}; raw {nodes}
FEATS = "feats"          # shard server reply: raw {<feature>: rows}


class WireError(ConnectionError):
    """Framing violation (bad magic / oversized frame / truncated read)."""


# The protocol-level name for a desynced/corrupt stream; `WireError` is
# kept as the historical alias (they are the same class — a framing
# violation IS a protocol error, and both are fatal for that connection).
ProtocolError = WireError


def pack_arrays(arrays: dict[str, np.ndarray]) -> bytes:
    """Raw per-array codec.  Layout::

        n_arrays: u32
        repeat:  name_len u16 | name | descr_len u16 | dtype descr |
                 ndim u8 | dims u32* | data_len u64 | C-order bytes
    """
    parts = [_U32.pack(len(arrays))]
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if not arr.flags["C_CONTIGUOUS"]:
            # NB ascontiguousarray would also promote 0-d to 1-d, so only
            # call it when a copy is actually needed
            arr = np.ascontiguousarray(arr)
        name_b = name.encode()
        descr_b = np.lib.format.dtype_to_descr(arr.dtype).encode()
        data = arr.tobytes()
        parts += [_U16.pack(len(name_b)), name_b,
                  _U16.pack(len(descr_b)), descr_b,
                  _U8.pack(arr.ndim),
                  b"".join(_U32.pack(d) for d in arr.shape),
                  _U64.pack(len(data)), data]
    return b"".join(parts)


def unpack_arrays(blob: bytes) -> dict[str, np.ndarray]:
    view = memoryview(blob)
    pos = 0

    def take(n):
        nonlocal pos
        out = view[pos:pos + n]
        pos += n
        return out

    (n_arrays,) = _U32.unpack(take(4))
    arrays = {}
    for _ in range(n_arrays):
        (name_len,) = _U16.unpack(take(2))
        name = bytes(take(name_len)).decode()
        (descr_len,) = _U16.unpack(take(2))
        dtype = np.dtype(bytes(take(descr_len)).decode())
        (ndim,) = _U8.unpack(take(1))
        shape = tuple(_U32.unpack(take(4))[0] for _ in range(ndim))
        (data_len,) = _U64.unpack(take(8))
        arrays[name] = np.frombuffer(take(data_len),
                                     dtype=dtype).reshape(shape)
    return arrays


def encode_frame(kind: str, meta: Optional[dict] = None,
                 graph: Optional[GraphTensor] = None,
                 arrays: Optional[dict[str, np.ndarray]] = None) -> bytes:
    """``graph`` ships a flat-dict GraphTensor payload; ``arrays`` ships a
    bare array dict (header flag ``raw``) — the storage lookups (NBR/FEAT
    et al.) move plain id/feature arrays that are not graphs.  The two
    are mutually exclusive."""
    if graph is not None and arrays is not None:
        raise ValueError("frame carries either a graph or raw arrays")
    head = {"kind": kind, "meta": meta or {}}
    if arrays is not None:
        head["raw"] = True
        payload = pack_arrays(arrays)
    else:
        payload = (pack_arrays(graph_to_flat(graph))
                   if graph is not None else b"")
    header = json.dumps(head).encode()
    return b"".join([MAGIC, _U32.pack(len(header)), header,
                     _U64.pack(len(payload)), payload])


def decode_payload(payload: bytes) -> GraphTensor:
    return flat_to_graph(unpack_arrays(payload))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes; EOFError on clean close, WireError mid-frame
    (including a peer that stalls past the socket's timeout — a partial
    frame must never hang the reader)."""
    chunks, got = [], 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout as exc:
            raise WireError(
                f"peer stalled mid-frame ({got}/{n} bytes)") from exc
        if not chunk:
            if got == 0:
                raise EOFError("stream closed")
            raise WireError(f"stream closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, kind: str, meta: Optional[dict] = None,
               graph: Optional[GraphTensor] = None,
               arrays: Optional[dict[str, np.ndarray]] = None) -> None:
    sock.sendall(encode_frame(kind, meta, graph, arrays))


def recv_frame(sock: socket.socket,
               timeout: Optional[float] = None,
               frame_timeout: Optional[float] = None
               ) -> tuple[str, dict, Optional[GraphTensor]]:
    """Blocking read of one frame.  ``timeout`` (seconds) is applied to a
    non-consuming 1-byte MSG_PEEK, so socket.timeout NEVER discards
    partial data (a consuming timed read could drop 1-3 magic bytes and
    desync the stream — fatal once this framing runs over TCP); once any
    byte is available we read the frame to completion (frames are written
    with a single sendall, so the remainder is in flight).

    ``frame_timeout`` bounds the frame-body reads themselves: a peer that
    goes silent MID-frame (live process, wedged stream — the case the
    peek timeout cannot see) raises `WireError` instead of hanging the
    reader forever.  That error is fatal for the connection (the partial
    frame cannot be resumed), which is exactly how the remote client
    treats it: drop the connection, reconnect, resume from watermark."""
    if timeout is not None:
        sock.settimeout(timeout)
        try:
            if not sock.recv(1, socket.MSG_PEEK):
                raise EOFError("stream closed")
        finally:
            sock.settimeout(None)
    if frame_timeout is not None:
        sock.settimeout(frame_timeout)
    try:
        return _recv_frame_body(sock)
    finally:
        if frame_timeout is not None:
            sock.settimeout(None)


def _recv_frame_body(sock: socket.socket
                     ) -> tuple[str, dict,
                                Optional[GraphTensor | dict[str,
                                                            np.ndarray]]]:
    magic = _recv_exact(sock, len(MAGIC))
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    (header_len,) = _U32.unpack(_recv_exact(sock, _U32.size))
    if header_len > MAX_HEADER_BYTES:
        raise WireError(f"header of {header_len} bytes exceeds limit")
    header = json.loads(_recv_exact(sock, header_len))
    (payload_len,) = _U64.unpack(_recv_exact(sock, _U64.size))
    if payload_len > MAX_PAYLOAD_BYTES:
        raise WireError(f"payload of {payload_len} bytes exceeds limit")
    if not payload_len:
        payload = None
    elif header.get("raw"):
        # raw array-dict frame (NBR/FEAT family): hand back the decoded
        # dict as-is — there is no GraphTensor to reconstruct
        payload = unpack_arrays(_recv_exact(sock, payload_len))
    else:
        payload = decode_payload(_recv_exact(sock, payload_len))
    return header["kind"], header.get("meta", {}), payload


def socket_pair() -> tuple[socket.socket, socket.socket]:
    """A connected (trainer_end, worker_end) stream pair.  The kernel
    buffer on each end is the backpressure bound; we leave the OS default
    (a few hundred KB–MB ≈ a couple of batches in flight)."""
    return socket.socketpair()
