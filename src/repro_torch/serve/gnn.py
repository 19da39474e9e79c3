"""Low-latency GNN inference serving on the GPU (counterpart of
`repro.serve.gnn`).

A request is a query node id.  The server:

  1. samples the rooted subgraph around it on demand (Algorithm 1 via
     `repro_torch.data.sampling.sample_subgraph`, fronted by the
     versioned subgraph cache in `repro_torch.serve.cache`),
  2. micro-batches concurrent requests: an engine thread drains the
     request queue for a short batching window, then merges the batch
     into ONE padded GraphTensor whose `SizeConstraints` come from a small
     fixed ladder of buckets (powers of two up to `max_batch`), so every
     served batch has one of a handful of shapes, all run once during
     warmup,
  3. copies the batch to the device, runs the model's forward under
     `torch.inference_mode()`, and scatters per-component rows back to the
     waiting requests, writing each root's output through the
     node-embedding cache.

The model runs eagerly (there is no jit): the reference's compile
counter becomes bucket accounting — a bucket served that warmup never
ran counts as a steady-state recompile.

The ladder is plain powers of two up to `max_batch`.  The reference cuts
its top rungs to stay inside a TPU kernel's VMEM budget; the GPU kernels
have no segment-count or width cap, so e.g. the §8 spec at max_batch=8
keeps rung 8.

The server runs on CUDA unless the caller passes ``device="cpu"``; with
no device given and no CUDA device present it raises.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph_tensor import resolve_device, to_device
from repro_torch.data.batching import SizeConstraints
from repro_torch.data.grouping import merge_and_pad
from repro_torch.data.sampling import GraphStore, SamplingSpec
from repro_torch.kernels import registry
from repro_torch.serve.cache import MISSING, SubgraphCache, VersionedLRUCache


class ServeError(RuntimeError):
    """Base class for serving failures surfaced through ServeRequest."""


class EngineClosed(ServeError):
    """The engine stopped (close() or crash) before serving the request."""


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

class ServeRequest:
    """One in-flight query.  Fulfilled (or failed) exactly once; `result`
    blocks with a bounded wait and re-raises engine errors instead of
    hanging."""

    def __init__(self, root: int):
        self.root = int(root)
        self.submitted_at = time.perf_counter()
        self.done_at: Optional[float] = None
        self.cache_hit = False
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None

    def _fulfill(self, value, *, cache_hit: bool = False) -> None:
        with self._lock:
            if self._event.is_set():
                return  # close() raced a late engine completion: first wins
            self._value = value
            self.cache_hit = cache_hit
            self.done_at = time.perf_counter()
            self._event.set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._error = exc
            self.done_at = time.perf_counter()
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request for root {self.root} not served within "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> float:
        if self.done_at is None:
            raise ValueError("request not done yet")
        return self.done_at - self.submitted_at


# ---------------------------------------------------------------------------
# Bucket ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """A small fixed set of batch capacities with their padded
    SizeConstraints; `bucket_for(n)` is a pure function of n, so the
    padded shapes of any served batch are a deterministic function of its
    request count."""

    rungs: tuple  # sorted batch capacities, e.g. (1, 2, 4, 8)
    sizes: Mapping[int, SizeConstraints]  # rung -> padded constraints

    def __post_init__(self):
        if not self.rungs:
            raise ValueError("empty bucket ladder")
        if tuple(sorted(self.rungs)) != tuple(self.rungs):
            raise ValueError(f"rungs must be sorted, got {self.rungs}")

    @property
    def max_batch(self) -> int:
        return self.rungs[-1]

    def bucket_for(self, n_requests: int) -> int:
        """Smallest rung holding `n_requests` (pure; no engine state)."""
        if n_requests < 1:
            raise ValueError(f"need >= 1 request, got {n_requests}")
        for rung in self.rungs:
            if rung >= n_requests:
                return rung
        raise ValueError(f"{n_requests} requests exceed max bucket "
                         f"{self.max_batch}")


def spec_size_bounds(spec: SamplingSpec, schema) -> SizeConstraints:
    """Worst-case PER-REQUEST SizeConstraints, analytically from the
    sampling spec: a frontier of k nodes expanded through an op of
    `sample_size` s yields at most k*s edges (and k*s new target nodes).

    Counts follow `sample_subgraph`'s assembly exactly: node sets are the
    seed set plus every sampled edge set's endpoints; edge sets are the
    sampled ones plus any schema edge set with both endpoints present
    (materialised with one phantom row when empty, hence the max(., 1))."""
    max_out = {spec.seed_op_name: 1}
    nodes: dict[str, int] = {spec.seed_node_set: 1}
    edges: dict[str, int] = {}
    for op in spec.sampling_ops:
        es = schema.edge_sets[op.edge_set_name]
        frontier = sum(max_out[name] for name in op.input_op_names)
        drawn = frontier * op.sample_size
        nodes.setdefault(es.source, 0)
        nodes[es.target] = nodes.get(es.target, 0) + drawn
        edges[op.edge_set_name] = edges.get(op.edge_set_name, 0) + drawn
        max_out[op.op_name] = drawn
    for name, es in schema.edge_sets.items():
        if es.source in nodes and es.target in nodes:
            edges[name] = max(edges.get(name, 0), 1)
    return SizeConstraints(
        total_num_components=2,
        total_num_nodes=dict(nodes),
        total_num_edges=edges)


def build_ladder(base_sizes: SizeConstraints,
                 max_batch: int) -> BucketLadder:
    """Power-of-two rungs up to `max_batch` (and `max_batch` itself),
    each rung b padded to b x the per-request `base_sizes` (+1 padding
    component)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    rungs = []
    rung = 1
    while rung < max_batch:
        rungs.append(rung)
        rung *= 2
    rungs.append(max_batch)

    def sizes_for(b: int) -> SizeConstraints:
        return SizeConstraints(
            total_num_components=b + 1,
            total_num_nodes={k: v * b
                             for k, v in base_sizes.total_num_nodes.items()},
            total_num_edges={k: v * b
                             for k, v in base_sizes.total_num_edges.items()})

    return BucketLadder(tuple(rungs), {b: sizes_for(b) for b in rungs})


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeSnapshot:
    """Point-in-time server statistics (all counters monotonic)."""
    requests: int
    served: int
    failed: int
    batches: int
    batch_sizes: Mapping[int, int]   # bucket -> batches served at it
    embedding_hits: int
    embedding_misses: int
    subgraph_hits: int
    subgraph_misses: int
    invalidations: int
    steady_state_recompiles: int


class GNNServer:
    """The request path: submit(root) -> ServeRequest; an engine thread
    micro-batches concurrent requests into bucket-padded GraphTensors and
    runs one forward per batch on `device`.

    `apply_fn(graph) -> Tensor [C, ...]` takes the padded scalar
    GraphTensor on the device and returns component-major output rows
    (component i of a served batch is request i, in admission order;
    padding components trail and their rows are dropped).  The model's
    parameters live in `apply_fn` (an nn.Module or a closure over one).

    Engine lifecycle: one named daemon thread, joined by `close()`;
    pending and in-flight requests are failed with `EngineClosed` on
    shutdown rather than left hanging.
    """

    def __init__(self, store: GraphStore, spec: SamplingSpec,
                 apply_fn: Callable, *,
                 device=None,
                 base_sizes: Optional[SizeConstraints] = None,
                 max_batch: int = 8,
                 batch_window_ms: float = 2.0,
                 subgraph_cache_size: int = 4096,
                 embedding_cache_size: int = 4096,
                 base_seed: int = 0,
                 warmup_root: int = 0,
                 warmup: bool = True,
                 queue_depth: int = 4096):
        self.device = resolve_device(device)
        self.store = store
        self.spec = spec
        self._apply = apply_fn
        base = base_sizes or spec_size_bounds(spec, store.schema)
        self.ladder = build_ladder(base, max_batch)
        self._subgraphs = SubgraphCache(store, spec,
                                        capacity=subgraph_cache_size,
                                        base_seed=base_seed)
        self._embeddings = (VersionedLRUCache(embedding_cache_size)
                            if embedding_cache_size > 0 else None)
        self._window_s = batch_window_ms / 1e3
        self._poll_s = 0.05
        self._queue: "queue.Queue[ServeRequest]" = queue.Queue(queue_depth)
        self._stop = threading.Event()
        self._closed = False
        self._state_lock = threading.Lock()
        self._inflight: list[ServeRequest] = []
        self._requests = self._served = self._failed = 0
        self._batches = 0
        self._batch_sizes: dict[int, int] = {}
        self._served_buckets: set[int] = set()
        self._warm_buckets: set[int] = set()
        if warmup:
            self.warmup(warmup_root)
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="gnn-serve-engine",
                                        daemon=True)
        self._thread.start()

    # -- forward -------------------------------------------------------------

    def run_batch(self, merged) -> np.ndarray:
        """One forward over a merged, padded host batch: copy to the
        device, run the model without autograd, return host rows.  The
        batches are not sorted by target, and the layout says so whatever
        the calling thread holds (warmup runs on the constructor's)."""
        with torch.inference_mode(), \
                registry.layout(sorted_by_target=False):
            out = self._apply(to_device(merged, self.device))
            if out.dtype == torch.bfloat16:
                out = out.to(torch.float32)  # numpy has no bfloat16
            return out.cpu().numpy()

    @property
    def steady_state_recompiles(self) -> int:
        """Buckets served that warmup never ran.  Zero is the serving
        invariant: every steady-state batch has a shape warmup already
        ran (the eager counterpart of the reference's compile count)."""
        with self._state_lock:
            return len(self._served_buckets - self._warm_buckets)

    def warmup(self, warmup_root: int = 0) -> None:
        """Run every bucket's shape once (one dummy batch per rung): the
        kernels build and load, and each rung's allocations are made,
        before any live request arrives."""
        graph = self._subgraphs.get(warmup_root)
        for rung in self.ladder.rungs:
            self.run_batch(merge_and_pad([graph], self.ladder.sizes[rung]))
            self._warm_buckets.add(rung)

    # -- request admission ---------------------------------------------------

    def submit(self, root: int) -> ServeRequest:
        """Enqueue one query; returns immediately with a ServeRequest.
        A node-embedding cache hit is fulfilled synchronously (no
        sampling, no batching, no model)."""
        req = ServeRequest(root)
        with self._state_lock:
            if self._closed:
                req._fail(EngineClosed("server is closed"))
                return req
            self._requests += 1
        if self._embeddings is not None:
            version = getattr(self.store, "version", 0)
            value = self._embeddings.get(req.root, version)
            if value is not MISSING:
                req._fulfill(value, cache_hit=True)
                with self._state_lock:
                    self._served += 1
                return req
        try:
            self._queue.put(req, timeout=1.0)
        except queue.Full:
            req._fail(ServeError(
                f"request queue full ({self._queue.maxsize}) — server "
                "overloaded"))
            with self._state_lock:
                self._failed += 1
        return req

    def serve_sync(self, roots: Sequence[int],
                   timeout: float = 60.0) -> np.ndarray:
        """Submit a set of concurrent requests and wait for all of them;
        rows in `roots` order."""
        pending = [self.submit(r) for r in roots]
        return np.stack([np.asarray(p.result(timeout)) for p in pending])

    # -- engine --------------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=self._poll_s)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.monotonic() + self._window_s
                while len(batch) < self.ladder.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                with self._state_lock:
                    self._inflight = list(batch)
                self._serve_batch(batch)
                with self._state_lock:
                    self._inflight = []
        finally:
            # crash or close(): nothing may be left hanging
            self._fail_pending(EngineClosed("engine stopped"))

    def _serve_batch(self, batch: list) -> None:
        try:
            bucket = self.ladder.bucket_for(len(batch))
            # version BEFORE sampling: if a mutation races the batch, the
            # entries are tagged stale and the next lookup recomputes
            version = getattr(self.store, "version", 0)
            graphs = [self._subgraphs.get(req.root) for req in batch]
            out = self.run_batch(merge_and_pad(graphs,
                                               self.ladder.sizes[bucket]))
            with self._state_lock:
                self._batches += 1
                self._batch_sizes[bucket] = \
                    self._batch_sizes.get(bucket, 0) + 1
                self._served_buckets.add(bucket)
                self._served += len(batch)
            for i, req in enumerate(batch):
                row = out[i]
                if self._embeddings is not None:
                    self._embeddings.put(req.root, version, row)
                req._fulfill(row)
        except Exception as exc:  # noqa: BLE001 — a bad batch must fail its own requests, not kill the engine serving everyone else's
            with self._state_lock:
                self._failed += len(batch)
            for req in batch:
                req._fail(ServeError(f"batch failed: {exc!r}"))

    def _fail_pending(self, exc: ServeError) -> None:
        with self._state_lock:
            stranded = list(self._inflight)
            self._inflight = []
        while True:
            try:
                stranded.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in stranded:
            if not req.done():
                with self._state_lock:
                    self._failed += 1
            req._fail(exc)  # no-op on already-completed requests

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the engine, join its thread, and fail every request that
        had not completed.  Idempotent; never hangs past `timeout` even
        if the engine is wedged inside the model (the daemon thread is
        abandoned and its requests are failed)."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._thread.join(timeout)
        self._fail_pending(EngineClosed("server closed"))

    def __enter__(self) -> "GNNServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stats ---------------------------------------------------------------

    @property
    def stats(self) -> ServeSnapshot:
        emb = (self._embeddings.stats if self._embeddings is not None
               else None)
        sub = self._subgraphs.stats
        recompiles = self.steady_state_recompiles
        with self._state_lock:
            return ServeSnapshot(
                requests=self._requests,
                served=self._served,
                failed=self._failed,
                batches=self._batches,
                batch_sizes=dict(self._batch_sizes),
                embedding_hits=emb.hits if emb else 0,
                embedding_misses=emb.misses if emb else 0,
                subgraph_hits=sub.hits,
                subgraph_misses=sub.misses,
                invalidations=(sub.invalidations
                               + (emb.invalidations if emb else 0)),
                steady_state_recompiles=recompiles)
