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
     served batch has one of a handful of shapes,
  3. runs the model's forward for that bucket and scatters per-component
     rows back to the waiting requests, writing each root's output
     through the node-embedding cache.

The reference runs one compiled forward per bucket: `jax.jit(apply_fn)`
(`repro/serve/gnn.py:280-282`), compiled for every rung by `warmup()`
(`:323-334`), with `steady_state_recompiles` counting the compiles after
it (`:307-321`).  Here the counterpart of an XLA executable per rung is a
CUDA graph per rung (``capture_graphs=True``, mirroring ``jit_apply``):
`warmup()` runs each rung eagerly once (the kernels build and load, and
their one-time shared-memory opt-ins happen outside capture), then
captures each rung's forward with `torch.cuda.graph` into one shared
memory pool, largest rung first, over a static device GraphTensor of
that rung's `SizeConstraints`.  A served batch is copied into that
rung's static leaves through pinned host buffers, the graph is replayed,
and the static output is copied back to the host before the next replay
can overwrite it.  `steady_state_recompiles` counts captures after
warmup.  Nothing falls back: a capture or replay that fails raises (at
construction, or as its batch's `ServeError`).  ``capture_graphs=False``,
and any server on the CPU, runs the forward eagerly; the compile count is
then bucket accounting (a bucket served that warmup never ran).

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

from repro_torch.core.graph_tensor import (graph_leaves, leaf_dtype,
                                           resolve_device, to_device)
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


class _RungGraph:
    """One bucket's captured forward: the CUDA graph, its static device
    input leaves (each with a pinned host buffer of the same shape and
    dtype) and static output (with its pinned host buffer)."""

    def __init__(self, graph, structure, inputs, out):
        self.graph = graph
        self.structure = structure
        self.inputs = [(t, torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)) for t in inputs]
        self.out = out
        self.out_host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)

    def stage(self, merged) -> None:
        """Copy a merged host batch into the static leaves (pinned,
        non-blocking, on the calling thread's stream).  A batch of
        another structure, or a leaf of another shape or dtype than the
        captured one, raises."""
        structure, leaves = graph_leaves(merged)
        if structure != self.structure:
            raise ValueError("batch structure differs from the captured "
                             f"one: {structure} vs {self.structure}")
        for i, ((static, host), leaf) in enumerate(zip(self.inputs,
                                                       leaves)):
            arr = np.asarray(leaf)
            if arr.shape != tuple(static.shape) or \
                    leaf_dtype(arr.dtype) != static.dtype:
                raise ValueError(
                    f"leaf {i}: {arr.dtype} {arr.shape} differs from the "
                    f"captured {static.dtype} {tuple(static.shape)}")
            host.numpy()[...] = arr
            static.copy_(host, non_blocking=True)

    def replay(self, device) -> np.ndarray:
        """Replay the graph and copy its output to the host; returns a
        host copy, so the next replay cannot overwrite it."""
        self.graph.replay()
        self.out_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        return self.out_host.numpy().copy()


class GNNServer:
    """The request path: submit(root) -> ServeRequest; an engine thread
    micro-batches concurrent requests into bucket-padded GraphTensors and
    runs one forward per batch on `device` — on CUDA a replay of that
    bucket's graph captured at warmup (``capture_graphs=True``, the
    counterpart of the reference's ``jit_apply``), else eagerly.

    `apply_fn(graph) -> Tensor [C, ...]` takes the padded scalar
    GraphTensor on the device and returns component-major output rows
    (component i of a served batch is request i, in admission order;
    padding components trail and their rows are dropped).  The model's
    parameters live in `apply_fn` (an nn.Module or a closure over one).
    To be captured, its forward must not sync the host (no `.item()`, no
    `nonzero`, no branch on a tensor's value): such a sync aborts the
    capture, and the constructor raises.

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
                 capture_graphs: bool = True,
                 queue_depth: int = 4096):
        self.device = resolve_device(device)
        self.store = store
        self.spec = spec
        self._apply = apply_fn
        self.capture_graphs = capture_graphs and self.device.type == "cuda"
        self._graphs: dict[int, _RungGraph] = {}
        self._graph_lock = threading.Lock()
        self._graph_pool = self._capture_stream = None
        self._captures = self._warm_captures = 0
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

    def run_eager(self, merged) -> np.ndarray:
        """One eager forward over a merged, padded host batch: copy to the
        device, run the model without autograd, return host rows.  The
        batches are not sorted by target, and the layout says so whatever
        the calling thread holds (warmup runs on the constructor's)."""
        with torch.inference_mode(), \
                registry.layout(sorted_by_target=False):
            out = self._apply(to_device(merged, self.device))
            if out.dtype == torch.bfloat16:
                out = out.to(torch.float32)  # numpy has no bfloat16
            return out.cpu().numpy()

    def run_batch(self, merged) -> np.ndarray:
        """One forward over a merged, padded host batch of a ladder rung
        (``num_components - 1`` requests' capacity): with graphs, copy it
        into the rung's static leaves, replay the rung's graph and return
        the host rows (a rung warmup did not capture is run eagerly and
        captured first, which counts as a steady-state recompile); else
        `run_eager`."""
        if not self.capture_graphs:
            return self.run_eager(merged)
        rung = self.ladder.bucket_for(merged.num_components - 1)
        with self._graph_lock:
            rung_graph = self._graphs.get(rung)
            if rung_graph is None:
                self._warm(merged)
                rung_graph = self._capture(rung, merged)
            rung_graph.stage(merged)
            return rung_graph.replay(self.device)

    def _warm(self, merged) -> None:
        """One eager forward on the capture stream, outside capture: the
        kernels build and load, and make their one-time opt-ins (the edge
        kernels' shared-memory attribute), and the stream's library
        handles exist before a graph is captured on it."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.run_eager(merged)

    def _capture(self, rung: int, merged) -> _RungGraph:
        """Capture rung `rung`'s forward over a static device copy of
        `merged` (a batch of that rung) on the capture stream, into the
        server's one memory pool, after `_warm`.  The caller holds the
        graph lock."""
        static = to_device(merged, self.device)
        structure, inputs = graph_leaves(static)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), \
                registry.layout(sorted_by_target=False), \
                torch.cuda.graph(graph, pool=self._graph_pool,
                                 stream=self._capture_stream,
                                 capture_error_mode="thread_local"):
            out = self._apply(static)
            if out.dtype == torch.bfloat16:
                out = out.to(torch.float32)  # numpy has no bfloat16
        rung_graph = _RungGraph(graph, structure, inputs, out)
        self._graphs[rung] = rung_graph
        self._captures += 1
        return rung_graph

    @property
    def steady_state_recompiles(self) -> int:
        """Captures after warmup (eagerly: buckets served that warmup
        never ran).  Zero is the serving invariant: every steady-state
        batch replays a graph warmup captured — the counterpart of the
        reference's compile count."""
        if self.capture_graphs:
            return self._captures - self._warm_captures
        with self._state_lock:
            return len(self._served_buckets - self._warm_buckets)

    def warmup(self, warmup_root: int = 0) -> None:
        """Run every bucket's shape once (one dummy batch per rung): the
        kernels build and load before any live request arrives.  With
        graphs, then capture every rung, largest first, so the smaller
        rungs' graphs reuse the pool's memory."""
        graph = self._subgraphs.get(warmup_root)
        batches = {rung: merge_and_pad([graph], self.ladder.sizes[rung])
                   for rung in self.ladder.rungs}
        if self.capture_graphs:
            with self._graph_lock:
                todo = [rung for rung in sorted(batches, reverse=True)
                        if rung not in self._graphs]
                for rung in todo:
                    self._warm(batches[rung])
                for rung in todo:
                    self._capture(rung, batches[rung])
                self._warm_captures = self._captures
        else:
            for merged in batches.values():
                self.run_eager(merged)
        self._warm_buckets.update(batches)

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
