"""Serving caches: a versioned GraphStore plus epoch-invalidated LRU caches
— a copy of `repro.serve.cache`, held to the original by
tests/test_torch_host_parity.py.

The serving path (repro_torch.serve.gnn) fronts on-demand subgraph sampling with
two caches:

  * a *sampled-subgraph* cache — root id -> the rooted GraphTensor that
    Algorithm 1 would produce for it, and
  * a *node-embedding* (result) cache — root id -> the model's served
    output row for that root,

both keyed against the graph's **mutation epoch**.  `VersionedGraphStore`
extends the read-only `repro_torch.data.sampling.GraphStore` with explicit
mutation methods that bump a monotonic ``version`` counter; every cache
entry is tagged with the version it was produced under, so a graph
mutation invalidates all stale entries without the serving loop having to
track *which* roots a mutation could reach (a topology edit can change any
subgraph whose frontier crosses it — per-root invalidation would need the
reverse reachability set, which is the sampling problem again).

Determinism contract: for a fixed (store version, base_seed), a cached
subgraph is bit-identical to a fresh `sample_subgraph` draw — the cache is
a pure memo over `seed_rng(base_seed, root)` (see repro_torch.data.sampling).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np

from repro_torch.data.sampling import (GraphStore, SamplingSpec, sample_subgraph,
                                 seed_rng)

MISSING = object()  # cache-miss sentinel (None is a valid cached value)


class VersionedGraphStore(GraphStore):
    """GraphStore with a mutation-epoch counter.

    Reads are the base class unchanged; every mutating method bumps
    ``version`` so version-tagged caches (and any other derived state)
    can detect staleness with one integer compare.  Mutations rebuild the
    touched edge set's CSR index in place — readers in the same thread
    observe the new graph immediately; the serving engine thread observes
    it at its next version check (single-writer, eventually-consistent
    by design).
    """

    def __init__(self, schema, edges, node_features, num_nodes):
        super().__init__(schema, edges, node_features, num_nodes)
        self._version = 0

    @classmethod
    def wrap(cls, store: GraphStore) -> "VersionedGraphStore":
        """Adopt an existing store's arrays (no data copy) at version 0."""
        return cls(store.schema, store.edges, store.node_features,
                   store.num_nodes)

    @property
    def version(self) -> int:
        return self._version

    def bump_version(self) -> int:
        """Declare an out-of-band mutation (direct array edits)."""
        self._version += 1
        return self._version

    def add_edges(self, edge_set_name: str, src, tgt) -> int:
        """Append edges to one edge set and re-index it."""
        src = np.asarray(src, np.int64)
        tgt = np.asarray(tgt, np.int64)
        if src.shape != tgt.shape:
            raise ValueError(f"src/tgt length mismatch: {src.shape} vs "
                             f"{tgt.shape}")
        old_src, old_tgt = self.edges[edge_set_name]
        self.edges[edge_set_name] = (np.concatenate([old_src, src]),
                                     np.concatenate([old_tgt, tgt]))
        self._reindex(edge_set_name)
        return self.bump_version()

    def update_node_features(self, node_set_name: str, feature: str,
                             ids, values) -> int:
        """Overwrite feature rows for the given node ids.

        Copy-on-write for read-only arrays: wrapping an out-of-core
        `repro.storage.MmapGraphStore` adopts ``mmap_mode="r"`` feature
        matrices, which cannot (and must not — the GraphDirectory on
        disk is shared by every shard) be written through.  The first
        write to such a feature materializes a private RAM copy; untouched
        features stay memory-mapped."""
        arr = self.node_features[node_set_name][feature]
        if not arr.flags.writeable:
            arr = np.array(arr)
            self.node_features[node_set_name][feature] = arr
        arr[np.asarray(ids, np.int64)] = values
        return self.bump_version()


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Point-in-time counter snapshot (hit_rate derived)."""
    hits: int
    misses: int
    evictions: int
    invalidations: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class VersionedLRUCache:
    """Thread-safe LRU keyed on (key, version): a lookup under a newer
    version than an entry was stored at is a miss AND evicts the stale
    entry.  `sweep(version)` evicts every stale entry eagerly — the
    explicit invalidation hook the serving engine calls when it observes
    a store-version change."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, tuple[int, object]]" = \
            OrderedDict()
        self._hits = self._misses = self._evictions = 0
        self._invalidations = 0

    def get(self, key, version: int):
        """The cached value, or `MISSING`."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return MISSING
            if entry[0] != version:
                del self._entries[key]
                self._invalidations += 1
                self._misses += 1
                return MISSING
            self._entries.move_to_end(key)
            self._hits += 1
            return entry[1]

    def put(self, key, version: int, value) -> None:
        with self._lock:
            self._entries[key] = (version, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1

    def sweep(self, version: int) -> int:
        """Evict every entry not stored at `version`; returns the count."""
        with self._lock:
            stale = [k for k, (v, _) in self._entries.items()
                     if v != version]
            for k in stale:
                del self._entries[k]
            self._invalidations += len(stale)
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    @property
    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(self._hits, self._misses, self._evictions,
                              self._invalidations, len(self._entries),
                              self.capacity)


class SubgraphCache:
    """Sampled-subgraph cache over a (versioned) GraphStore.

    `get(root)` returns the rooted subgraph for `root` under the store's
    CURRENT version — served from cache when fresh, re-sampled via
    `sample_subgraph(store, spec, root, seed_rng(base_seed, root))` on a
    miss.  A store-version change triggers an eager `sweep` of every
    stale entry (the "mutating the GraphStore bumps the version and
    evicts stale entries" contract).  Plain `GraphStore`s (no
    `version` attribute) are served at a constant version 0."""

    def __init__(self, store: GraphStore, spec: SamplingSpec, *,
                 capacity: int = 4096, base_seed: int = 0):
        self.store = store
        self.spec = spec
        self.base_seed = base_seed
        self._cache = VersionedLRUCache(capacity)
        self._seen_version = self._store_version()

    def _store_version(self) -> int:
        return getattr(self.store, "version", 0)

    def get(self, root: int):
        version = self._store_version()
        if version != self._seen_version:
            self._cache.sweep(version)
            self._seen_version = version
        graph = self._cache.get(int(root), version)
        if graph is MISSING:
            graph = sample_subgraph(self.store, self.spec, int(root),
                                    seed_rng(self.base_seed, int(root)))
            self._cache.put(int(root), version, graph)
        return graph

    @property
    def stats(self) -> CacheStats:
        return self._cache.stats
