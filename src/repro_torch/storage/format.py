"""GraphDirectory — the out-of-core, memory-mappable on-disk graph format
(a copy of `repro.storage.format`: a directory written by either package
equals one written by the other, file for file and byte for byte, and
reads give the same arrays).  One difference: the bounded-RSS feature
gather (`MmapGraphStore(gather_chunk_rows=...)`) reads its rows from the
file with positional reads instead of faulting them in through the
mapping, because on some platforms (gVisor, for one) the first fault of
a mapping makes the whole file resident, so no madvise can bound it.

A `GraphDirectory` holds one heterogeneous graph as plain ``.npy`` files
so `np.load(..., mmap_mode="r")` can open a billion-edge store without
reading it::

    <dir>/
      schema.json                GraphSchema.to_json()
      meta.json                  {"format": "graphdir-v1",
                                  "num_nodes": {set: n},
                                  "edge_sets": {name: {"num_edges": E,
                                    "sorted_by_target": bool}},
                                  "node_features": {set: [feature, ...]}}
      edges/<name>.indptr.npy    int64 [n_src + 1]  CSR row pointers
      edges/<name>.indices.npy   int64 [E]          target ids, CSR order
      nodes/<set>.<feature>.npy  feature matrix [n, ...]

Edges are CSR by SOURCE node — `neighbors(edge_set, u)` is the O(degree)
slice ``indices[indptr[u]:indptr[u+1]]``.  `write_graph` emits indices in
exactly ``np.argsort(src, kind="stable")`` order — the SAME order
`GraphStore._reindex` derives in memory — so a `MmapGraphStore` returns
byte-identical neighbor arrays and the whole sampling stack
(`sample_subgraph`, `InMemorySampler`, the worker fleet) is bit-identical
on top of it.  ``meta.json`` is written last via tmp+rename: a directory
without it is an aborted write, not a graph.

Per-edge-set ``sorted_by_target`` records when the CSR emit order happens
to also be globally non-decreasing in target id — the layout bit
`BatchPlan.edges_sorted_by_target` (see `repro_torch.data.grouping`)
exists to propagate.
"""
from __future__ import annotations

import json
import mmap
import os
from collections.abc import MutableMapping
from typing import Iterator

import numpy as np

from repro_torch.core.schema import GraphSchema
from repro_torch.data.sampling import GraphStore

FORMAT_NAME = "graphdir-v1"


def _feature_path(path: str, node_set: str, feature: str) -> str:
    for part in (node_set, feature):
        if os.sep in part or (os.altsep and os.altsep in part):
            raise ValueError(f"name {part!r} contains a path separator")
    return os.path.join(path, "nodes", f"{node_set}.{feature}.npy")


def _edge_paths(path: str, name: str) -> tuple[str, str]:
    if os.sep in name or (os.altsep and os.altsep in name):
        raise ValueError(f"edge set name {name!r} contains a path separator")
    base = os.path.join(path, "edges", name)
    return base + ".indptr.npy", base + ".indices.npy"


def write_graph(store: GraphStore, path: str) -> str:
    """Convert any `GraphStore` into a `GraphDirectory` at `path`.

    Returns `path`.  The write is commit-marked: every array lands first,
    ``meta.json`` is renamed into place last, and `MmapGraphStore`
    refuses directories without it."""
    os.makedirs(os.path.join(path, "edges"), exist_ok=True)
    os.makedirs(os.path.join(path, "nodes"), exist_ok=True)

    edge_meta = {}
    for name in sorted(store.edges):
        src, tgt = store.edges[name]
        src = np.asarray(src, np.int64)
        tgt = np.asarray(tgt, np.int64)
        n_src = store.num_nodes[store.schema.edge_sets[name].source]
        # exactly GraphStore._reindex's order: stable argsort by source,
        # NO re-sorting of targets within a neighbor list — this is what
        # keeps mmap-backed sampling bit-identical to in-memory
        order = np.argsort(src, kind="stable")
        indices = tgt[order]
        counts = np.bincount(src, minlength=n_src).astype(np.int64)
        indptr = np.zeros(n_src + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        indptr_path, indices_path = _edge_paths(path, name)
        np.save(indptr_path, indptr)
        np.save(indices_path, indices)
        edge_meta[name] = {
            "num_edges": int(len(indices)),
            "sorted_by_target": bool(
                indices.size < 2 or np.all(np.diff(indices) >= 0)),
        }

    feature_meta = {}
    for ns_name in sorted(store.node_features):
        feats = store.node_features[ns_name]
        feature_meta[ns_name] = sorted(feats)
        for feat_name in sorted(feats):
            np.save(_feature_path(path, ns_name, feat_name),
                    np.asarray(feats[feat_name]))

    with open(os.path.join(path, "schema.json"), "w") as f:
        f.write(store.schema.to_json())
    meta = {
        "format": FORMAT_NAME,
        "num_nodes": {k: int(v) for k, v in store.num_nodes.items()},
        "edge_sets": edge_meta,
        "node_features": feature_meta,
    }
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, "meta.json"))
    return path


def graph_bytes(path: str) -> int:
    """Total payload bytes of a `GraphDirectory` (all ``.npy`` files) —
    the denominator of every out-of-core RSS gate."""
    total = 0
    for sub in ("edges", "nodes"):
        d = os.path.join(path, sub)
        if not os.path.isdir(d):
            continue
        for fn in os.listdir(d):
            if fn.endswith(".npy"):
                total += os.path.getsize(os.path.join(d, fn))
    return total


def _open_mmap(path: str) -> np.ndarray:
    """``np.load(mmap_mode="r")`` plus ``MADV_RANDOM``.

    Subgraph sampling touches feature rows and neighbor lists in seed
    order — effectively random over the file — and Linux's default
    fault-around maps ~16 pages per fault, which silently drags most of
    the file into RSS over an epoch.  MADV_RANDOM limits readahead to
    the fault actually taken.  NOTE this is advice, not a bound: on
    kernels with large-folio page cache (6.x) a single-row fault can
    still map a 2 MiB folio, so a random gather of R rows costs up to
    R * 2 MiB of RSS no matter what madvise says, and where the first
    fault maps the whole file, one row costs the file.  The hard bound
    comes from `MmapGraphStore(gather_chunk_rows=...)`, which reads
    feature rows without touching the mapping (`_read_rows`)."""
    arr = np.load(path, mmap_mode="r")
    mm = getattr(arr, "_mmap", None)
    if mm is not None and hasattr(mmap, "MADV_RANDOM"):
        try:
            mm.madvise(mmap.MADV_RANDOM)
        except OSError:  # pragma: no cover — exotic fs; advice only
            pass
    return arr


def _read_rows(arr: np.ndarray, ids: np.ndarray, chunk: int) -> np.ndarray:
    """``np.asarray(arr[ids])`` for a memory-mapped ``.npy`` array, read
    from its file with positional reads: no page of the mapping is
    touched, so the process holds only the rows it asked for.  The
    distinct ids are read in file order, each run of consecutive rows
    (at most `chunk` of them) with one read; other arrays are indexed
    as they are."""
    if not (isinstance(arr, np.memmap) and arr.ndim >= 1
            and arr.flags["C_CONTIGUOUS"] and arr.filename):
        return np.asarray(arr[ids])
    n = arr.shape[0]
    if ids.size and (ids.min() < -n or ids.max() >= n):
        raise IndexError(f"index out of bounds for axis 0 with size {n}")
    uniq, inverse = np.unique(np.where(ids < 0, ids + n, ids),
                              return_inverse=True)
    rows = np.empty((len(uniq),) + arr.shape[1:], arr.dtype)
    row_bytes = rows.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
    if row_bytes and len(uniq):
        buf = memoryview(rows.reshape(-1).view(np.uint8))
        # a run ends where the next id is not the next row, or at `chunk`
        breaks = np.flatnonzero(np.diff(uniq) != 1) + 1
        starts = sorted(set(breaks.tolist()) | set(range(0, len(uniq),
                                                         chunk)))
        fd = os.open(arr.filename, os.O_RDONLY)
        try:
            for lo, hi in zip(starts, starts[1:] + [len(uniq)]):
                want = (hi - lo) * row_bytes
                view = buf[lo * row_bytes:hi * row_bytes]
                off = arr.offset + int(uniq[lo]) * row_bytes
                got = 0
                while got < want:
                    k = os.preadv(fd, [view[got:]], off + got)
                    if k == 0:
                        raise EOFError(f"{arr.filename}: short read")
                    got += k
        finally:
            os.close(fd)
    return rows[inverse.reshape(ids.shape)]


def _madv_dontneed(arr: np.ndarray) -> None:
    """Zap the page-table entries behind a memory-mapped array.

    MADV_DONTNEED on a read-only file mapping releases the process's
    RSS for those pages without touching the page cache — the data
    refaults (minor fault, no I/O while cached) on next access, so
    live numpy views into the mapping stay valid and byte-identical."""
    mm = getattr(arr, "_mmap", None)
    if mm is None or not hasattr(mmap, "MADV_DONTNEED"):
        return
    try:
        mm.madvise(mmap.MADV_DONTNEED)
    except OSError:  # pragma: no cover — advice only
        pass


class _LazyEdgePairs(MutableMapping):
    """Mapping-shaped view over a `GraphDirectory`'s edge sets that
    materializes ``(src, tgt)`` pairs only on access.

    Materialized pairs are in CSR order (sorted by source) — the same
    edge MULTISET as the original store, permuted.  Every consumer of
    `.edges` in this repo (`_reindex`, `VersionedGraphStore.add_edges`)
    is order-insensitive, but byte-level equality with the pre-convert
    arrays is intentionally not promised.  ``dict(edges)`` (which
    `GraphStore.__init__` does when wrapping) materializes everything —
    the documented price of adopting an out-of-core store into a mutable
    one."""

    def __init__(self, loader, names):
        self._loader = loader
        self._names = list(names)
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self.overridden: set[str] = set()  # keys replaced via __setitem__

    def __getitem__(self, key: str) -> tuple[np.ndarray, np.ndarray]:
        if key in self._cache:
            return self._cache[key]
        if key not in self._names:
            raise KeyError(key)
        self._cache[key] = self._loader(key)
        return self._cache[key]

    def __setitem__(self, key: str, value) -> None:
        if key not in self._names:
            self._names.append(key)
        self._cache[key] = value
        self.overridden.add(key)

    def __delitem__(self, key: str) -> None:
        if key not in self._names:
            raise KeyError(key)
        self._names.remove(key)
        self._cache.pop(key, None)
        self.overridden.discard(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


class MmapGraphStore(GraphStore):
    """`GraphStore` over a `GraphDirectory`: feature matrices and CSR
    edge files are ``np.memmap``-backed, so opening costs a few header
    reads and sampling touches only the pages it actually slices.

    Satisfies the full `GraphStore` interface — `neighbors` /
    `neighbors_batch` / `gather_node_features` / `.edges` /
    `.node_features` — so `sample_subgraph`, `InMemorySampler`, sampler
    workers, and `VersionedGraphStore.wrap` run unmodified.  `_reindex`
    is free for untouched edge sets (the on-disk indptr IS the index);
    it falls back to the in-memory rebuild only for edge sets mutated
    through `.edges`.

    `gather_chunk_rows` turns on the bounded-RSS gather path: feature
    gathers read the rows they need from the files with positional
    reads (at most that many rows a read, `_read_rows`) and never touch
    the feature mappings, and neighbor lookups drop their edge files'
    PTEs after each batch.  This is what makes "peak RSS well below
    graph bytes" a HARD bound — on large-folio kernels every touched
    row maps a 2 MiB folio, so an unbounded random gather of R rows can
    pin R * 2 MiB regardless of MADV_RANDOM, and where a first fault
    maps the whole file, one row pins the file.  Reads cap the window
    at the rows asked for (the materialized output, twice while
    duplicate ids are expanded).  Results are byte-identical either way;
    the cost is a read syscall per run of rows, so leave it ``None`` for
    throughput-critical in-process use and set it in memory-budgeted
    sampler workers."""

    def __init__(self, path: str, *, gather_chunk_rows: int | None = None):
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{path!r} is not a GraphDirectory (no meta.json — "
                "missing or aborted write_graph)")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT_NAME:
            raise ValueError(f"unsupported graph format "
                             f"{meta.get('format')!r} at {path!r}")
        with open(os.path.join(path, "schema.json")) as f:
            schema = GraphSchema.from_json(f.read())

        self.path = path
        self.schema = schema
        self.num_nodes = {k: int(v) for k, v in meta["num_nodes"].items()}
        self.edges_sorted_by_target = {
            name: bool(info["sorted_by_target"])
            for name, info in meta["edge_sets"].items()}
        self._indptr: dict[str, np.ndarray] = {}
        self._indices: dict[str, np.ndarray] = {}
        for name in meta["edge_sets"]:
            indptr_path, indices_path = _edge_paths(path, name)
            self._indptr[name] = _open_mmap(indptr_path)
            self._indices[name] = _open_mmap(indices_path)
        self.node_features = {
            ns: {feat: _open_mmap(_feature_path(path, ns, feat))
                 for feat in feats}
            for ns, feats in meta["node_features"].items()}
        self.edges = _LazyEdgePairs(self._load_pair, meta["edge_sets"])
        self._index: dict[str, tuple[np.ndarray, np.ndarray,
                                     np.ndarray]] = {}
        if gather_chunk_rows is not None and gather_chunk_rows < 1:
            raise ValueError("gather_chunk_rows must be >= 1 or None")
        self.gather_chunk_rows = gather_chunk_rows

    def _load_pair(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        indptr = self._indptr[name]
        src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                        np.diff(indptr))
        return src, self._indices[name]

    def _reindex(self, name: str) -> None:
        if name in self.edges.overridden:
            super()._reindex(name)
            return
        indptr = self._indptr[name]
        # zero-copy: the on-disk CSR already is (starts, ends, targets)
        self._index[name] = (indptr[:-1], indptr[1:], self._indices[name])

    def gather_node_features(self, node_set: str,
                             ids: np.ndarray) -> dict[str, np.ndarray]:
        chunk = self.gather_chunk_rows
        if chunk is None:
            return super().gather_node_features(node_set, ids)
        ids = np.asarray(ids, np.int64)
        return {feat: _read_rows(arr, ids, chunk)
                for feat, arr in self.node_features.get(node_set,
                                                        {}).items()}

    def neighbors_batch(self, edge_set: str,
                        nodes) -> list[np.ndarray]:
        result = super().neighbors_batch(edge_set, nodes)
        if self.gather_chunk_rows is not None:
            # views into the mapping survive the drop (they refault
            # from page cache); only this process's RSS is released
            _madv_dontneed(self._indptr.get(edge_set))
            _madv_dontneed(self._indices.get(edge_set))
        return result

    def drop_page_cache(self) -> None:
        """Release every mapped page from this process's RSS (the files
        stay open and every live view stays valid).  Sampler workers
        call this between assignments as a maintenance hook; with
        `gather_chunk_rows` set, neighbor lookups drop their edge files'
        pages implicitly."""
        for arrs in (self._indptr, self._indices):
            for arr in arrs.values():
                _madv_dontneed(arr)
        for feats in self.node_features.values():
            for arr in feats.values():
                _madv_dontneed(arr)
