"""Rooted subgraph sampling (paper §6.1 + Algorithm 1) — a copy of
`repro.data.sampling`, held to the original by
tests/test_torch_host_parity.py.

`SamplingSpecBuilder` is the paper's Fig. 6 fluent API; the produced
`SamplingSpec` drives both the in-memory sampler (§6.1.2) and the
distributed sampler (§6.1.1) — the latter implemented over an
embarrassingly-parallel shard interface: seeds are partitioned into shards,
each shard runs Algorithm 1 independently against the (read-only) graph
store and writes one output file, which is the unit of fault tolerance
(idempotent re-execution on worker failure, as with the paper's Flume
pipeline).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, NodeSet)
from repro_torch.core.schema import GraphSchema

RANDOM_UNIFORM = "RANDOM_UNIFORM"
TOP_K = "TOP_K"


@dataclasses.dataclass(frozen=True)
class SamplingOp:
    op_name: str
    input_op_names: tuple[str, ...]
    edge_set_name: str
    sample_size: int
    strategy: str = RANDOM_UNIFORM


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    seed_node_set: str
    seed_op_name: str
    sampling_ops: tuple[SamplingOp, ...]


class _OpHandle:
    def __init__(self, builder: "SamplingSpecBuilder", op_name: str,
                 node_set: str):
        self.builder = builder
        self.op_name = op_name
        self.node_set = node_set

    def sample(self, sample_size: int, edge_set_name: str) -> "_OpHandle":
        return self.builder._add_op((self,), sample_size, edge_set_name)

    def join(self, others: Sequence["_OpHandle"]) -> "_JoinHandle":
        return _JoinHandle((self, *others), self.builder)

    def build(self) -> SamplingSpec:
        return self.builder._build()


class _JoinHandle:
    def __init__(self, handles, builder):
        self.handles = handles
        self.builder = builder

    def sample(self, sample_size: int, edge_set_name: str) -> _OpHandle:
        return self.builder._add_op(self.handles, sample_size, edge_set_name)


class SamplingSpecBuilder:
    """Fluent builder (paper Fig. 6)."""

    def __init__(self, schema: GraphSchema,
                 default_strategy: str = RANDOM_UNIFORM):
        self.schema = schema
        self.strategy = default_strategy
        self._ops: list[SamplingOp] = []
        self._seed: Optional[_OpHandle] = None

    def seed(self, node_set_name: str) -> _OpHandle:
        assert node_set_name in self.schema.node_sets
        self._seed = _OpHandle(self, f"SEED->{node_set_name}", node_set_name)
        return self._seed

    def _add_op(self, inputs, sample_size: int, edge_set_name: str):
        es = self.schema.edge_sets[edge_set_name]
        for h in inputs:
            assert h.node_set == es.source, \
                (f"edge set {edge_set_name} samples {es.source}->"
                 f"{es.target}, got input over {h.node_set}")
        op_name = (f"({'|'.join(h.op_name for h in inputs)})"
                   f"->{es.target}" if len(inputs) > 1 else
                   f"{inputs[0].op_name}->{es.target}")
        self._ops.append(SamplingOp(
            op_name, tuple(h.op_name for h in inputs), edge_set_name,
            sample_size, self.strategy))
        return _OpHandle(self, op_name, es.target)

    def _build(self) -> SamplingSpec:
        return SamplingSpec(self._seed.node_set, self._seed.op_name,
                            tuple(self._ops))


# ---------------------------------------------------------------------------
# Graph store + in-memory sampler
# ---------------------------------------------------------------------------

class GraphStore:
    """Adjacency-list store of the full (unsampled) heterogeneous graph.

    edges: {edge_set: (src_ids, tgt_ids)} (numpy int64)
    node_features: {node_set: {feature: np.ndarray [n, ...]}}
    """

    def __init__(self, schema: GraphSchema,
                 edges: Mapping[str, tuple[np.ndarray, np.ndarray]],
                 node_features: Mapping[str, Mapping[str, np.ndarray]],
                 num_nodes: Mapping[str, int]):
        self.schema = schema
        self.edges = dict(edges)
        self.node_features = {k: dict(v) for k, v in node_features.items()}
        self.num_nodes = dict(num_nodes)
        # CSR-ish index per edge set for O(deg) neighbor queries, built
        # lazily on first `neighbors` touch: a wide heterogeneous store
        # only pays the argsort for the edge sets a spec actually
        # samples (opening OGBN-MAG to sample `cites` must not index
        # `affiliated_with`)
        self._index: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def _reindex(self, name: str) -> None:
        """(Re)build one edge set's CSR index from `self.edges[name]` —
        the hook mutating subclasses
        (repro_torch.serve.cache.VersionedGraphStore)
        call after editing an adjacency list."""
        src, tgt = self.edges[name]
        n_src = self.num_nodes[self.schema.edge_sets[name].source]
        order = np.argsort(src, kind="stable")
        sorted_src = src[order]
        starts = np.searchsorted(sorted_src, np.arange(n_src))
        ends = np.searchsorted(sorted_src, np.arange(n_src) + 1)
        self._index[name] = (starts, ends, tgt[order])

    def neighbors(self, edge_set: str, node: int) -> np.ndarray:
        idx = self._index.get(edge_set)
        if idx is None:
            self._reindex(edge_set)
            idx = self._index[edge_set]
        starts, ends, tgts = idx
        return tgts[starts[node]:ends[node]]

    def neighbors_batch(self, edge_set: str,
                        nodes: Sequence[int]) -> list[np.ndarray]:
        """Neighbor lists for `nodes`, in order.  The frontier-expansion
        hook: partitioned stores (repro_torch.storage.ShardedGraphStore)
        override this to batch cross-shard lookups into one request per
        peer instead of one round-trip per node."""
        return [self.neighbors(edge_set, int(u)) for u in nodes]

    def gather_node_features(self, node_set: str,
                             ids: np.ndarray) -> dict[str, np.ndarray]:
        """Feature rows for `ids` of one node set.  Overridable for the
        same reason as `neighbors_batch`; the default serves any store
        whose `node_features` arrays are locally indexable (in-memory or
        mmap)."""
        ids = np.asarray(ids, np.int64)
        return {k: np.asarray(np.asarray(v)[ids])
                for k, v in self.node_features.get(node_set, {}).items()}


def sample_subgraph(store: GraphStore, spec: SamplingSpec, seed: int,
                    rng: np.random.Generator) -> GraphTensor:
    """Algorithm 1 for a single root: repeated frontier expansion, then
    dedup, feature lookup and GraphTensor assembly."""
    # op_name -> sampled node ids (per op, for join() inputs)
    op_nodes: dict[str, np.ndarray] = {
        spec.seed_op_name: np.asarray([seed], np.int64)}
    # collected edges per edge set
    edges: dict[str, list[tuple[int, int]]] = {}

    for op in spec.sampling_ops:
        frontier = np.unique(np.concatenate([
            op_nodes[name] for name in op.input_op_names]))
        out_nodes = []
        es = store.schema.edge_sets[op.edge_set_name]
        for u, nbrs in zip(frontier,
                           store.neighbors_batch(op.edge_set_name, frontier)):
            if len(nbrs) == 0:
                continue
            if len(nbrs) > op.sample_size:
                if op.strategy == RANDOM_UNIFORM:
                    nbrs = rng.choice(nbrs, op.sample_size, replace=False)
                else:
                    nbrs = nbrs[:op.sample_size]
            out_nodes.append(nbrs)
            edges.setdefault(op.edge_set_name, []).extend(
                (int(u), int(v)) for v in nbrs)
        op_nodes[op.op_name] = (np.unique(np.concatenate(out_nodes))
                                if out_nodes else np.asarray([], np.int64))

    # ---- dedup nodes per node set ------------------------------------------
    nodes_per_set: dict[str, set] = {spec.seed_node_set: {seed}}
    for op in spec.sampling_ops:
        es = store.schema.edge_sets[op.edge_set_name]
        nodes_per_set.setdefault(es.source, set())
        nodes_per_set.setdefault(es.target, set())
        for (u, v) in edges.get(op.edge_set_name, []):
            nodes_per_set[es.source].add(u)
            nodes_per_set[es.target].add(v)

    # root first (RootNode* readout convention: root is node 0 of its set)
    id_maps: dict[str, dict[int, int]] = {}
    for ns_name, ids in nodes_per_set.items():
        ordered = sorted(ids)
        if ns_name == spec.seed_node_set:
            ordered = [seed] + [i for i in ordered if i != seed]
        id_maps[ns_name] = {gid: i for i, gid in enumerate(ordered)}

    # ---- assemble GraphTensor ----------------------------------------------
    node_sets = {}
    for ns_name, id_map in id_maps.items():
        gids = np.fromiter(id_map.keys(), np.int64, len(id_map))
        feats = store.gather_node_features(ns_name, gids)
        node_sets[ns_name] = NodeSet(
            np.asarray([len(gids)], np.int32), feats, len(gids))
    edge_sets = {}
    for es_name, pairs in edges.items():
        es = store.schema.edge_sets[es_name]
        uniq = sorted(set(pairs))
        src = np.asarray([id_maps[es.source][u] for u, _ in uniq], np.int32)
        tgt = np.asarray([id_maps[es.target][v] for _, v in uniq], np.int32)
        edge_sets[es_name] = EdgeSet(
            np.asarray([len(uniq)], np.int32),
            Adjacency(src, tgt, es.source, es.target), {}, max(len(uniq), 1)
            if len(uniq) else 1)
        if len(uniq) == 0:
            edge_sets[es_name] = EdgeSet(
                np.asarray([0], np.int32),
                Adjacency(np.zeros(1, np.int32), np.zeros(1, np.int32),
                          es.source, es.target), {}, 1)
    # ensure every schema edge set exists (possibly empty)
    for es_name, es in store.schema.edge_sets.items():
        if es_name not in edge_sets and es.source in id_maps \
                and es.target in id_maps:
            edge_sets[es_name] = EdgeSet(
                np.asarray([0], np.int32),
                Adjacency(np.zeros(1, np.int32), np.zeros(1, np.int32),
                          es.source, es.target), {}, 1)
    return GraphTensor(
        Context(np.asarray([1], np.int32), {}), node_sets, edge_sets)


def seed_rng(base_seed: int, root: int) -> np.random.Generator:
    """The repo-wide deterministic sampling convention: every rooted
    subgraph is drawn from its OWN generator keyed on (base_seed, root).

    This makes sampled output a pure function of the root — independent of
    which worker/shard draws it, in what order, or how many there are —
    which is what lets `distributed_sample` re-run a failed shard
    idempotently and lets the async sampler fleet
    (`repro_torch.sampling_service`) reproduce the in-process stream
    exactly."""
    return np.random.default_rng((base_seed, int(root)))


class InMemorySampler:
    """Medium-scale path (§6.1.2): samples on demand, nothing persisted.
    Per-root generators (see `seed_rng`): ``sample([a, b]) ==
    sample([b, a])`` element-wise, and equals what `distributed_sample`
    persists for the same roots and base seed."""

    def __init__(self, store: GraphStore, spec: SamplingSpec, *,
                 seed: int = 0,
                 rng_factory: Callable[[int], np.random.Generator]
                 | None = None):
        """`rng_factory(root) -> Generator` overrides the default
        `seed_rng(seed, root)` derivation — the injection point for
        callers that manage their own seed tree.  The factory must stay
        a pure function of the root or the per-root determinism contract
        above is lost."""
        self.store = store
        self.spec = spec
        self.seed = seed
        self._rng_factory = rng_factory or (
            lambda root: seed_rng(self.seed, root))

    def sample(self, roots: Sequence[int]) -> list[GraphTensor]:
        return [sample_subgraph(self.store, self.spec, int(r),
                                self._rng_factory(int(r)))
                for r in roots]


def shard_partition(seeds: Sequence[int], num_shards: int
                    ) -> list[np.ndarray]:
    """The sampler's shard striping (``seeds[s::num_shards]``) — the
    single owner of how `distributed_sample` partitions roots into shard
    files, so consumers that need the file-order root list (e.g. to feed
    the same roots to the sampling service) derive it from here instead
    of re-implementing the stride."""
    seeds = np.asarray(seeds)
    return [seeds[shard::num_shards] for shard in range(num_shards)]


def distributed_sample(store: GraphStore, spec: SamplingSpec,
                       seeds: Sequence[int], out_dir: str, *,
                       num_shards: int = 4, base_seed: int = 0,
                       writer: Callable | None = None) -> list[str]:
    """Large-scale path (§6.1.1): shard the seeds, run Algorithm 1 per
    shard, persist one file per shard (the fault-tolerance unit — a failed
    shard is simply re-run; output write is atomic via tmp+rename).

    Deterministic regardless of `num_shards`: each root draws from
    `seed_rng(base_seed, root)`, so the union of sampled subgraphs over
    all shards is a pure function of (seeds, base_seed) — only the
    grouping into files depends on the shard count."""
    from repro_torch.data.serialization import save_graphs
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for shard, shard_seeds in enumerate(shard_partition(seeds, num_shards)):
        graphs = [sample_subgraph(store, spec, int(s),
                                  seed_rng(base_seed, int(s)))
                  for s in shard_seeds]
        path = os.path.join(out_dir, f"samples-{shard:05d}-of-"
                                     f"{num_shards:05d}.npz")
        tmp = path + ".tmp"
        (writer or save_graphs)(graphs, tmp)
        os.replace(tmp, path)
        paths.append(path)
    return paths
