"""GraphTensor — the paper's §3.2 data structure (counterpart of
`repro.core.graph_tensor`).

The same fixed-capacity form as the reference: every node/edge set has a
static capacity (array length) and a `sizes` vector giving the valid item
count per graph component.  Host code (sampling, merge-and-pad) builds
GraphTensors whose leaves are numpy arrays; `to_device` turns them into
tensors on one device for the model.  `mask()` and `component_ids()`
work on either form.

Host code imports this module without torch: the sampler workers (the
fleet's forked and dial-in processes) are numpy-only, so torch is
imported only by the functions that make a tensor or name a device, and
a leaf is a tensor only if torch is already loaded.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Mapping, Optional, Sequence

import numpy as np

Array = Any  # np.ndarray on the host, torch.Tensor on a device


def _is_tensor(x) -> bool:
    """True for a torch.Tensor.  Nothing is a tensor before torch is
    imported, so a numpy-only process never imports it here."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _arange_lt_total(sizes, capacity: int):
    """[capacity] bool: position < sizes.sum() (valid-item mask)."""
    if _is_tensor(sizes):
        import torch
        return torch.arange(capacity, device=sizes.device) < sizes.sum()
    return np.arange(capacity) < np.asarray(sizes).sum()


def _component_ids(sizes, capacity: int):
    """[capacity] component index per item; padding slots past the last
    size map to len(sizes)."""
    if _is_tensor(sizes):
        import torch
        bounds = torch.cumsum(sizes, 0)
        pos = torch.arange(capacity, device=sizes.device, dtype=bounds.dtype)
        return torch.searchsorted(bounds, pos, right=True)
    bounds = np.cumsum(np.asarray(sizes))
    return np.searchsorted(bounds, np.arange(capacity),
                           side="right").astype(np.int32)


@dataclasses.dataclass
class Context:
    """Per-component features. sizes[c] == 1 for real components, 0 for
    padding components (doubles as the training-weight mask)."""

    sizes: Array                      # [C] (1 = real, 0 = padding)
    features: dict[str, Array]        # each [C, ...]

    @property
    def num_components(self) -> int:
        return self.sizes.shape[0]

    def __getitem__(self, name: str) -> Array:
        return self.features[name]

    def mask(self) -> Array:
        return self.sizes > 0


@dataclasses.dataclass
class NodeSet:
    sizes: Array                      # [C] valid nodes per component
    features: dict[str, Array]        # each [capacity, ...]
    capacity: int                     # static array length

    @property
    def total_size(self) -> Array:
        return self.sizes.sum()

    def __getitem__(self, name: str) -> Array:
        return self.features[name]

    def mask(self) -> Array:
        """[capacity] bool — True for valid (non-padding) nodes."""
        return _arange_lt_total(self.sizes, self.capacity)

    def component_ids(self) -> Array:
        """[capacity] component index per node."""
        return _component_ids(self.sizes, self.capacity)


@dataclasses.dataclass
class Adjacency:
    source: Array                     # [capacity] node indices
    target: Array                     # [capacity] node indices
    source_name: str
    target_name: str


@dataclasses.dataclass
class EdgeSet:
    sizes: Array                      # [C] valid edges per component
    adjacency: Adjacency
    features: dict[str, Array]
    capacity: int

    @property
    def total_size(self) -> Array:
        return self.sizes.sum()

    def __getitem__(self, name: str) -> Array:
        return self.features[name]

    def mask(self) -> Array:
        return _arange_lt_total(self.sizes, self.capacity)

    def component_ids(self) -> Array:
        return _component_ids(self.sizes, self.capacity)


@dataclasses.dataclass
class GraphTensor:
    """A scalar GraphTensor (shape []) holding one merged batch of graphs
    as components — the paper's canonical in-model representation."""

    context: Context
    node_sets: dict[str, NodeSet]
    edge_sets: dict[str, EdgeSet]

    @property
    def num_components(self) -> int:
        return self.context.num_components

    def replace_features(
            self,
            context: Optional[Mapping[str, Array]] = None,
            node_sets: Optional[Mapping[str, Mapping[str, Array]]] = None,
            edge_sets: Optional[Mapping[str, Mapping[str, Array]]] = None,
    ) -> "GraphTensor":
        """New GraphTensor with some feature dicts replaced (paper §3.2)."""
        new_ctx = self.context
        if context is not None:
            new_ctx = Context(self.context.sizes, dict(context))
        new_ns = dict(self.node_sets)
        for name, feats in (node_sets or {}).items():
            old = new_ns[name]
            new_ns[name] = NodeSet(old.sizes, dict(feats), old.capacity)
        new_es = dict(self.edge_sets)
        for name, feats in (edge_sets or {}).items():
            old = new_es[name]
            new_es[name] = EdgeSet(old.sizes, old.adjacency, dict(feats),
                                   old.capacity)
        return GraphTensor(new_ctx, new_ns, new_es)

    @classmethod
    def from_pieces(cls, context: Optional[Context] = None,
                    node_sets: Optional[Mapping[str, NodeSet]] = None,
                    edge_sets: Optional[Mapping[str, EdgeSet]] = None
                    ) -> "GraphTensor":
        """A GraphTensor from its pieces; without `context`, one
        component of weight 1 (int32 sizes, as the reference's
        ``jnp.ones((1,), jnp.int32)``; a tensor on the node or edge sets'
        device when their sizes are tensors, else numpy)."""
        node_sets = dict(node_sets or {})
        edge_sets = dict(edge_sets or {})
        if context is None:
            sizes = [p.sizes for p in (*node_sets.values(),
                                       *edge_sets.values())
                     if _is_tensor(p.sizes)]
            if sizes:
                import torch
                ones = torch.ones((1,), dtype=torch.int32,
                                  device=sizes[0].device)
            else:
                ones = np.ones((1,), np.int32)
            context = Context(ones, {})
        return cls(context, node_sets, edge_sets)


def resolve_device(device=None):
    """`device` as a torch.device, or the current CUDA device when None.
    Raises when None is given and no CUDA device exists: the port never
    moves to the CPU unless asked."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def leaf_dtype(np_dtype):
    """The tensor dtype a numpy leaf of `np_dtype` becomes on a device:
    float and bool leaves keep theirs, integer leaves become int64."""
    import torch
    dtype = torch.from_numpy(np.empty(0, np_dtype)).dtype
    if not (dtype.is_floating_point or dtype == torch.bool):
        dtype = torch.int64
    return dtype


def _leaf_to_device(x, device, non_blocking: bool = False):
    """numpy leaf -> tensor on `device`.  Integer leaves (ids, sizes,
    labels) become int64, torch's index type; the kernels take int32 ids
    and the call sites that launch them narrow their own index vectors.

    ``non_blocking`` with a CUDA `device`: the leaf is written into a
    pinned host buffer and copied without blocking the host, on the
    calling thread's current stream; the caller orders its consumers
    after that stream (`repro_torch.train.train_loop.device_prefetch`).
    PyTorch's pinned-buffer cache records the copy and hands the buffer
    out again only once the copy is done."""
    import torch
    arr = np.ascontiguousarray(np.asarray(x))
    if non_blocking and torch.device(device).type == "cuda":
        host = torch.empty(arr.shape, dtype=leaf_dtype(arr.dtype),
                           pin_memory=True)
        host.numpy()[...] = arr
        return host.to(device, non_blocking=True)
    # a read-only leaf (a batch decoded from the sampler fleet's frames)
    # is copied: torch does not wrap memory it may not write
    t = torch.from_numpy(arr) if arr.flags.writeable else torch.tensor(arr)
    if not (t.is_floating_point() or t.dtype == torch.bool):
        t = t.to(torch.int64)
    return t.to(device)


def to_device(graph: GraphTensor, device, *,
              non_blocking: bool = False) -> GraphTensor:
    """Copy a host (numpy) GraphTensor onto `device` as tensors
    (``non_blocking``: through pinned host buffers, see
    `_leaf_to_device`)."""
    def leaf(x):
        return _leaf_to_device(x, device, non_blocking)

    def conv(d):
        return {k: leaf(v) for k, v in d.items()}

    ctx = Context(leaf(graph.context.sizes), conv(graph.context.features))
    node_sets = {name: NodeSet(leaf(ns.sizes), conv(ns.features),
                               ns.capacity)
                 for name, ns in graph.node_sets.items()}
    edge_sets = {}
    for name, es in graph.edge_sets.items():
        adj = es.adjacency
        edge_sets[name] = EdgeSet(
            leaf(es.sizes),
            Adjacency(leaf(adj.source), leaf(adj.target),
                      adj.source_name, adj.target_name),
            conv(es.features), es.capacity)
    return GraphTensor(ctx, node_sets, edge_sets)


# ---------------------------------------------------------------------------
# Super-batch stacking (component groups on a leading axis)
# ---------------------------------------------------------------------------
#
# A *stacked* GraphTensor carries `R` structurally identical padded graphs
# ("component groups") on a leading axis: every leaf gains a [R, ...] leading
# dim while the names and capacities stay per-group.  It is a transport
# container; graph ops must not run on it directly — `unstack_graph`
# restores scalar GraphTensors first.

def _graph_structure(g: GraphTensor) -> tuple:
    """Hashable structural fingerprint (set names, capacities, feature
    keys, endpoint names) — the reference's stand-in for a treedef."""
    return (
        tuple(sorted(g.context.features)),
        tuple((name, ns.capacity, tuple(sorted(ns.features)))
              for name, ns in sorted(g.node_sets.items())),
        tuple((name, es.capacity, tuple(sorted(es.features)),
               es.adjacency.source_name, es.adjacency.target_name)
              for name, es in sorted(g.edge_sets.items())),
    )


def _map_graphs(fn, graphs: Sequence[GraphTensor]) -> GraphTensor:
    """Structural map over same-shaped GraphTensors, leaf by leaf — `fn`
    receives one leaf per input graph, in input order.  Set and feature
    names come out sorted, as the reference's pytree map orders them, so
    a stacked batch flattens (and goes on the wire) in the reference's
    order."""
    g0 = graphs[0]
    ctx = Context(fn(*[g.context.sizes for g in graphs]),
                  {k: fn(*[g.context.features[k] for g in graphs])
                   for k in sorted(g0.context.features)})
    node_sets = {}
    for name, ns0 in sorted(g0.node_sets.items()):
        sets = [g.node_sets[name] for g in graphs]
        node_sets[name] = NodeSet(
            fn(*[s.sizes for s in sets]),
            {k: fn(*[s.features[k] for s in sets])
             for k in sorted(ns0.features)},
            ns0.capacity)
    edge_sets = {}
    for name, es0 in sorted(g0.edge_sets.items()):
        sets = [g.edge_sets[name] for g in graphs]
        adj = Adjacency(fn(*[s.adjacency.source for s in sets]),
                        fn(*[s.adjacency.target for s in sets]),
                        es0.adjacency.source_name,
                        es0.adjacency.target_name)
        edge_sets[name] = EdgeSet(
            fn(*[s.sizes for s in sets]), adj,
            {k: fn(*[s.features[k] for s in sets])
             for k in sorted(es0.features)},
            es0.capacity)
    return GraphTensor(ctx, node_sets, edge_sets)


def graph_leaves(graph: GraphTensor) -> tuple:
    """(structure, leaves): the graph's structural fingerprint and its
    leaves in `_map_graphs`' order (set and feature names sorted), so two
    graphs of one structure list matching leaves at matching places."""
    leaves: list = []
    _map_graphs(leaves.append, [graph])
    return _graph_structure(graph), leaves


def stack_graphs(graphs: Sequence[GraphTensor]) -> GraphTensor:
    """Stack structurally identical padded GraphTensors on a new leading
    axis.  All inputs must share one structure (same set names,
    capacities, feature keys) — i.e. be padded to the same
    SizeConstraints."""
    if not graphs:
        raise ValueError("stack_graphs: empty sequence")
    structures = {_graph_structure(g) for g in graphs}
    if len(structures) != 1:
        raise ValueError(
            "stack_graphs: inputs are not structurally identical "
            f"(got {len(structures)} distinct treedefs; pad every group to "
            "the same SizeConstraints first)")

    def _stack(*leaves):
        if all(isinstance(x, np.ndarray) for x in leaves):
            return np.stack(leaves)
        import torch
        return torch.stack([torch.as_tensor(x) for x in leaves])

    return _map_graphs(_stack, graphs)


def stack_size(graph: GraphTensor) -> Optional[int]:
    """Number of stacked component groups, or None for a scalar
    GraphTensor.  Discriminates on context.sizes rank ([C] vs [R, C])."""
    ndim = getattr(graph.context.sizes, "ndim", 1)
    return int(graph.context.sizes.shape[0]) if ndim == 2 else None


def unstack_graph(graph: GraphTensor) -> list[GraphTensor]:
    """Invert :func:`stack_graphs`: split the leading group axis back into
    scalar GraphTensors (index, don't copy)."""
    n = graph.context.sizes.shape[0]
    return [_map_graphs(lambda x, i=i: x[i], [graph]) for i in range(n)]


HIDDEN_STATE = "hidden_state"
SOURCE = "source"
TARGET = "target"
CONTEXT = "context"
