"""GraphTensor (de)serialization — the tf.train.Example analogue (a copy
of `repro.data.serialization`, held to the original by
tests/test_torch_host_parity.py).

Graphs are flattened to a dict of named numpy arrays and stored in .npz
shards (one file per sampler shard).  The flat naming scheme mirrors the
paper's feature naming ("nodes/<set>.<feature>", "edges/<set>.#source"...).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, NodeSet)


def graph_to_flat(g: GraphTensor, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a scalar OR stacked ([R, ...] super-batch) GraphTensor.

    ``#capacity`` is stored explicitly: it is static aux data that cannot
    be recovered from array shapes once a leading stack axis exists (and,
    for a padded node set without features, not even from a scalar graph's
    arrays).  Readers fall back to shape inference when the key is absent
    (files written before the key existed)."""
    flat = {f"{prefix}context.#sizes": np.asarray(g.context.sizes)}
    for k, v in g.context.features.items():
        flat[f"{prefix}context.{k}"] = np.asarray(v)
    for name, ns in g.node_sets.items():
        flat[f"{prefix}nodes/{name}.#sizes"] = np.asarray(ns.sizes)
        flat[f"{prefix}nodes/{name}.#capacity"] = np.asarray(ns.capacity)
        for k, v in ns.features.items():
            flat[f"{prefix}nodes/{name}.{k}"] = np.asarray(v)
    for name, es in g.edge_sets.items():
        flat[f"{prefix}edges/{name}.#sizes"] = np.asarray(es.sizes)
        flat[f"{prefix}edges/{name}.#capacity"] = np.asarray(es.capacity)
        flat[f"{prefix}edges/{name}.#source"] = np.asarray(es.adjacency.source)
        flat[f"{prefix}edges/{name}.#target"] = np.asarray(es.adjacency.target)
        flat[f"{prefix}edges/{name}.#meta"] = np.asarray(
            [es.adjacency.source_name, es.adjacency.target_name])
        for k, v in es.features.items():
            flat[f"{prefix}edges/{name}.{k}"] = np.asarray(v)
    return flat


def flat_to_graph(flat: dict[str, np.ndarray], prefix: str = ""
                  ) -> GraphTensor:
    ctx_feats, node_sets_raw, edge_sets_raw = {}, {}, {}
    ctx_sizes = None
    plen = len(prefix)
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        key = key[plen:]
        if key.startswith("context."):
            k = key[len("context."):]
            if k == "#sizes":
                ctx_sizes = v
            else:
                ctx_feats[k] = v
        elif key.startswith("nodes/"):
            name, k = key[len("nodes/"):].split(".", 1)
            node_sets_raw.setdefault(name, {})[k] = v
        elif key.startswith("edges/"):
            name, k = key[len("edges/"):].split(".", 1)
            edge_sets_raw.setdefault(name, {})[k] = v
    node_sets = {}
    for name, d in node_sets_raw.items():
        sizes = d.pop("#sizes")
        cap = d.pop("#capacity", None)
        if cap is None:  # legacy file: infer from (scalar) array shapes
            cap = (next(iter(d.values())).shape[0] if d
                   else int(np.asarray(sizes).sum()))
        node_sets[name] = NodeSet(sizes, d, int(cap))
    edge_sets = {}
    for name, d in edge_sets_raw.items():
        sizes = d.pop("#sizes")
        src = d.pop("#source")
        tgt = d.pop("#target")
        meta = d.pop("#meta")
        cap = d.pop("#capacity", None)
        edge_sets[name] = EdgeSet(
            sizes, Adjacency(src, tgt, str(meta[0]), str(meta[1])), d,
            int(cap if cap is not None else src.shape[0]))
    return GraphTensor(Context(ctx_sizes, ctx_feats), node_sets, edge_sets)


def save_graphs(graphs: Sequence[GraphTensor], path: str) -> None:
    flat = {}
    for i, g in enumerate(graphs):
        flat.update(graph_to_flat(g, prefix=f"g{i:06d}/"))
    flat["__num_graphs__"] = np.asarray(len(graphs))
    with open(path, "wb") as f:  # explicit handle: np.savez appends ".npz"
        np.savez_compressed(f, **flat)


def load_graphs(path: str) -> list[GraphTensor]:
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    n = int(flat.pop("__num_graphs__"))
    return [flat_to_graph(flat, prefix=f"g{i:06d}/") for i in range(n)]
