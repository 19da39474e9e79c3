"""GraphSchema — the abstract definition of a heterogeneous graph (paper §3.1).

A schema declares node sets, edge sets (with source/target node-set names)
and context features; each feature has a dtype and a feature shape (the
dims after the leading item dim).  The schema never holds data.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    dtype: str                        # "int32" | "float32" | ...
    shape: tuple[int, ...] = ()       # per-item feature dims (may be ())

    def to_np_dtype(self):
        return np.dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class NodeSetSpec:
    features: Mapping[str, FeatureSpec] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EdgeSetSpec:
    source: str
    target: str
    features: Mapping[str, FeatureSpec] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class GraphSchema:
    node_sets: Mapping[str, NodeSetSpec]
    edge_sets: Mapping[str, EdgeSetSpec]
    context: Mapping[str, FeatureSpec] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        for name, es in self.edge_sets.items():
            if es.source not in self.node_sets:
                raise ValueError(
                    f"edge set {name!r}: unknown source {es.source!r}")
            if es.target not in self.node_sets:
                raise ValueError(
                    f"edge set {name!r}: unknown target {es.target!r}")

    # -- (de)serialization (the tf.Example/proto analogue is JSON here) -----

    def to_json(self) -> str:
        def fs(d):
            return {k: {"dtype": v.dtype, "shape": list(v.shape)}
                    for k, v in d.items()}

        return json.dumps({
            "node_sets": {k: {"features": fs(v.features)}
                          for k, v in self.node_sets.items()},
            "edge_sets": {k: {"source": v.source, "target": v.target,
                              "features": fs(v.features)}
                          for k, v in self.edge_sets.items()},
            "context": fs(self.context),
        }, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "GraphSchema":
        raw = json.loads(text)

        def fs(d):
            return {k: FeatureSpec(v["dtype"], tuple(v["shape"]))
                    for k, v in d.items()}

        return cls(
            node_sets={k: NodeSetSpec(fs(v.get("features", {})))
                       for k, v in raw["node_sets"].items()},
            edge_sets={k: EdgeSetSpec(v["source"], v["target"],
                                      fs(v.get("features", {})))
                       for k, v in raw["edge_sets"].items()},
            context=fs(raw.get("context", {})))


def mag_schema() -> GraphSchema:
    """The OGBN-MAG schema from the paper's case study (§8, Fig. 5)."""
    f32 = lambda *s: FeatureSpec("float32", tuple(s))
    i32 = lambda *s: FeatureSpec("int32", tuple(s))
    return GraphSchema(
        node_sets={
            "paper": NodeSetSpec({"feat": f32(128), "labels": i32(),
                                  "year": i32()}),
            "author": NodeSetSpec({"id": i32()}),
            "institution": NodeSetSpec({"id": i32()}),
            "field_of_study": NodeSetSpec({"id": i32()}),
        },
        edge_sets={
            "cites": EdgeSetSpec("paper", "paper"),
            "writes": EdgeSetSpec("author", "paper"),
            "written": EdgeSetSpec("paper", "author"),
            "affiliated_with": EdgeSetSpec("author", "institution"),
            "has_topic": EdgeSetSpec("paper", "field_of_study"),
        })
