"""Logical-axis rule tables (counterpart of
`repro.distributed.sharding`, `:35-93,146-172`).

One rule table maps model-declared logical axis names to mesh axes,
separately for parameters (FSDP-style: "embed" -> "data", which ZeRO-1
reuses for the optimizer state) and for activations ("batch" -> the data
axes, "feature" -> "model" for the trailing feature dim of a placed
super-batch).  A spec is a tuple with one entry per dim: a mesh axis
name, a tuple of them, or None (replicated) — the reference's
``PartitionSpec`` as a plain tuple.  The port has no GSPMD, so the
reference's activation constraints (`shard_activation`,
`constrain_tree`) have no counterpart: the mesh plan places and gathers
explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

# Default rule tables.  Values may be a mesh axis name, a tuple of mesh
# axes, or None (replicate).
DEFAULT_PARAM_RULES: dict[str, Any] = {
    "batch": None,
    "moe_group": None,
    "embed": "data",        # FSDP / ZeRO-3: gather at use
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "seq": None,
    "feature": "model",
}

DEFAULT_ACT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "moe_group": "data",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "seq": None,
    "layers": None,
    "feature": "model",
}


@dataclasses.dataclass
class ShardingContext:
    """`mesh` is anything with ``axis_names`` and ``shape`` ({axis:
    size}), as `repro_torch.distributed.partition.Mesh`."""

    mesh: Any
    param_rules: Mapping[str, Any]
    act_rules: Mapping[str, Any]

    def resolve(self, axes: Sequence[Any], rules: Mapping[str, Any],
                shape: Sequence[int] | None = None) -> tuple:
        """Greedy left-to-right resolution.

        When `shape` is given, mesh axes are only assigned to dims they
        divide evenly (a placed leaf is cut into equal chunks).  Each
        mesh axis is used at most once per spec.
        """
        mesh_axes = {a: self.mesh.shape[a] for a in self.mesh.axis_names}
        used: set[str] = set()
        out = []
        for i, ax in enumerate(axes):
            target = rules.get(ax) if ax is not None else None
            if target is None:
                out.append(None)
                continue
            cand = tuple(target) if isinstance(target, (tuple, list)) \
                else (target,)
            cand = tuple(t for t in cand if t in mesh_axes and t not in used)
            if not cand:
                out.append(None)
                continue
            if shape is not None:
                size = 1
                for t in cand:
                    size *= mesh_axes[t]
                if shape[i] % size != 0:
                    # try single-axis fallbacks before replicating
                    single = next((t for t in cand
                                   if shape[i] % mesh_axes[t] == 0), None)
                    if single is None:
                        out.append(None)
                        continue
                    cand = (single,)
            used.update(cand)
            out.append(cand if len(cand) > 1 else cand[0])
        return tuple(out)


def data_axis_names(mesh) -> tuple:
    """The mesh axes that carry data parallelism, in rule-table order:
    the act rule of the logical "batch" axis filtered to the axes the
    mesh has."""
    target = DEFAULT_ACT_RULES["batch"]
    cand = tuple(target) if isinstance(target, (tuple, list)) else (target,)
    return tuple(a for a in cand if a in mesh.axis_names)


def data_parallel_size(mesh) -> int:
    """Total number of data-parallel shards on `mesh`."""
    size = 1
    for a in data_axis_names(mesh):
        size *= mesh.shape[a]
    return size


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf is a PLAIN tuple of axis names (str|None).
    NamedTuples (containers like AdamWState) are NOT leaves."""
    return (type(x) is tuple
            and all(isinstance(e, (str, type(None))) for e in x))
