"""Logical-axis rule tables and the sharding context (counterpart of
`repro.distributed.sharding`).

One rule table maps model-declared logical axis names to mesh axes,
separately for parameters (FSDP-style: "embed" -> "data", which ZeRO-1
reuses for the optimizer state) and for activations ("batch" -> the data
axes, "feature" -> "model" for the trailing feature dim of a placed
super-batch).  A spec is a tuple with one entry per dim: a mesh axis
name, a tuple of them, or None (replicated) — the reference's
``PartitionSpec`` as a plain tuple.

`use_sharding` makes a mesh and its rules current for the block, as the
reference's does, but for the whole process rather than the calling
thread: on the card, autograd runs the backward (and the recomputation
of a checkpointed layer in it) on its own device thread, which must see
the mesh the forward saw.  `logical_to_spec` and `param_shardings` resolve under
it (a spec per leaf, which the LM mesh step slices parameters and
optimizer state by), and `mesh_axis` gives a layer the rank's `Axis` of
a mesh axis (the MoE layer's data axis).  A rank here holds its local
shapes, so the reference's constraints on global arrays,
`shard_activation` and `constrain_tree`, are the identity: they are
called at the reference's sites so that a reader finds them, and the
explicit collectives of the layers and the step do what GSPMD derives
from them.  Where the act rule of "seq" names a mesh axis (a cell's
``"seq": "model"`` override), `seq_axis` gives the models that axis for
a sequence it divides: they then hold the residual stream as the rank's
slice of the sequence and cut their KV caches by sequence (sequence
parallelism, `repro_torch.nn.transformer`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Mapping, Sequence

_state = types.SimpleNamespace(ctx=None)  # process-wide (module docstring)

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


def tree_map(fn, tree, *rest):
    """Map over dicts and (Named)tuples; a plain tuple of axis names (an
    axes leaf) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)) and not is_axes_leaf(tree):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def current_context() -> ShardingContext | None:
    return _state.ctx


@contextlib.contextmanager
def use_sharding(mesh, param_rules: Mapping[str, Any] | None = None,
                 act_rules: Mapping[str, Any] | None = None):
    """Make `mesh` and the rule tables (the defaults updated by the
    given ones) current for the process within the block."""
    prev = current_context()
    _state.ctx = ShardingContext(
        mesh,
        dict(DEFAULT_PARAM_RULES, **(param_rules or {})),
        dict(DEFAULT_ACT_RULES, **(act_rules or {})))
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def logical_to_spec(axes: Sequence[Any], *, kind: str = "param") -> tuple:
    """The spec of `axes` under the current context; () without one."""
    ctx = current_context()
    if ctx is None:
        return ()
    rules = ctx.param_rules if kind == "param" else ctx.act_rules
    return ctx.resolve(axes, rules)


def shard_activation(x, names: Sequence[Any]):
    """The identity: a rank's activation is its own shard already (the
    reference constrains a global array here)."""
    del names
    return x


def constrain_tree(tree, axes_tree, *, kind: str = "param"):
    """The identity, as `shard_activation` (the reference constrains a
    tree of global intermediates here)."""
    del axes_tree, kind
    return tree


def param_shardings(axes_tree, *, kind: str = "param", specs_tree=None):
    """A spec per leaf of a logical-axes tree under the current context.
    With `specs_tree` (a matching tree of tensors or anything with a
    ``shape``) a mesh axis goes only to a dim it divides evenly, as at
    the reference's argument boundary.  Raises RuntimeError without a
    context."""
    ctx = current_context()
    if ctx is None:
        raise RuntimeError(
            "param_shardings requires an active use_sharding()")
    rules = ctx.param_rules if kind == "param" else ctx.act_rules
    if specs_tree is None:
        return tree_map(lambda a: ctx.resolve(a, rules), axes_tree)
    return tree_map(lambda a, s: ctx.resolve(a, rules,
                                             shape=tuple(s.shape)),
                    axes_tree, specs_tree)


def batch_axis():
    """This rank's `Axis` over the data-parallel ranks under the current
    context (the mesh's pod x data line, or its "data" axis), or None
    where that is one rank or there is no such mesh."""
    ctx = current_context()
    axis = getattr(ctx.mesh, "batch", None) if ctx is not None else None
    if axis is None:
        return mesh_axis("data")
    return axis if axis.size > 1 else None


def seq_axis(length: int):
    """This rank's `Axis` of the mesh axis the act rule of "seq" names,
    for a sequence of `length` positions: None without a context, where
    the rule names no axis of the mesh (or a line of several), where that
    axis has one rank, or where it does not divide `length` (the
    sequence stays whole, as the reference's resolver leaves a dim the
    axis does not divide)."""
    ctx = current_context()
    if ctx is None:
        return None
    (name,) = ctx.resolve(("seq",), ctx.act_rules, shape=(length,))
    if name is None or isinstance(name, tuple):
        return None
    return mesh_axis(name)


def mesh_axis(name: str):
    """This rank's `Axis` of mesh axis `name` under the current context,
    or None: no context, a mesh without rank axes, or an axis of one
    rank (nothing to split over)."""
    ctx = current_context()
    axes = getattr(ctx.mesh, "axes", None) if ctx is not None else None
    axis = (axes or {}).get(name)
    return axis if axis is not None and axis.size > 1 else None
