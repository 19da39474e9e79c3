"""Parameters cut over "data" at rest and gathered at use: the FSDP
(ZeRO-3) layout of the reference's default rule, ``"embed": "data"``
(`repro_torch.distributed.sharding`).

`MeshPlan.place_params_` cuts a model's leaves and records each cut on
the module that owns it (``fsdp_cut``: {parameter name: (dim, Axis)}).
Here is what a forward does with them:

* `gathered(*modules)` makes the cut leaves of the modules whole for a
  block: each is all-gathered (`collectives.gather_at_use`, whose
  backward reduce-scatters the whole gradient back to the slice as a
  sum) and put in the module's place of the parameter; at the block's
  exit the slices are put back and the whole tensors dropped.  A
  model gathers a layer at its entry and the embedding table, the head
  and the norms at their use, so no whole parameter lives past its
  layer.
* `gathering(fn)` is `gathered` around every call of a layer (what
  `nn.transformer.maybe_remat` wraps).  Under activation checkpointing
  the gather is inside the checkpointed function, so the backward's
  recomputation gathers again (`recomputed` marks the region); the
  "dots" policy recomputes every op but the 2-D products, the gather
  among them.
* Outside a checkpointed region, with autograd recording (remat
  ``"none"``, the embedding lookup, a head on one chunk), what autograd
  saves of a gathered tensor — the tensor, a view of it, or a cast or
  copy made from it alone — is kept as its slice and a recipe
  (`_Regather`): the backward gathers the slice again and replays the
  recipe when it reads the tensor.

The same scope keeps a sequence-parallel block's gathered residual as
its slice outside a checkpointed region (`saving_slices`, `keep_slice`:
remat ``"none"``, zamba2's shared block): the backward gathers the
sequence again, as Megatron's sequence parallelism does.  One scope
serves a block, its weights and its residual alike (autograd takes the
innermost saved-tensor hooks only).

A leaf may also be cut over "model" at rest while its layer computes
whole (`nn.layers.Linear` ``split_(..., at_rest=True)``: attention
where the axis divides its fused heads x head_dim width but not its
heads).  Such a layer gathers it over "model" at each use (`gather_cut`
with ``alike``: every model rank runs the same layer, so each keeps its
slice of the whole gradient), after `gathered` has made it whole over
"data": a leaf cut over both is gathered over "data" at the layer's
entry and over "model" at its use.  RWKV6's time mix cut by value
columns gathers its weights so too, without ``alike``: each rank
computes its value columns, so each holds a part of the whole
gradient and the gather's backward sums them.

Observers (`observers`) see every whole tensor gathered, forward and
backward: the dry run's memory tally files them as ``gathered`` bytes.
A residual regathered in the backward is shown to
`collectives.seq_observers` instead.
"""
from __future__ import annotations

import contextlib
import types

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed import collectives

# process-wide, as the sharding context: the backward's recomputation
# may run on autograd's device thread
_state = types.SimpleNamespace(recompute=0, scope=None)
observers: list = []   # callables given each whole tensor gathered


def cut_leaves(module: nn.Module) -> list:
    """[(owner module, name, dim, Axis)] of the leaves of `module` cut
    over "data" and held as slices now (a leaf made whole by an
    enclosing `gathered` is left out)."""
    out = []
    for mod in module.modules():
        for name, (dim, axis) in getattr(mod, "fsdp_cut", {}).items():
            if isinstance(mod._parameters.get(name), nn.Parameter):
                out.append((mod, name, dim, axis))
    return out


def is_cut(module: nn.Module) -> bool:
    return any(getattr(m, "fsdp_cut", None) for m in module.modules())


def _notify(t: torch.Tensor) -> None:
    for fn in observers:
        fn(t)


def gather_cut(part: torch.Tensor, axis, dim: int, *,
               alike: bool = False) -> torch.Tensor:
    """`part` gathered whole over `axis` on `dim`
    (`collectives.gather_at_use`, ``alike`` as there), shown to the
    observers."""
    w = collectives.gather_at_use(part, axis, dim, alike=alike)
    _notify(w)
    return w


@contextlib.contextmanager
def gathered(*modules):
    """The cut leaves of `modules` (None entries skipped) whole for the
    block, and their slices back at its exit."""
    leaves = [leaf for m in modules if m is not None
              for leaf in cut_leaves(m)]
    if not leaves:
        yield
        return
    parts = [mod._parameters[name] for mod, name, _, _ in leaves]
    with saving_slices() as scope:
        try:
            for (mod, name, dim, axis), part in zip(leaves, parts):
                w = gather_cut(part, axis, dim)
                if scope is not None:
                    scope.root(w, part, axis, dim)
                mod._parameters[name] = w
            yield
        finally:
            for (mod, name, _, _), part in zip(leaves, parts):
                mod._parameters[name] = part


@contextlib.contextmanager
def saving_slices():
    """The scope (`_Regather`) under which what autograd saves of a
    tensor rooted in it is kept as the slice it was gathered from: the
    enclosing block's where there is one, a new one where autograd
    records outside a checkpointed region, None otherwise (nothing is
    saved, or the region recomputes the gather)."""
    if _state.scope is not None:
        yield _state.scope
        return
    if not torch.is_grad_enabled() or _state.recompute:
        yield None
        return
    scope = _Regather()
    _state.scope = scope
    try:
        with scope:
            yield scope
    finally:
        _state.scope = None


def keep_slice(scope, whole: torch.Tensor, part: torch.Tensor, axis,
               dim: int) -> None:
    """Within `saving_slices`: `whole` (the sequence `part` was gathered
    into on `dim`) is saved as `part` and gathered again in the
    backward.  Nothing without a scope."""
    if scope is not None:
        scope.root(whole, part, axis, dim, collectives.seq_observers)


def gathering(fn, module: nn.Module | None = None):
    """`fn` with the cut leaves of `module` (`fn` itself by default)
    gathered around each call; `fn` as it is when there is no module or
    it holds no cut leaf."""
    module = fn if module is None else module
    if not isinstance(module, nn.Module) or not is_cut(module):
        return fn

    def run(*args, **kwargs):
        with gathered(module):
            return fn(*args, **kwargs)
    return run


def recomputed(fn):
    """`fn` marked as the body of a checkpointed region: a gather inside
    it saves nothing of its own (the region recomputes it)."""
    def run(*args, **kwargs):
        _state.recompute += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _state.recompute -= 1
    return run


# ---------------------------------------------------------------------------
# what autograd saves of a gathered tensor, kept as its slice
# ---------------------------------------------------------------------------

_SLOT = object()   # the place of the one tensor argument in a recipe


class _Packed:
    __slots__ = ("recipe", "size", "stride", "offset")

    def __init__(self, recipe, t: torch.Tensor):
        self.recipe = recipe
        self.size, self.stride = tuple(t.size()), tuple(t.stride())
        self.offset = t.storage_offset()


def _build(recipe) -> torch.Tensor:
    """A tensor over a storage laid out as the recipe's was: the slice
    gathered again, then each op of the recipe replayed."""
    if recipe[0] == "root":
        _, part, axis, dim, seen = recipe
        w = collectives.all_gather(part.detach(), axis, dim)
        for fn in seen:
            fn(w)
        return w
    _, parent, (size, stride, offset), func, args, kwargs = recipe
    src = _build(parent).as_strided(size, stride, offset)
    args, kwargs = tree_map(lambda a: src if a is _SLOT else a,
                            (args, kwargs))
    return func(*args, **kwargs)


def _unpack(x):
    if not isinstance(x, _Packed):
        return x
    with torch.no_grad():
        return _build(x.recipe).as_strided(x.size, x.stride, x.offset)


class _Regather(TorchDispatchMode):
    """Within a `gathered` block that autograd records outside any
    checkpointed region: the storage of each gathered tensor is a root,
    and the new storage an op makes from one rooted tensor alone (a
    cast, a copy; a view shares its input's) is rooted through that op.
    A tensor autograd saves on a rooted storage is packed as the recipe
    and its view of the storage, never as the tensor."""

    def __init__(self):
        super().__init__()
        self.recipes = WeakIdKeyDictionary()
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                               _unpack)

    def root(self, w: torch.Tensor, part, axis, dim,
             seen: list = observers) -> None:
        """`w` was gathered from `part` on `dim` over `axis`; `seen` are
        told of each regather."""
        self.recipes[w.untyped_storage()] = ("root", part, axis, dim, seen)

    def _pack(self, t: torch.Tensor):
        recipe = self.recipes.get(t.untyped_storage())
        return t if recipe is None else _Packed(recipe, t)

    def __enter__(self):
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.recipes or not isinstance(out, torch.Tensor) \
                or func._schema.is_mutable:
            return out
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if len(tensors) != 1:
            return out
        src = tensors[0]
        store = src.untyped_storage()
        parent = self.recipes.get(store)
        if parent is None or out.untyped_storage() is store:
            return out
        args_t, kwargs_t = tree_map(lambda a: _SLOT if a is src else a,
                                    (args, kwargs))
        self.recipes[out.untyped_storage()] = (
            "op", parent, (tuple(src.size()), tuple(src.stride()),
                           src.storage_offset()), func, args_t, kwargs_t)
        return out
