"""Core trainable layers (counterpart of `repro.nn.layers` and the
parameter handling of `repro.nn.module`): Linear, RMSNorm, LayerNorm,
Embedding, MLP, Dropout, the parameter draw and the carry of reference
parameter trees.

Layouts follow the reference so weights carry across as plain copies:
`Linear.w` is ``[in, out]`` and `Linear.b` is ``[out]``.  Every module's
parameter names, joined with dots, are the key paths of the reference's
``split_params(module.init(key))[0]`` tree, which is what
`load_jax_params` relies on.

Each module that owns parameters declares their logical axes as the
reference's `Param`s do (`logical_axes`, the same names at the same
places), and `param_axes(model)` gathers them by parameter name.
`Linear`, `Embedding` and `MLP` also split over the "model" axis of a
mesh (`split_`): a column split cuts a weight's outputs, a row split its
inputs and sums the partial products over the axis
(`repro_torch.distributed.collectives.copy_to` / `reduce_from` are the
region's boundaries).  A `Linear` may instead be cut at rest only
(``split_(kind, axis, at_rest=True)``): it holds its slice between
calls, as the reference's resolver places the leaf, and gathers the
whole weight at each call (`fsdp.gather_cut`), so the layer computes
whole on every rank of the axis.
"""
from __future__ import annotations

import math
import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import fsdp
from repro_torch.distributed.collectives import (Axis, copy_to, reduce_from,
                                                 sum_over)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Draw `w` in place lecun-normal, truncated at two standard
    deviations, with the fan-in its second-to-last dimension (the
    reference's default initializer, `repro/nn/module.py`
    `variance_scaling`)."""
    std = math.sqrt(1.0 / max(1, w.shape[-2])) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def rank_slice(p: nn.Parameter, dim: int, axis: Axis) -> nn.Parameter:
    """This rank's equal slice of `p` on `dim`, as a new parameter."""
    width = p.shape[dim] // axis.size
    with torch.no_grad():
        part = p.narrow(dim, axis.index * width, width).clone()
    return nn.Parameter(part, requires_grad=p.requires_grad)


def splits(n: int, axis: Axis | None) -> bool:
    """Whether `n` things split evenly over a model axis of more than one
    rank."""
    return axis is not None and axis.size > 1 and n % axis.size == 0


class Linear(nn.Module):
    """Dense layer: y = x @ w (+ b), with w stored [in, out].

    After ``split_("column", axis)`` the layer holds this rank's columns
    (and bias entries) and gives this rank's outputs; after
    ``split_("row", axis)`` it holds its rows, reads this rank's inputs
    and sums the products over the axis before the (whole) bias.  With
    ``at_rest=True`` it holds the same slices but gathers them whole at
    each call and computes as a whole layer (``rest_cut``)."""

    def __init__(self, in_dim: int, out_dim: int, *, use_bias: bool = True,
                 kernel_axes: tuple = (None, None)):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.kernel_axes = tuple(kernel_axes)
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        self.split: str | None = None
        self.axis: Axis | None = None
        self.rest_cut: tuple | None = None   # (kind, Axis) when cut at rest

    def logical_axes(self) -> dict:
        return {"w": self.kernel_axes, "b": self.kernel_axes[-1:]}

    def split_(self, kind: str, axis: Axis, *, at_rest: bool = False
               ) -> None:
        """Keep this rank's slice: "column" cuts the outputs, "row" the
        inputs (both must divide by the axis size).  ``at_rest``: only
        the storage is cut; each call gathers the whole weight."""
        if kind == "column":
            self.w = rank_slice(self.w, 1, axis)
            if self.b is not None:
                self.b = rank_slice(self.b, 0, axis)
        elif kind == "row":
            self.w = rank_slice(self.w, 0, axis)
        else:
            raise ValueError(f"unknown split {kind!r}")
        if at_rest:
            self.rest_cut = (kind, axis)
        else:
            self.split, self.axis = kind, axis

    def whole(self, alike: bool = True) -> tuple:
        """(w, b) whole: gathered over the axis where the layer is cut at
        rest (``alike``: every rank of the axis computes this layer alike
        and keeps its slice of the gradient; False inside a
        sequence-parallel region, where each rank's gradient is its part
        of a sum and the slices take the reduce-scatter of it)."""
        if self.rest_cut is None:
            return self.w, self.b
        kind, axis = self.rest_cut
        column = kind == "column"
        w = fsdp.gather_cut(self.w, axis, 1 if column else 0, alike=alike)
        b = self.b
        if column and b is not None:
            b = fsdp.gather_cut(b, axis, 0, alike=alike)
        return w, b

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Lecun-normal (`lecun_normal_`); zero bias."""
        lecun_normal_(self.w, generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """With ``reduce=False`` a row split gives this rank's part of
        the sum over the axis, its bias on the axis' first rank alone (a
        sequence-parallel block reduce-scatters the parts itself), and a
        layer cut at rest gathers its weights for such a region
        (`whole`)."""
        w, b = self.whole(alike=reduce)
        y = torch.matmul(x, w.to(x.dtype))
        if self.split == "row":
            if reduce:
                y = reduce_from(y, self.axis)
            elif self.axis.index:
                return y
        if b is not None:
            y = y + b.to(x.dtype)
        return y


class RMSNorm(nn.Module):
    """RMSNorm computed in fp32 (float64 under a float64 input) and cast
    back, eps 1e-6, a `scale` parameter (`repro/nn/layers.py:45-63`)."""

    def __init__(self, dim: int, *, eps: float = 1e-6, axis_name=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(dim))

    def logical_axes(self) -> dict:
        return {"scale": (self.axis_name,)}

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        acc = torch.promote_types(dtype, torch.float32)
        x32 = x.to(acc)
        var = torch.square(x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(acc)).to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back, eps 1e-5 (as the
    reference writes it out; no fused library call).  A float64 input
    is computed in float64, where the reference stays in fp32: only
    float64 callers (the CPU tests' exact checks) see a difference;
    fp32, bf16 and fp16 inputs compute in fp32 as before.

    After `split_` the normalized dim is cut over a model axis (a layer
    split by heads hands each rank its heads' channels; one cut by value
    columns, ``groups`` of them, its slice of each head's): the row's
    mean and centered variance sum over the axis (`sum_over`), and the
    scale and bias stay whole, read at this rank's channels."""

    def __init__(self, dim: int, *, eps: float = 1e-5, use_bias: bool = True,
                 axis_name=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.axis: Axis | None = None
        self.groups = 1

    def split_(self, axis: Axis, groups: int = 1) -> None:
        """Take this rank's equal slice of each of `groups` equal groups
        of the normalized dim as input (module docstring); the
        parameters stay whole."""
        self.axis, self.groups = axis, groups

    def _mine(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's channels of a whole affine parameter."""
        width = self.dim // self.groups // self.axis.size
        return p.reshape(self.groups, -1).narrow(
            1, self.axis.index * width, width).reshape(-1)

    def logical_axes(self) -> dict:
        return {"scale": (self.axis_name,), "bias": (self.axis_name,)}

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        acc = torch.promote_types(dtype, torch.float32)
        x32 = x.to(acc)
        scale, bias = self.scale, self.bias
        if self.axis is None:
            mean = x32.mean(dim=-1, keepdim=True)
            var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
        else:
            axis = self.axis
            mean = sum_over(x32.sum(dim=-1, keepdim=True), axis) / self.dim
            var = sum_over(torch.square(x32 - mean).sum(dim=-1, keepdim=True),
                           axis) / self.dim
            scale = self._mine(scale)
            if bias is not None:
                bias = self._mine(bias)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * scale.to(acc)
        if bias is not None:
            y = y + bias.to(acc)
        return y.to(dtype)


class Embedding(nn.Module):
    """Id embedding.  Like the reference, the lookup returns bfloat16
    unless the caller asks for another dtype.

    After `split_` the table holds this rank's rows of the vocabulary
    (``vocab_start`` on): a lookup takes the ids in its range, zeros the
    rest and sums over the axis, and `attend` gives this rank's logits
    (`vocab_shard` says which)."""

    def __init__(self, vocab_size: int, dim: int, *,
                 axes: tuple = ("vocab", "embed")):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.axes = tuple(axes)
        self.table = nn.Parameter(torch.zeros(vocab_size, dim))
        self.axis: Axis | None = None
        self.vocab_start = 0

    def logical_axes(self) -> dict:
        return {"table": self.axes}

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.table.normal_(0.0, 0.02, generator=generator)

    def split_(self, axis: Axis) -> bool:
        """Keep this rank's rows when the vocabulary splits evenly over
        the axis; False (the table stays whole) otherwise."""
        if not splits(self.vocab_size, axis):
            return False
        self.table = rank_slice(self.table, 0, axis)
        self.axis = axis
        self.vocab_start = axis.index * self.table.shape[0]
        return True

    def vocab_shard(self) -> tuple | None:
        """(axis, first id) of this rank's rows, or None when whole."""
        return None if self.axis is None else (self.axis, self.vocab_start)

    def forward(self, ids: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16,
                reduce: bool = True) -> torch.Tensor:
        """The rows of `ids`; when split, the sum over the axis of each
        rank's (with ``reduce=False``, this rank's part of it)."""
        if self.axis is None:
            return self.table.to(dtype)[ids]
        rows = self.table.shape[0]
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < rows)
        out = self.table.to(dtype)[local.clamp(0, rows - 1)]
        out = torch.where(inside[..., None], out,
                          torch.zeros((), dtype=dtype, device=out.device))
        return reduce_from(out, self.axis) if reduce else out

    def attend(self, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """Logits against the table (the tied softmax head), in x's
        dtype: this rank's vocabulary slice when split.  With
        ``reduce=False`` (inside a sequence-parallel region) a split
        table reads `x` as it is: the gather's backward sums its
        gradient over the axis."""
        if reduce:
            x = copy_to(x, self.axis)
        return torch.matmul(x, self.table.to(x.dtype).T)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the erf form, so the approximation is named explicitly
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": _gelu_tanh,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


class MLP(nn.Module):
    """Transformer FFN, gated (SwiGLU family: ``act(x @ wg) * (x @ wi)``)
    or plain (``act(x @ wi)``), then ``wo`` (`repro/nn/layers.py:
    129-161`)."""

    def __init__(self, dim: int, hidden: int, *, activation: str = "silu",
                 gated: bool = True, use_bias: bool = False):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.gated = gated
        self.hidden = hidden
        self.wi = Linear(dim, hidden, use_bias=use_bias,
                         kernel_axes=("embed", "mlp"))
        self.wg = (Linear(dim, hidden, use_bias=use_bias,
                          kernel_axes=("embed", "mlp")) if gated else None)
        self.wo = Linear(hidden, dim, use_bias=use_bias,
                         kernel_axes=("mlp", "embed"))
        self.axis: Axis | None = None

    def split_(self, axis: Axis) -> bool:
        """Split the hidden width over the axis (wi, wg by columns, wo
        by rows) when it divides evenly; False (whole) otherwise."""
        if not splits(self.hidden, axis):
            return False
        for lin in (self.wi, self.wg):
            if lin is not None:
                lin.split_("column", axis)
        self.wo.split_("row", axis)
        self.axis = axis
        return True

    def forward(self, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """With ``reduce=False`` (inside a sequence-parallel region) a
        split MLP reads `x` as it is and gives this rank's part of the
        sum over the axis (`Linear.forward`)."""
        if reduce:
            x = copy_to(x, self.axis)
        h = self.wi(x)
        h = self.act(self.wg(x)) * h if self.gated else self.act(h)
        return self.wo(h, reduce)


class Dropout:
    """Functional dropout: the caller passes a `torch.Generator`, or None
    to turn it off (`repro/nn/layers.py:164-175`).  The generator's bits
    are not `jax.random`'s, so only the rule is the reference's: keep
    with probability ``1 - rate`` and scale the kept by its inverse."""

    def __init__(self, rate: float):
        self.rate = rate

    def __call__(self, x: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of `module` from one seeded generator, layer
    by layer in registration order (a pure function of the seed).  Each
    of the port's modules that owns parameters of its own (`Linear`,
    `LayerNorm`, `RMSNorm`, `Embedding`, `GATv2Conv`) draws them in its
    ``reset_parameters(generator)``.  The generator lives on the device
    the parameters lie on, so a module built on the card (the LM at full
    width) is drawn there, never on the host."""
    first = next(module.parameters(), None)
    device = first.device if first is not None else torch.device("cpu")
    generator = torch.Generator(device=device).manual_seed(int(seed))
    for sub in module.modules():
        if (type(sub).__module__.startswith("repro_torch.")
                and hasattr(sub, "reset_parameters")):
            sub.reset_parameters(generator)
    return module


def param_axes(model: nn.Module) -> dict[str, tuple]:
    """{parameter name: logical axes} of every parameter of `model`, as
    its modules declare them (`logical_axes`).  The per-layer leaves of a
    layer ModuleList carry no "layers" axis (the reference's stacked
    leaves lead with it).  Raises ValueError for a module that owns a
    parameter and declares no axes for it."""
    out = {}
    for prefix, mod in model.named_modules():
        own = [n for n, _ in mod.named_parameters(recurse=False)]
        if not own:
            continue
        declared = (mod.logical_axes() if hasattr(mod, "logical_axes")
                    else {})
        for name in own:
            if name not in declared:
                raise ValueError(f"{type(mod).__name__} declares no "
                                 f"logical axes for {name!r}")
            out[f"{prefix}.{name}" if prefix else name] = \
                tuple(declared[name])
    return out


def _flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """{dotted key path: leaf} for nested dicts/lists of arrays; list
    items are keyed by index, as nn.ModuleList names its children."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for key, sub in items:
        out.update(_flatten_tree(sub, f"{prefix}.{key}" if prefix
                                 else str(key)))
    return out


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a reference parameter tree (the numpy leaves of
    ``split_params(...)[0]``) into `module`, in place.

    Raises ValueError when the key paths or shapes differ: a partial load
    would leave randomly drawn weights behind and break parity quietly."""
    leaves = _flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    unexpected = sorted(set(leaves) - set(params))
    if missing or unexpected:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            value = torch.from_numpy(np.array(leaves[name], np.float32))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(value.to(p.dtype))
    return module


def unstack_blocks(tree: Mapping, n_blocks: int,
                   key: str = "blocks") -> dict:
    """The reference's tree with its stack under `key` (every leaf
    ``[L, ...]``, `repro/nn/module.py` `init_stacked`) split into a list
    of `n_blocks` per-layer trees, the key paths of an `nn.ModuleList`
    (``{key}.{i}.…``).  Raises ValueError when a stacked leaf's leading
    dimension is not `n_blocks`."""
    out = dict(tree)
    if key not in tree:
        return out
    leaves = _flatten_tree(tree[key])
    wrong = {k: v.shape for k, v in leaves.items()
             if v.ndim == 0 or v.shape[0] != n_blocks}
    if wrong:
        raise ValueError(f"stacked {key} leaves must lead with "
                         f"{n_blocks} layers: {wrong}")
    out[key] = [{k: v[i] for k, v in leaves.items()}
                for i in range(n_blocks)]
    return out


# the reference's stacked layer trees and the port's ModuleLists of the
# same names: DecoderLM and RWKV6LM `blocks`, Zamba2LM `mamba`,
# WhisperModel `encoder` and `decoder`
LAYER_STACKS = ("blocks", "mamba", "encoder", "decoder")


def load_jax_lm_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """`load_jax_params` for an LM whose layers are `nn.ModuleList`s named
    as the reference's stacked trees (`LAYER_STACKS`): each stack is
    split per layer first.  Everything else carries as it is: Zamba2's
    one ``shared`` block (loaded once, as the reference holds it) and the
    MoE expert stacks ``[E, ...]`` (one parameter each).  It refuses a
    missing or unexpected key or a wrong shape, as `load_jax_params`
    does."""
    for key in LAYER_STACKS:
        stack = getattr(model, key, None)
        if isinstance(stack, nn.ModuleList):
            tree = unstack_blocks(tree, len(stack), key)
    return load_jax_params(model, tree)


_LAYER_NAME = re.compile(r"^(%s)\.(\d+)\.(.+)$" % "|".join(LAYER_STACKS))


def stack_groups(names) -> dict:
    """{stacked name: [port names in layer order]}: the parameters of a
    layer ModuleList (``blocks.3.attn.wq.w``, `LAYER_STACKS`) gather
    under the reference's stacked name (``blocks.attn.wq.w``); any other
    name maps to itself, a string rather than a list."""
    groups: dict = {}
    for name in names:
        m = _LAYER_NAME.match(name)
        if m is None:
            groups[name] = name
            continue
        groups.setdefault(f"{m[1]}.{m[3]}", []).append((int(m[2]), name))
    out = {}
    for key, members in groups.items():
        if isinstance(members, str):
            out[key] = members
            continue
        members.sort()
        if [i for i, _ in members] != list(range(len(members))):
            raise ValueError(f"{key}: layers {[i for i, _ in members]} "
                             "are not 0..L-1")
        out[key] = [n for _, n in members]
    return out


def stack_lm_tree(values: Mapping) -> dict:
    """The inverse of `load_jax_lm_params`: `values` ({parameter name:
    tensor}: an LM's named parameters, or their gradients) as the
    reference's nested tree of fp32 numpy arrays, each layer stack of
    `LAYER_STACKS` restacked ``[L, ...]`` under its stacked name."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    tree: dict = {}
    for key, names in stack_groups(values).items():
        leaf = (host(values[names]) if isinstance(names, str)
                else np.stack([host(values[n]) for n in names]))
        node = tree
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree
