"""The dry run: every (arch x shape x mesh) cell of the port traced on
rank 0 of a fake world of 256 or 512 ranks, its memory a rank judged
against one H100 (counterpart of `repro.launch.dryrun`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 6]

No card is needed: everything runs on the CPU.  ``--jobs`` traces that
many cells at a time, each in a spawned process with its own fake world.

The reference lowers and compiles each cell for 512 forced CPU devices
and reads the compiler's memory analysis and the HLO's collectives.  The
port has no compiler to ask, so it runs its own step instead, on the
CPU and without allocating:

* the process joins a ``"fake"`` `torch.distributed` world (the fake
  store of `torch.testing._internal.distributed.fake_pg`, imported when
  the world is made) as rank 0: every group forms and every collective
  returns at once;
* the cell (`repro_torch.launch.specs.make_cell`) is built on the meta
  device, its model split by the production plan, and one train step,
  prefill or decode step runs on meta tensors: shapes, dtypes and
  storages without data.  (`FakeTensorMode` would wrap the same meta
  kernels in a Python dispatch of its own, several times slower on a
  32k-token prefill's chunk loop);
* `MemoryTally` counts the bytes of every storage the ops create and
  frees them as they die: the peak a rank, split into parameters,
  gradients, optimizer state, cache and the rest, for the setup (the
  model built whole, split, the state made) and the step apart;
* `CommTally` counts every `torch.distributed` call and its result
  bytes, per op (as the reference counts HLO result shapes) and per mesh
  axis; the products' FLOPs are counted by `FlopCounterMode`'s table;
* `PartTracker` files each storage by the layer part that allocated it,
  so the peak's "rest" (what no other category holds) is broken down in
  ``rest_by_part`` (`REST_PARTS`, each by phase: forward, recompute,
  backward).

``hbm_fit`` is the step's peak against `HBM_PER_CARD`.  Each row says
which layout the port ran (``layout``): FSDP (every cell's parameters
cut over "data" at rest and gathered a layer at use, as the reference's
``"embed": "data"`` rule places them; the "embed" leaves the data ranks
do not divide stay whole), the parameters that stayed whole over
"model" (a layer whose heads the axis does not divide and that is not
cut otherwise), those held partly alike on every model rank (Mamba2's
fused projection and conv: B and C), how the KV cache and the SSM states
are cut (by heads, rwkv6-3b's wkv state at 16 by value columns, or by
sequence under the
cell's ``"seq": "model"`` override, which `make_cell` applies to both
rule tables of the cell's plan), the sequence cut applied
(``seq_cut``: the residual stream and the caches), and what of the
overrides stays unapplied.  The whole parameters a layer gathers are
counted in their own category, ``gathered``; the gathers and
reduce-scatters of the sequence cut are "model" calls in the tally.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import re
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed import collectives, fsdp
from repro_torch.launch.specs import (DEC_FRACTION, HBM_PER_CARD, cell_inputs,
                                     make_cell)

COLLECTIVE_OPS = ("all_reduce", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "broadcast", "barrier")
DEFAULT_OUT = "results/dryrun_torch.json"


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``"fake"`` world of `world` ranks for
    the block; the process group is destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

class MemoryTally(TorchDispatchMode):
    """The bytes of live storages made by the ops run under it, and the
    FLOPs of its products while ``flops`` is not None.

    Each new storage an op returns is counted at its size, once (views
    and in-place results share a counted one), and a weak reference
    takes it off when it dies.  Meta storages count as any other (the
    dry run runs on them).  The peak
    moves only on an allocation; the log of allocations and frees is
    kept, so the set live at the peak is replayed once at the end
    (`live_at_peak`), never swept on the way.

    FLOPs are counted by `torch.utils.flop_counter`'s own table of
    products.  `FlopCounterMode` itself is not used: its module tracker's
    backward hooks keep every checkpointed layer's recomputed activations
    alive to the end of the backward, so the peak under it grows with the
    depth where the step's does not."""

    def __init__(self):
        super().__init__()
        self._shapes = MetaShapeCache()
        self.flops = None
        self.live = 0
        self.peak = 0
        self._seq = itertools.count()
        self._ids = WeakIdKeyDictionary()
        self._log: list = []
        self._peak_at = 0
        self._closed = False
        self.parts: PartTracker | None = None
        self._labels: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._shapes.run(func, args, kwargs)
        if self.flops is not None:
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def __exit__(self, *exc):
        self._closed = True
        return super().__exit__(*exc)

    def track(self, t: torch.Tensor) -> None:
        """Count `t`'s storage if it is not counted yet."""
        s = t.untyped_storage()
        if s in self._ids:
            return
        seq = next(self._seq)
        nbytes = s.nbytes()
        self._ids[s] = seq
        if self.parts is not None:
            self._labels[seq] = self.parts.label()
        self.live += nbytes
        self._log.append((seq, nbytes))
        if self.live > self.peak:
            self.peak, self._peak_at = self.live, len(self._log)
        done = weakref.finalize(s, self._free, seq, nbytes)
        done.atexit = False

    def _free(self, seq: int, nbytes: int) -> None:
        if not self._closed:
            self.live -= nbytes
            self._log.append((seq, -nbytes))

    def reset_peak(self) -> None:
        """Start a new window: the peak is what is live now."""
        self.peak, self._peak_at = self.live, len(self._log)

    def seq_of(self, t: torch.Tensor):
        return self._ids.get(t.untyped_storage())

    def live_at_peak(self) -> dict:
        """{storage number: bytes} live at the current window's peak."""
        live: dict = {}
        for seq, nbytes in self._log[:self._peak_at]:
            if nbytes >= 0:
                live[seq] = nbytes
            else:
                live.pop(seq, None)
        return live

    def breakdown(self, categories: dict) -> dict:
        """The window's peak split by `categories` ({name: tensors, or
        the storage numbers of tensors gone since}; a storage goes to the
        first name that holds it), the remainder as "rest"."""
        live = self.live_at_peak()
        out, seen = {}, set()
        for name, tensors in categories.items():
            total = 0
            for t in tensors:
                seq = t if isinstance(t, int) else self.seq_of(t)
                if seq in live and seq not in seen:
                    seen.add(seq)
                    total += live[seq]
            out[name] = total
        out["rest"] = sum(live.values()) - sum(out.values())
        out["total"] = sum(live.values())
        if self.parts is not None:
            self.rest_by_part = self.parts.rest_by_part(
                {k: v for k, v in live.items() if k not in seen},
                self._labels)
        return out


# the layer parts of a step's "rest": the carries a layer saves (each
# block's output, the embedding's: the next block's input), the sequence
# mixers (attention; RWKV6's time mix and Mamba2 as their families'
# counterpart), the MoE's routing, dispatch and combine, its experts, the
# dense MLPs (RWKV6's channel mix too), the norms, the head and the
# cross-entropy of a chunk, the gradient reduction and the optimizer's
# update, and whatever ran outside all of them
REST_PARTS = ("carries", "attention", "moe_dispatch", "experts",
              "dense_mlp", "norms", "ce_chunk", "optimizer", "other")


class PartTracker:
    """Which layer part is running, for `MemoryTally` to file each new
    storage under (``label()``: ``"part/phase"``).

    Module forward hooks (pre and post, process-wide while it is on) keep
    a stack of the parts of the modules running (`part_of`: a module of
    no part of its own, a `Linear` say, is in its enclosing one's), and
    two functions of the step are wrapped the same way: the chunked
    cross-entropy (``ce_chunk``) and the gradient reduction and update
    (``optimizer``).  Backward allocations go to the part whose forward
    made the autograd node running (`torch._C._current_autograd_node`):
    at a part's exit the nodes its outputs reach that no part claimed
    yet are tagged with it (``node.metadata``), and at its entry those
    its inputs reach with the enclosing part.  A forward run again in the
    backward (a checkpointed layer, `fsdp.recomputed`) is the recompute
    phase.  Nothing here holds a tensor: the stack holds names, the
    nodes a string, and a block's output is marked a carry by its
    storage's number in the tally."""

    def __init__(self, model, mem: "MemoryTally"):
        from repro_torch.nn.layers import LAYER_STACKS
        layer = re.compile(r"(%s)\.\d+" % "|".join(LAYER_STACKS))
        self.mem = mem
        self.parts = {id(m): self.part_of(n, m)
                      for n, m in model.named_modules()}
        self.carry_ids = {id(m) for n, m in model.named_modules()
                          if layer.fullmatch(n) or n == "embed"}
        self.stack: list = []
        self.carries: set = set()
        self._undo: list = []

    @staticmethod
    def part_of(name: str, module):
        """A module's part, or None: it is in its enclosing one's."""
        from repro_torch.nn.attention import Attention
        from repro_torch.nn.layers import MLP, LayerNorm, RMSNorm
        from repro_torch.nn.moe import Experts, MoELayer
        from repro_torch.nn.ssm import Mamba2, RWKV6ChannelMix, RWKV6TimeMix
        leaf = name.rpartition(".")[2]
        kinds = ((Experts, "experts"), (MoELayer, "moe_dispatch"),
                 ((Attention, Mamba2, RWKV6TimeMix), "attention"),
                 ((MLP, RWKV6ChannelMix), "dense_mlp"),
                 ((RMSNorm, LayerNorm), "norms"))
        for kind, part in kinds:
            if isinstance(module, kind):
                return part
        return "ce_chunk" if leaf in ("lm_head", "head") else None

    def phase(self) -> str:
        if torch._C._current_graph_task_id() < 0:
            return "forward"
        return "recompute" if fsdp._state.recompute else "backward"

    def label(self) -> str:
        phase = self.phase()
        part = self._current(None)
        if part is None and phase != "forward":
            node = torch._C._current_autograd_node()
            if node is not None:
                part = node.metadata.get("part")
        return f"{part or 'other'}/{phase}"

    def _tag(self, tensors, part: str) -> None:
        """Tag the autograd nodes `tensors` reach that no part holds yet
        with `part` (a parameter's accumulator is nobody's)."""
        todo = [t.grad_fn for t in tensors
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or "part" in node.metadata \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            node.metadata["part"] = part
            todo.extend(f for f, _ in node.next_functions)

    def _current(self, default="other"):
        """The innermost running part (`default` outside all)."""
        return next((p for p in reversed(self.stack) if p is not None),
                    default)

    def enter(self, part, inputs) -> None:
        self._tag(tree_leaves(inputs), self._current())
        self.stack.append(part)

    def exit(self, outputs) -> None:
        part = self._current()
        self.stack.pop()
        self._tag(tree_leaves(outputs), part)

    def _pre(self, module, args):
        key = id(module)
        if key in self.parts:
            self.enter(self.parts[key], args)

    def _post(self, module, args, out):
        key = id(module)
        if key not in self.parts:
            return
        self.exit(out)
        if key in self.carry_ids and self.phase() == "forward":
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    seq = self.mem.seq_of(t)
                    if seq is not None:
                        self.carries.add(seq)

    def _region(self, part: str, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            self.enter(part, (args, kwargs))
            try:
                out = fn(*args, **kwargs)
            finally:
                self.stack.pop()
            self._tag(tree_leaves(out), part)
            return out
        return run

    def __enter__(self):
        from torch.nn.modules import module as nn_module

        from repro_torch.distributed.partition import MeshPlan
        from repro_torch.train import optimizer, train_loop
        self._undo = [nn_module.register_module_forward_pre_hook(self._pre),
                      nn_module.register_module_forward_hook(self._post)]
        patched = [(train_loop, "chunked_cross_entropy", "ce_chunk")]
        patched += [(owner, name, "optimizer")
                    for owner in (optimizer.AdamW, optimizer.Adafactor)
                    for name in ("update", "update_")]
        patched += [(MeshPlan, name, "optimizer")
                    for name in ("zero_reduce_grads", "zero_gather")]
        self._patched = []
        for owner, name, part in patched:
            fn = owner.__dict__[name]
            self._patched.append((owner, name, fn))
            setattr(owner, name, self._region(part, fn))
        return self

    def __exit__(self, *exc):
        for handle in self._undo:
            handle.remove()
        for owner, name, fn in self._patched:
            setattr(owner, name, fn)
        return False

    def rest_by_part(self, live: dict, labels: dict) -> dict:
        """{"part/phase": bytes} of the live storages `live` ({number:
        bytes}) by their `labels`, carries apart."""
        out: dict = {}
        for seq, nbytes in live.items():
            key = ("carries/forward" if seq in self.carries
                   else labels.get(seq, "other/forward"))
            out[key] = out.get(key, 0) + nbytes
        return dict(sorted(out.items()))


def _flat_args(args, kwargs):
    """The leaves of an op's arguments (lists and tuples opened once:
    aten arguments nest no deeper)."""
    for a in itertools.chain(args, kwargs.values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


class MetaShapeCache:
    """Outputs of functional ops on meta tensors from a cache of their
    metadata.  A meta kernel computes only the output's shape, strides
    and dtype, which depend on the inputs' metadata and the other
    arguments alone, yet many run in Python (a ``where`` with a scalar
    among them); a step repeats the same ops on the same shapes layer
    after layer.  An op qualifies when its
    schema mutates nothing and returns no alias, every tensor argument is
    meta and every other argument hashable; its first call runs the
    kernel, and a result that is not meta (a factory on another device)
    or shares an input's storage (a view without an alias annotation)
    marks the key as not cached."""

    _NO = object()

    def __init__(self):
        self._cache: dict = {}

    @staticmethod
    def _key(func, args, kwargs):
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None
                                    for r in schema.returns):
            return None
        parts = [func]
        for a in _flat_args(args, kwargs):
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                parts.append((tuple(a.shape), a.stride(), a.dtype,
                              a.storage_offset()))
            elif a is None or isinstance(a, (int, float, bool, str,
                                             torch.dtype, torch.device,
                                             torch.layout,
                                             torch.memory_format)):
                parts.append((type(a), a))
            else:
                return None
        parts.append(tuple(sorted(kwargs)))
        return tuple(parts)

    def run(self, func, args, kwargs):
        key = self._key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        spec = self._cache.get(key)
        if spec is self._NO:
            return func(*args, **kwargs)
        if spec is not None:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in spec[1]]
            return outs[0] if spec[0] else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        inputs = {id(a.untyped_storage()) for a in _flat_args(args, {})
                  if isinstance(a, torch.Tensor)}
        if not isinstance(outs, (tuple, list)) or not all(
                isinstance(o, torch.Tensor) and o.device.type == "meta"
                and id(o.untyped_storage()) not in inputs for o in outs):
            self._cache[key] = self._NO
        else:
            self._cache[key] = (single, [(tuple(o.shape), o.stride(),
                                          o.dtype) for o in outs])
        return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _result_bytes(name: str, args: tuple, kwargs: dict) -> int:
    """Bytes of the call's result tensor (the output of a gather or
    scatter, the tensor reduced or broadcast in place)."""
    if name == "barrier":
        return 0
    t = kwargs.get("output_tensor", kwargs.get("tensor"))
    if t is None and args:
        t = args[0]
    return int(t.numel()) * t.element_size() if t is not None else 0


class CommTally:
    """Counts the `torch.distributed` calls made inside the block (the
    module's functions wrapped for its duration): per op a count and the
    result bytes, and per mesh axis the same (the axis whose process
    group the call names; "world" for the default group)."""

    def __init__(self, mesh=None):
        self.names = {}
        if mesh is not None:
            lines = dict(mesh.axes)
            if mesh.batch is not None:
                lines.setdefault(mesh.batch.name, mesh.batch)
            for name, axis in lines.items():
                if axis.group is not None:
                    self.names[id(axis.group)] = name
        self.reset()
        self._real = {}

    def reset(self) -> None:
        self.per_op = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
        self.per_axis: dict = {}

    def _wrap(self, name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            nbytes = _result_bytes(name, args, kwargs)
            group = kwargs.get("group")
            axis = self._axis_name(group) if group is not None \
                else "world"
            for entry in (self.per_op[name],
                          self.per_axis.setdefault(
                              axis, {"count": 0, "bytes": 0})):
                entry["count"] += 1
                entry["bytes"] += nbytes
            return fn(*args, **kwargs)
        return call

    def _axis_name(self, group) -> str:
        """The mesh axis a call's group is a line of: a named axis, a
        line of consecutive ranks of one (`collectives.sub_axis`, named
        ``axis/size``), or "world"."""
        name = self.names.get(id(group))
        if name is None:
            line = collectives.sub_axis_of(group)
            name = line.name if line is not None else "world"
        return name

    def __enter__(self):
        self._real = {name: getattr(dist, name) for name in COLLECTIVE_OPS}
        for name, fn in self._real.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(dist, name, fn)
        return False

    def summary(self) -> dict:
        """The reference's `parse_collectives` keys, and ``per_axis``."""
        return {"total_bytes": sum(v["bytes"] for v in self.per_op.values()),
                "per_op": {k: dict(v) for k, v in self.per_op.items()},
                "n_ops": sum(v["count"] for v in self.per_op.values()),
                "per_axis": {k: dict(v) for k, v in self.per_axis.items()}}


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _observing(fn: Callable):
    """`fn` among `fsdp.observers` for the block."""
    fsdp.observers.append(fn)
    try:
        yield
    finally:
        fsdp.observers.remove(fn)


def _tensors(tree) -> list:
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif hasattr(leaf, "__dataclass_fields__"):
            out.extend(v for v in vars(leaf).values()
                       if isinstance(v, torch.Tensor))
    return out


def trace_step(setup: Callable, *, mesh=None, parts: bool = True) -> dict:
    """``setup() -> (fn, args, model, kind)`` runs first (the setup window:
    build, split, state), then ``fn(*args)`` once (the step window),
    under `MemoryTally` (FLOPs counted in the step) and `CommTally`.  A
    setup that builds on the meta device allocates nothing.  Returns the
    peaks (the step's split into parameters, gradients, optimizer state,
    cache, the whole parameters gathered at use under FSDP — transient:
    a layer's, forward or backward — and the rest), the step's
    collectives and FLOPs, the bytes held between steps and the seconds
    taken; with `parts`, also the rest at the peak by layer part
    (``rest_by_part``, `PartTracker`), which moves no byte."""
    from repro_torch.distributed.partition import tree_bytes
    t0 = time.perf_counter()
    gathered: set = set()
    with MemoryTally() as mem, CommTally(mesh) as comm, \
            _observing(lambda t: gathered.add(mem.seq_of(t))):
        fn, args, model, kind = setup()
        setup_peak = mem.peak
        mem.reset_peak()
        comm.reset()
        t1 = time.perf_counter()
        mem.flops = 0
        tracker = PartTracker(model, mem) if parts else \
            contextlib.nullcontext()
        with tracker:
            mem.parts = tracker if parts else None
            out = fn(*args)
        flops, mem.flops = mem.flops, None
        params = list(model.parameters())
        # train -> (params, opt_state, metrics); prefill -> (logits,
        # cache); decode reads and writes its cache argument
        opt = _tensors(out[1]) if kind == "train" else []
        cache = {"prefill": lambda: _tensors(out[1]),
                 "decode": lambda: _tensors(args[2])}.get(kind, list)()
        peak = mem.breakdown({
            "params": params,
            "grads": [p.grad for p in params if p.grad is not None],
            "opt_state": opt, "cache": cache, "gathered": gathered})
        held = {"params": tree_bytes({k: p.detach() for k, p in
                                      model.named_parameters()}),
                "opt_state": sum(int(t.numel()) * t.element_size()
                                 for t in opt)}
    mem.parts = None
    out = {"peak": peak, "setup_peak": setup_peak,
           "collectives": comm.summary(),
           "flops": float(flops), "held": held,
           "setup_s": t1 - t0, "step_s": time.perf_counter() - t1}
    if parts:
        out["rest_by_part"] = mem.rest_by_part
    return out


def trace_train(cfg, optimizer, batch: dict, *, plan=None,
                n_microbatches: int = 1, device="meta",
                init: Callable | None = None, place: bool = False,
                parts: bool = True) -> dict:
    """`trace_step` of one LM train step of `cfg` (`make_train_step`; on
    `plan`'s ranks `MeshTrainStep(zero1=True)`, over parameters placed
    first by `MeshPlan.place_params_` (FSDP) with `place`): the model
    built whole on `device` (meta for the dry run; then `init(model)`
    where given: real runs draw it), the
    optimizer state made, and a step on zero tensors of `batch`'s
    {name: (shape, dtype)}.  Also returns the bytes a rank holds
    between steps (``held``)."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.train_loop import make_train_step

    def setup():
        model = build_model(cfg, device)
        if init is not None:
            init(model)
        if place:
            plan.place_params_(model)
        step = make_train_step(model, cfg, optimizer, plan=plan,
                               zero1=plan is not None,
                               n_microbatches=n_microbatches)
        params = dict(model.named_parameters())
        state = (step.init_opt_state(params) if plan is not None
                 else optimizer.init(params, stack_groups(params)))
        args = (params, state,
                {k: torch.zeros(shape, dtype=dtype, device=device)
                 for k, (shape, dtype) in batch.items()})
        return step, args, model, "train"

    from repro_torch.nn.layers import stack_groups
    return trace_step(setup, mesh=plan.mesh if plan is not None else None,
                      parts=parts)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

MODEL_RULED = ("heads", "kv_heads", "mlp", "vocab", "expert")


# the families whose residual stream the port cuts by sequence: all
SEQ_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def _seq_cut(cell, plan) -> tuple:
    """({"residual": bool, "cache": bool}, {what stays unapplied: why}):
    the parts of a cell the ``"seq"`` rule of its plan cuts over a mesh
    axis, and those the reference cuts that the port does not or that
    the axis does not divide (whisper's training cuts its frames and
    its decoder tokens together, `WhisperModel.seq_axes`)."""
    from repro_torch.distributed.sharding import seq_axis, use_sharding
    cut = {"residual": False, "cache": False}
    if cell.rule_overrides.get("seq") is None:
        return cut, {}
    shape, cfg = cell.shape, cell.cfg
    residual = shape.kind in ("train", "prefill")
    length = shape.seq_len
    if cfg.family == "vlm" and residual:
        length = cfg.num_patches + max(shape.seq_len - cfg.num_patches, 8)
    cache_len = {"prefill": shape.seq_len, "decode": shape.seq_len}.get(
        shape.kind)
    if cfg.family == "audio" and shape.kind != "train":
        from repro_torch.launch.specs import WHISPER_DECODE_SELF_LEN
        cache_len = WHISPER_DECODE_SELF_LEN
    unapplied = {}
    with use_sharding(plan.mesh, plan.param_rules, plan.act_rules):
        if residual:
            if cfg.family not in SEQ_FAMILIES:
                unapplied["residual"] = (f"{cfg.family}: not ported "
                                         "(ROADMAP.md follow-ups)")
            elif seq_axis(length) is None:
                unapplied["residual"] = f"{length} positions do not divide"
            elif (cfg.family == "audio" and shape.kind == "train"
                  and seq_axis(max(length // DEC_FRACTION, 8)) is None):
                unapplied["residual"] = (
                    f"{max(length // DEC_FRACTION, 8)} decoder positions "
                    "do not divide")
            else:
                cut["residual"] = True
        if cache_len and cfg.family != "ssm":
            if seq_axis(cache_len) is None:
                unapplied["cache"] = f"{cache_len} positions do not divide"
            else:
                cut["cache"] = True
    return cut, unapplied


def _layout(cell, plan, whole_shapes: dict) -> dict:
    """What the port ran: FSDP and the "embed" leaves left whole over
    "data", ZeRO-1 (train), the parameter kinds that stayed whole over
    "model" (block indices folded), how the cache is cut, the sequence
    cut applied and the cell's overrides left unapplied."""
    from repro_torch.nn.layers import param_axes
    plan = cell.plan if cell.plan is not None else plan
    axes = param_axes(cell.model)
    placed = getattr(cell.model, "mesh_layout", None)
    whole = sorted({re.sub(r"\.\d+\.", ".*.", k)
                    for k, p in cell.model.named_parameters()
                    if (placed.model_dims[k] < 0 if placed is not None
                        else tuple(p.shape) == whole_shapes[k])
                    and any(a in MODEL_RULED for a in axes[k])})
    cut, unapplied = _seq_cut(cell, plan)
    alike = sorted({re.sub(r"\.\d+\.", ".*.", k)
                    for k in (placed.fused if placed is not None else {})})
    out = {"tensor_parallel": bool(plan.model_axis),
           "whole_over_model": whole,
           "alike_over_model": alike,
           "seq_cut": cut,
           "unapplied_overrides": ({"seq": unapplied} if unapplied
                                   else {})}
    out["fsdp"] = bool(placed is not None and placed.fsdp
                       and any(d >= 0 for d in placed.data_dims.values()))
    if out["fsdp"]:
        out["whole_over_data"] = sorted({
            re.sub(r"\.\d+\.", ".*.", k)
            for k, d in placed.data_dims.items()
            if d < 0 and "embed" in axes[k]})
    if cell.kind == "train":
        out["zero1"] = bool(cell.fn.zero)
    if cell.kind != "train":
        out["kv_cache"] = _cache_layout(cell, plan.model_size, cut["cache"])
    return out


def _cache_layout(cell, m: int, by_seq: bool) -> str:
    """How a serving cell's cache lies on a rank: the KV caches by
    sequence or by kv heads, the SSM states by heads (the wkv state by
    value columns where its time mix is so cut)."""
    cfg, model = cell.cfg, cell.model
    if cfg.family == "ssm":
        tm = model.blocks[0].tm
        if tm.cut == "value":
            return (f"wkv state by value columns: {tm.value_dim} of "
                    f"{tm.head_dim} a head a rank, all {tm.n_heads} heads")
        return (f"wkv state by heads: {tm.n_heads} of "
                f"{cfg.d_model // cfg.ssm_head_dim} a rank")
    attn = (model.shared.attn if cfg.family == "hybrid" else
            model.decoder[0].self_attn if cfg.family == "audio" else
            model.blocks[0].attn)
    out = (f"by sequence: 1/{m} of the positions a rank, all "
           f"{cfg.n_kv_heads} kv heads" if by_seq else
           f"by heads: {attn.n_kv} of {cfg.n_kv_heads} a rank, whole "
           "sequence")
    if cfg.family == "hybrid":
        mamba = model.mamba[0].mamba
        total = mamba.n_heads * (m if mamba.axis is not None else 1)
        out += f"; ssm state by heads: {mamba.n_heads} of {total} a rank"
    return out


def trace_cell(arch: str, shape: str, plan) -> dict:
    """One cell on this rank of `plan` (`trace_step` of `make_cell`):
    the dry run's row without its mesh fields."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.models.registry import build_model, get_config
    cfg = get_config(arch)
    whole = {k: tuple(p.shape) for k, p in
             build_model(cfg, "meta").named_parameters()}
    held = {}

    def setup():
        cell = make_cell(arch, shape, plan=plan)
        held["cell"] = cell
        return cell.fn, cell_inputs(cell), cell.model, cell.kind

    t = trace_step(setup, mesh=plan.mesh)
    cell = held["cell"]
    peak = t["peak"]
    return {
        "arch": arch, "shape": shape, "kind": SHAPES[shape].kind,
        "status": "OK",
        "trace_s": round(t["setup_s"] + t["step_s"], 1),
        "peak_bytes_per_device": peak,
        "setup_peak_bytes": t["setup_peak"],
        "live_bytes_per_device": peak["total"],
        "hbm_fit": bool(peak["total"] <= HBM_PER_CARD),
        "hbm_per_card": HBM_PER_CARD,
        "held_bytes_per_device": t["held"],
        "traced_flops_per_device": t["flops"],
        "rest_by_part": t["rest_by_part"],
        "collectives": t["collectives"],
        "n_microbatches": getattr(cell.fn, "n_microbatches", 1),
        "layout": _layout(cell, plan, whole),
    }


def _axis_lines(mesh) -> dict:
    """Rank 0's line of each mesh axis: its ranks (the roofline reads
    whether they sit in one 8-GPU node)."""
    lines = {name: list(axis.ranks) for name, axis in mesh.axes.items()}
    if mesh.batch is not None:
        lines.setdefault(mesh.batch.name, list(mesh.batch.ranks))
    lines["world"] = list(mesh.world.ranks)
    return lines


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    """The dry run of one cell on rank 0 of the production mesh (16 x 16,
    or 2 x 16 x 16 with `multi_pod`) in a fake world."""
    from repro_torch.distributed.partition import plan_for
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        plan = plan_for(mesh, device="cpu")
        row = trace_cell(arch, shape, plan)
        lines = _axis_lines(mesh)
    row = dict({"mesh": "2x16x16" if multi_pod else "16x16",
                "n_chips": world}, **row)
    row["axis_ranks"] = lines
    row["trace_s"] = round(time.perf_counter() - t0, 1)
    if verbose:
        coll = row["collectives"]
        print(f"[{row['mesh']}] {arch} x {shape} ({row['kind']}): traced in "
              f"{row['trace_s']:.0f}s, live/device "
              f"{row['live_bytes_per_device'] / 1e9:.2f} GB "
              f"(fit={row['hbm_fit']}), collectives "
              f"{coll['total_bytes'] / 2 ** 20:.1f} MiB in {coll['n_ops']} "
              "calls", flush=True)
    return row


def _row(cell: tuple) -> dict:
    """`run_cell`'s row, or a FAIL row with the reason."""
    arch, shape, mp = cell
    try:
        return run_cell(arch, shape, multi_pod=mp)
    except Exception as e:  # noqa: BLE001 — record and continue
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if mp else "16x16",
                "status": f"FAIL: {type(e).__name__}: {e}"}


def _rows(cells: list, jobs: int):
    """The cells' rows in the order they finish (`jobs` at a time, each
    in a spawned process: a process holds one fake world)."""
    if jobs <= 1:
        for cell in cells:
            yield _row(cell)
        return
    import concurrent.futures
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=ctx, max_tasks_per_child=1) as pool:
        for fut in concurrent.futures.as_completed(
                [pool.submit(_row, cell) for cell in cells]):
            yield fut.result()


def main(argv=None):
    from repro_torch.models.registry import runnable_cells
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell on both meshes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time, one process each")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    def done(arch, shape, mesh):
        return any(r["arch"] == arch and r["shape"] == shape
                   and r["mesh"] == mesh and r["status"] == "OK"
                   for r in results)

    cells = ([(args.arch, args.shape, args.multi_pod)]
             if not args.all else
             [(a, s, mp) for (a, s) in runnable_cells()
              for mp in (False, True)])

    todo = []
    for arch, shape, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        if args.all and done(arch, shape, mesh_name):
            print(f"skip cached {arch} x {shape} [{mesh_name}]", flush=True)
            continue
        todo.append((arch, shape, mp))

    failures = 0
    for r in _rows(todo, args.jobs):
        failures += r["status"] != "OK"
        arch, shape = r["arch"], r["shape"]
        results = [x for x in results
                   if not (x["arch"] == arch and x["shape"] == shape
                           and x["mesh"] == r["mesh"])]
        results.append(r)
        out_path.write_text(json.dumps(results, indent=1))
    print(f"dry-run complete: {len(results)} results, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
