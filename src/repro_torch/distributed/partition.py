"""The 2-D ("data", "model") mesh over `torch.distributed` ranks: one
MeshPlan for every layer (counterpart of `repro.distributed.partition`).

How the reference's JAX mesh maps onto PyTorch:

* **One mesh position is one process, and each process owns one
  device.**  Where one JAX process addresses N devices, the port runs one
  rank a device: ``num_devices`` is the `torch.distributed` world size,
  and the mesh is ``("data",)`` or ``("data", "model")`` over the ranks,
  model columns made of consecutive ranks (the reference's
  ``devices.reshape(n // mp, mp)``).  Each axis line through a rank has
  its own process group (`new_group`); a line that spans the world uses
  the default group.
* **A world of one rank runs the same program shape** with no process
  group at all: every axis has size 1 and every collective is the
  identity (`collectives`), so ``Trainer(num_devices=1)`` trains an
  R-group super-batch on one device as the reference's ``(data=1)`` mesh
  does, and its loss equals the N-rank run's.
* **A rank is handed either the global super-batch or its own row's
  group.**  The global one is the stream of a host's
  `GraphBatcher(num_replicas=R)`, as the reference's single-process mesh
  is, and `MeshPlan.put_super_batch` takes this rank's contiguous block
  of the R component groups.  The per-rank one is the port's
  counterpart of the reference's process-local placement
  (`make_array_from_process_local_data`): a reference host holding a
  data row is a rank here, so rank ``r`` of a (data=R, model=M) mesh
  reads ``GraphBatcher(rank=r // M, world=R, num_replicas=1)`` (or a
  fleet of that plan, over TCP from a `SamplerEndpoint`), which is
  group ``r // M`` of the global super-batch bit for bit (the plan
  splits a step into contiguous blocks).  Either way the groups are
  placed at full width: every rank holds the whole host batch, so the
  feature dim is not cut at placement; the ops split it at the pool
  boundary.
* **Backend**: the caller's explicit choice (`initialize_distributed`),
  printed by every run: NCCL when every rank has its own card (it cannot
  put two ranks on one device), gloo otherwise (the CPU, or two ranks
  sharing one card, where gloo takes the CUDA tensors as they are).

A MeshPlan derives from the mesh and the rule tables of
`repro_torch.distributed.sharding`:

* the placement of a super-batch (leading group axis -> "data");
* the gather boundaries: `model_context()` makes the model axis visible
  to `repro_torch.core.ops`, which splits the feature axis of each
  segment reduction and all-gathers the pooled result
  (`repro_torch.core.mp_context`); gradients are then averaged over
  every mesh axis — over "data" the cross-replica mean, over "model" the
  reassembly of the per-chunk cotangents;
* ZeRO-1 optimizer state: AdamW's moments are cut over "data" along
  the leading dim of each parameter (logical "embed"), each data rank
  updates only its slice (`zero_slice`) with the gradient reduce-
  scattered to it (`zero_reduce_grads`), the clipping norm is
  all-reduce-corrected (`repro_torch.train.optimizer.global_norm`), and
  the updated slices are all-gathered back (`zero_gather`): parameters
  stay replicated, the state shrinks by the data factor;
* the kernels' dispatch context (`dispatch_context`): the registry's
  `partitioned(data=, model=)`, under which the autotune keys count a
  data shard's rows and a model shard's widths, as the reference's
  decisions do under GSPMD.  The LM mesh step
  (`repro_torch.train.train_loop.make_train_step` with ``plan=``) runs
  under it; the GNN step's per-rank shapes are a shard's already.

A mesh may also lead with a "stage" axis (``make_mesh(stages=S)``), the
ranks of one pipeline (`repro_torch.distributed.pipeline_parallel`), or
with a "pod" axis (``make_mesh(pods=P)``, the reference's production
``("pod", "data", "model")``).  A pod's ranks are a consecutive block,
as a stage's are.  The batch splits over pod x data (the act rule of
"batch"; the mesh's `batch` axis is that line of ranks), gradients are
summed over both, and ZeRO-1 slices over "data" only (the param rule
``"embed": "data"``), so the optimizer state is the same in every pod.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import mp_context
from repro_torch.core.graph_tensor import (_map_graphs, resolve_device,
                                           stack_graphs, stack_size,
                                           to_device, unstack_graph)
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import Axis
from repro_torch.distributed.sharding import (DEFAULT_ACT_RULES,
                                              DEFAULT_PARAM_RULES,
                                              ShardingContext,
                                              data_axis_names, tree_map)

GROUP_AXIS = "batch"    # logical name of the leading component-group axis
MODEL_AXIS = "model"    # mesh axis carrying feature-dim model parallelism
DATA_AXIS = "data"
STAGE_AXIS = "stage"    # mesh axis of pipeline stages (outermost)
POD_AXIS = "pod"        # mesh axis of pods (data parallel, outside "data")
BATCH_LINE = "pod+data"  # the pod x data line of a mesh with pods
PROCESS_GROUP_TIMEOUT_S = 300.0   # a collective that waits longer fails


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str = "gloo") -> bool:
    """Join a job of `torch.distributed` ranks.

    Reads explicit args or the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment (the
    reference's contract); ``backend`` is the caller's choice.  The
    coordinator is an init method: ``tcp://host:port`` (a bare
    ``host:port`` is taken as tcp) or ``file:///path`` (a `FileStore`,
    which needs no port).  With NCCL each rank takes card
    ``rank % device_count`` as its current device first.
    Returns True when a process group was initialized, False when
    unconfigured or the world is one process (which needs none)."""
    coord = coordinator_address or os.environ.get("REPRO_COORDINATOR", "")
    nproc = int(num_processes if num_processes is not None
                else os.environ.get("REPRO_NUM_PROCESSES", "0") or 0)
    pid = int(process_id if process_id is not None
              else os.environ.get("REPRO_PROCESS_ID", "0") or 0)
    if not coord or nproc <= 1:
        return False
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    init_method = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nproc, rank=pid,
                            timeout=datetime.timedelta(
                                seconds=PROCESS_GROUP_TIMEOUT_S))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend_name() -> str:
    """The default group's backend, or "none" for a world of one
    process without a process group."""
    return str(dist.get_backend()) if dist.is_initialized() else "none"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a grid: ``axis_names`` ("data",) or ("data",
    "model"), led by "pod" or "stage" where there is one, ``shape``
    {axis: size}; ``axes`` holds this rank's `Axis` for each, ``world``
    the axis of every rank, ``batch`` the line of data-parallel ranks
    (pod x data, pod-major; the "data" axis without pods)."""

    axis_names: tuple
    shape: dict
    rank: int
    axes: dict
    world: Axis
    backend: str
    batch: Optional[Axis] = None

    @property
    def devices(self) -> np.ndarray:
        """Global ranks laid out as the mesh (data rows x model
        columns)."""
        sizes = tuple(self.shape[a] for a in self.axis_names)
        return np.arange(int(np.prod(sizes))).reshape(sizes)


def _line_group(ranks: list, world: int):
    """The process group of one axis line, created on every rank (a
    collective call); None for the whole world (the default group) and
    for a line of one rank (no collective runs on it)."""
    if len(ranks) in (1, world):
        return None
    return dist.new_group(ranks)


def make_mesh(num_devices: Optional[int] = None, *,
              model_parallel: int = 1, stages: int = 1,
              pods: int = 1) -> Mesh:
    """A ("data",) mesh, or a 2-D ("data", "model") mesh when
    ``model_parallel > 1`` (data rows x model columns of consecutive
    ranks), over the ranks of the initialized world (one rank without
    one).  With ``stages > 1`` a "stage" axis leads, with ``pods > 1`` a
    "pod" axis: the world is cut into that many blocks of consecutive
    ranks, each such a mesh.  Every rank must call it, in the same
    order: it creates the axes' process groups."""
    world = world_size()
    n = num_devices or world
    if world != n:
        raise RuntimeError(
            f"need {n} devices, have {world} — run {n} torch.distributed "
            "ranks, one device each (partition.initialize_distributed)")
    mp = max(int(model_parallel), 1)
    st = max(int(stages), 1)
    po = max(int(pods), 1)
    if n % mp:
        raise ValueError(f"model_parallel {mp} must divide the device "
                         f"count {n}")
    if n % (mp * st * po):
        raise ValueError(f"stages {st} x pods {po} x model_parallel {mp} "
                         f"must divide the device count {n}")
    rank = world_rank()
    # dims: stage, pod, data, model
    grid = np.arange(n).reshape(st, po, n // (mp * st * po), mp)
    here = tuple(int(i) for i in np.argwhere(grid == rank)[0])
    lines_of = {DATA_AXIS: (2,), MODEL_AXIS: (3,), STAGE_AXIS: (0,),
                POD_AXIS: (1,)}
    if po > 1:
        lines_of[BATCH_LINE] = (1, 2)
    groups = {}
    if n > 1:
        # every rank creates every axis line's group, in one order
        for name, dims in lines_of.items():
            for line in _lines(grid, dims):
                g = _line_group(line, n)
                if rank in line:
                    groups[name] = g

    def axis(name):
        dims = lines_of[name]
        index = tuple(slice(None) if d in dims else here[d]
                      for d in range(grid.ndim))
        ranks = tuple(grid[index].reshape(-1).tolist())
        return Axis(name, len(ranks), ranks.index(rank), ranks,
                    groups.get(name))

    axes = {DATA_AXIS: axis(DATA_AXIS)}
    names = (DATA_AXIS,)
    if mp > 1:
        axes[MODEL_AXIS] = axis(MODEL_AXIS)
        names += (MODEL_AXIS,)
    batch = axes[DATA_AXIS]
    if po > 1:
        axes[POD_AXIS] = axis(POD_AXIS)
        names = (POD_AXIS,) + names
        batch = axis(BATCH_LINE)
    if st > 1:
        axes[STAGE_AXIS] = axis(STAGE_AXIS)
        names = (STAGE_AXIS,) + names
    everyone = Axis("world", n, rank, tuple(range(n)), None)
    return Mesh(names, {a: axes[a].size for a in names}, rank, axes,
                everyone, backend_name(), batch)


def _lines(grid: np.ndarray, dims: tuple) -> list:
    """The lines of `grid` along `dims` (their ranks in row-major order
    of those dims), one per position of the other dims."""
    rest = [d for d in range(grid.ndim) if d not in dims]
    moved = np.transpose(grid, rest + list(dims))
    size = int(np.prod([grid.shape[d] for d in dims]))
    return moved.reshape(-1, size).tolist()


# ---------------------------------------------------------------------------
# Trees: {name: tensor} dicts, NamedTuples (AdamWState), axes tuples
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, NamedTuples)."""
    out = []
    tree_map(out.append, tree)
    return sum(int(x.numel()) * x.element_size() for x in out)


# ---------------------------------------------------------------------------
# MeshPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshPlan:
    """Axes, per-leaf specs and gather/mean boundaries for one mesh.

    Every layer consumes the plan instead of re-deriving its own specs:
    `put_super_batch` (placement), `model_context` (the step's gather
    boundaries), `zero_*` (the optimizer-state layout).  ``device`` is
    this rank's device."""

    mesh: Mesh
    param_rules: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES))
    act_rules: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ACT_RULES))
    device: Any = None

    # -- axis bookkeeping ----------------------------------------------------

    @property
    def data_axes(self) -> tuple:
        return data_axis_names(self.mesh)

    @property
    def data_size(self) -> int:
        size = 1
        for a in self.data_axes:
            size *= self.mesh.shape[a]
        return size

    @property
    def data_axis(self) -> Axis:
        return self.mesh.axes[DATA_AXIS]

    @property
    def batch_axis(self) -> Axis:
        """The line of data-parallel ranks through this rank: pod x data
        (the "data" axis on a mesh without pods)."""
        return self.mesh.batch or self.data_axis

    @property
    def pod_axis(self) -> Optional[Axis]:
        return self.mesh.axes.get(POD_AXIS)

    @property
    def model_axis(self) -> Optional[str]:
        if MODEL_AXIS in self.mesh.axis_names \
                and self.mesh.shape[MODEL_AXIS] > 1:
            return MODEL_AXIS
        return None

    @property
    def model_size(self) -> int:
        return self.mesh.shape.get(MODEL_AXIS, 1)

    @property
    def num_devices(self) -> int:
        return self.mesh.world.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def is_main(self) -> bool:
        return self.mesh.rank == 0

    def local_data_size(self, n_groups: int) -> int:
        """Data shards a super-batch of `n_groups` groups handed to this
        rank covers: all of them when the count is a multiple of the
        data size (the global super-batch, as on the reference's
        single-process mesh), one when it is a single group (this rank's
        own row, the per-rank stream); any other count raises."""
        if n_groups % self.data_size == 0:
            return self.data_size
        if n_groups == 1:
            return 1
        raise ValueError(
            f"super-batch has {n_groups} component groups: neither a "
            f"multiple of the {self.data_size} data shards (a global "
            "super-batch) nor one group (this rank's own row)")

    def describe(self) -> str:
        """e.g. ``(data=2, model=2) over 4 rank(s), backend gloo``."""
        axes = ", ".join(f"{a}={self.mesh.shape[a]}"
                         for a in self.mesh.axis_names)
        return (f"({axes}) over {self.num_devices} rank(s), backend "
                f"{self.mesh.backend}")

    def _ctx(self) -> ShardingContext:
        return ShardingContext(self.mesh, self.param_rules, self.act_rules)

    def _axis_of(self, entry) -> Optional[Axis]:
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        if len([a for a in names if a in self.mesh.axes]) > 1:
            return self.batch_axis  # ("pod", "data"): the data spec
        for name in names:
            if name in self.mesh.axes:
                return self.mesh.axes[name]
        return None

    def model_context(self):
        """The ops' model-parallel context for the duration of a step."""
        return mp_context.model_parallel_trace(
            self.mesh.axes[MODEL_AXIS] if self.model_axis else None)

    def dispatch_context(self):
        """The kernels' dispatch context for a step whose decisions see
        the whole batch (the LM mesh step): autotune keys count rows per
        data shard and widths per model shard
        (`repro_torch.kernels.registry.partitioned`)."""
        from repro_torch.kernels import registry
        return registry.partitioned(data=self.data_size,
                                    model=self.model_size)

    def barrier(self) -> None:
        collectives.barrier(self.mesh.world)

    # -- super-batch placement -----------------------------------------------

    def data_spec(self) -> tuple:
        """Spec sharding a leading batch/group dim over the data axes."""
        axes = self.data_axes
        return ((axes if len(axes) > 1 else axes[0]),) if axes else ()

    def _block(self, x, spec):
        """This rank's block of a host (or tensor) leaf under `spec`."""
        for dim, entry in enumerate(spec):
            axis = self._axis_of(entry) if entry is not None else None
            if axis is None or axis.size == 1:
                continue
            width = x.shape[dim] // axis.size
            index = [slice(None)] * x.ndim
            index[dim] = slice(axis.index * width, (axis.index + 1) * width)
            x = x[tuple(index)]
        return x

    def put_super_batch(self, graph, labels, non_blocking: bool = False):
        """Place a host super-batch and its per-group labels on this
        rank's device, at full width.  A global super-batch (a multiple
        of the data size in groups) gives this rank its contiguous block
        of the groups; a single group is this rank's own row (a per-rank
        stream) and is placed whole (`local_data_size`; the Trainer
        takes one group as a row only from a per-row source).  At one
        data shard a scalar GraphTensor is promoted to a [1, ...] stack,
        so a one-rank plan runs the identical program; at more it
        raises.  ``non_blocking``: through pinned
        buffers (`to_device`)."""
        if stack_size(graph) is None:
            if self.data_size > 1:
                raise ValueError(
                    f"an unstacked graph on a mesh of {self.data_size} "
                    "data shards: build stacked super-batches "
                    "(num_replicas=)")
            graph = stack_graphs([graph])
            labels = np.asarray(labels)[None]
        labels = labels if isinstance(labels, torch.Tensor) \
            else np.asarray(labels)
        if self.local_data_size(stack_size(graph)) > 1:
            spec = self.data_spec()
            graph = _map_graphs(lambda x: self._block(x, spec), [graph])
            labels = self._block(labels, spec)
        device = self.device if self.device is not None else "cpu"
        labels = torch.as_tensor(labels)
        if non_blocking and torch.device(device).type == "cuda":
            labels = labels.pin_memory()
        return (to_device(graph, device, non_blocking=non_blocking),
                labels.to(device, non_blocking=non_blocking))

    # -- placement of replicated state ---------------------------------------

    def replicate(self, tree: dict) -> dict:
        """Make every rank hold rank 0's values of a {name: tensor} tree
        (broadcast in place, one call per dtype); returns the tree."""
        world = self.mesh.world
        if world.size == 1:
            return tree
        by_dtype: dict = {}
        for k, x in tree.items():
            by_dtype.setdefault(x.dtype, []).append(k)
        with torch.no_grad():
            for keys in by_dtype.values():
                buf = torch.cat([tree[k].detach().reshape(-1)
                                 for k in keys])
                collectives.broadcast(buf, world)
                for k, part in zip(keys, _split_flat(buf, [tree[k]
                                                           for k in keys])):
                    tree[k].copy_(part)
        return tree

    # -- ZeRO-1 optimizer-state layout ---------------------------------------

    def param_logical_axes(self, params: dict) -> dict:
        """Default ZeRO annotation: the leading dim is logical "embed"
        (-> "data", the FSDP rule), the rest replicate.  Scalars and
        leaves whose leading dim the data axes do not divide resolve to
        replicated."""
        return {k: (("embed",) + (None,) * (p.ndim - 1)) if p.ndim else ()
                for k, p in params.items()}

    def _resolve_axes_tree(self, axes_tree, values):
        ctx = self._ctx()
        return tree_map(
            lambda a, v: ctx.resolve(a, ctx.param_rules,
                                     shape=tuple(v.shape)),
            axes_tree, values)

    def _spec_data_dim(self, spec) -> int:
        """Index of the dim a spec shards over the data axes, or -1."""
        for i, e in enumerate(tuple(spec)):
            ents = e if isinstance(e, (tuple, list)) else (e,)
            if any(a in self.data_axes for a in ents):
                return i
        return -1

    def zero_enabled(self) -> bool:
        """ZeRO-1 slices over the "data" axis ("embed" -> "data"), so it
        needs more than one rank there; pods hold equal copies."""
        return self.data_axis.size > 1

    def zero_param_specs(self, params: dict, param_axes=None) -> dict:
        """The spec of each parameter's ZeRO slice (and its gradient's)."""
        axes = param_axes if param_axes is not None \
            else self.param_logical_axes(params)
        return self._resolve_axes_tree(axes, params)

    def zero_dims(self, specs) -> Any:
        """Per leaf, the dim sharded over data (-1 = replicated)."""
        return tree_map(self._spec_data_dim, specs)

    def opt_state_specs(self, optimizer, params, opt_state,
                        param_axes=None):
        """Per-leaf specs of the optimizer state, through the optimizer's
        own `state_axes` (m/v mirror the parameters)."""
        if not self.zero_enabled():
            return tree_map(lambda x: (), opt_state)
        axes = param_axes if param_axes is not None \
            else self.param_logical_axes(params)
        return self._resolve_axes_tree(optimizer.state_axes(axes),
                                       opt_state)

    def place_opt_state(self, optimizer, params, opt_state,
                        param_axes=None):
        """The optimizer state cut to this rank's ZeRO-1 slices (what
        `make_train_step` expects), from the full state every rank
        holds."""
        specs = self.opt_state_specs(optimizer, params, opt_state,
                                     param_axes)
        return tree_map(lambda x, s: self._block(x, s).contiguous()
                         if isinstance(x, torch.Tensor) and x.ndim
                         else x, opt_state, specs)

    def gather_opt_state(self, optimizer, params, opt_state,
                         param_axes=None):
        """The full optimizer state on every rank, from this rank's
        ZeRO-1 slices (a collective: every rank calls it)."""
        # resolved against the full shapes (the slices' own shapes would
        # not divide): a state of meta tensors shaped as the parameters
        full = optimizer.init({k: torch.empty(p.shape, device="meta")
                               for k, p in params.items()})
        specs = self.opt_state_specs(optimizer, params, full, param_axes)
        dims = tree_map(self._spec_data_dim, specs)
        return tree_map(
            lambda x, d: collectives.all_gather(x, self.data_axis, d)
            if d >= 0 else x, opt_state, dims)

    def opt_state_bytes_per_device(self, opt_state) -> int:
        """Bytes of optimizer state resident on this rank (the ZeRO-1
        memory metric)."""
        return tree_bytes(opt_state)

    def zero_reduce_grads(self, grads: dict, dims: dict, *,
                          mean: bool = True, sliced: bool = False,
                          model_sum=(), model_dup=None) -> dict:
        """Cross-rank gradient mean, delivered pre-sliced for ZeRO:
        sharded leaves are averaged over "model", summed over "pod" and
        reduce-scattered over "data" (each rank receives only its
        averaged slice), while replicated leaves are averaged over every
        rank.  One collective a kind, over all leaves of that kind at
        once.

        ``mean=False`` is the LM's tensor-parallel rule: each rank's
        gradient is its part of a sum over the data ranks (the loss is
        the global mean) and each model rank holds its leaves' whole
        gradient already, so the leaves are summed over "data" only (at
        one data rank: the gradients as they are).

        ``sliced`` (FSDP, with ``mean=False``): the sharded leaves' are
        this rank's slices already summed over "data" (the gather at
        use's backward), so they are summed over "pod" alone.

        ``model_sum`` (with ``mean=False``): names of leaves whose
        gradient each model rank holds a part of (sequence parallelism:
        a leaf whole over "model" sees only this rank's slice of the
        sequence in some of its uses, or a layer split by heads reads it
        for its heads alone); ``model_dup`` ({name: (dim, [(start,
        stop)])}): the ranges of split leaves that every model rank holds
        alike and reads for its part alone (`ModelLayout.dup`).  Both are
        summed over "model" first, in one collective."""
        if (model_sum or model_dup) and self.model_axis:
            grads = dict(grads)
            names = [k for k in grads if k in set(model_sum)]
            dups = [(k, dim, lo, hi) for k, (dim, ranges)
                    in (model_dup or {}).items() for lo, hi in ranges]
            parts = [grads[k] for k in names] + [
                grads[k].narrow(dim, lo, hi - lo) for k, dim, lo, hi in dups]
            buf = collectives.all_reduce(_flat(parts),
                                         self.mesh.axes[MODEL_AXIS])
            summed = _split_flat(buf, parts)
            grads.update(zip(names, summed))
            for k in {k for k, *_ in dups}:
                grads[k] = grads[k].clone()
            for (k, dim, lo, hi), x in zip(dups, summed[len(names):]):
                grads[k].narrow(dim, lo, hi - lo).copy_(x)
        n = self.data_size
        if not mean and n == 1:
            return dict(grads)
        out = {}
        repl = [k for k in grads if dims[k] < 0]
        shard = [k for k in grads if dims[k] >= 0]
        world = self.mesh.world if mean else self.batch_axis
        if repl:
            buf = collectives.all_reduce(_flat([grads[k] for k in repl]),
                                         world)
            if mean:
                buf = buf / world.size
            out.update(zip(repl, _split_flat(buf, [grads[k]
                                                   for k in repl])))
        if shard:
            gs = [grads[k] for k in shard]
            if self.model_axis and mean:
                model = self.mesh.axes[MODEL_AXIS]
                buf = collectives.all_reduce(_flat(gs), model) / model.size
                gs = _split_flat(buf, gs)
            pod = self.pod_axis
            if pod is not None and pod.size > 1:
                gs = _split_flat(collectives.all_reduce(_flat(gs), pod), gs)
            if sliced:
                out.update(zip(shard, gs))
                return {k: out[k] for k in grads}
            nd = self.data_axis.size
            moved = [g.movedim(dims[k], 0) for k, g in zip(shard, gs)]
            table = torch.cat([m.reshape(nd, -1) for m in moved], dim=1)
            mine = collectives.reduce_scatter(table, self.data_axis,
                                              dim=0)[0]
            if mean:
                mine = mine / n
            start = 0
            for k, m in zip(shard, moved):
                shape = (m.shape[0] // nd,) + tuple(m.shape[1:])
                size = int(np.prod(shape))
                out[k] = mine[start:start + size].reshape(shape).movedim(
                    0, dims[k])
                start += size
        return {k: out[k] for k in grads}

    def gather_params(self, tree: dict, model_dims: dict,
                      fused: dict | None = None) -> dict:
        """Whole leaves from this rank's model slices: each leaf split over
        "model" (``model_dims[k] >= 0``) all-gathered on its dim, a leaf
        cut by pieces (``fused``, `ModelLayout.fused`) rebuilt from them
        (`collectives.fused_gather`), the rest as they are (a collective:
        every rank calls it)."""
        if not self.model_axis:
            return dict(tree)
        model = self.mesh.axes[MODEL_AXIS]
        fused = fused or {}
        return {k: (collectives.fused_gather(x, model, *fused[k])
                    if k in fused else
                    collectives.all_gather(x, model, model_dims[k]))
                if model_dims[k] >= 0 else x for k, x in tree.items()}

    def zero_slice(self, tree: dict, dims: dict) -> dict:
        """This data shard's slice of each leaf (identity for dim -1)."""
        return {k: x if dims[k] < 0 else
                collectives.split_chunk(x, self.data_axis, dims[k])
                for k, x in tree.items()}

    def place_params_(self, model, param_axes=None) -> ModelLayout:
        """The reference's production placement of an LM's parameters
        (``param_shardings(kind="param")`` at ``in_shardings``, its
        ``"embed": "data"`` rule: FSDP / ZeRO-3), in place: the model
        split over "model" (`model_layout`), then each leaf cut over
        "data" on the dim its "embed" axis resolves to, where the data
        ranks divide that dim of the whole leaf (the rest stay whole, as
        the reference's divisibility rule leaves them).  The owning
        module records each cut (``fsdp_cut``) and gathers it at use
        (`repro_torch.distributed.fsdp`); the layout goes on the model
        (``mesh_layout``), where `MeshTrainStep` reads it.  Every rank
        calls it on the same whole model."""
        return _place_params(self, model, param_axes)

    def zero_gather(self, tree: dict, dims: dict) -> dict:
        """All-gather updated parameter slices back to full leaves (one
        collective for all sharded leaves)."""
        shard = [k for k in tree if dims[k] >= 0]
        out = dict(tree)
        n = self.data_axis.size
        if not shard or n == 1:
            return out
        moved = [tree[k].movedim(dims[k], 0).contiguous() for k in shard]
        full = collectives.all_gather(_flat(moved), self.data_axis, dim=0)
        table = full.reshape(n, -1)
        start = 0
        for k, m in zip(shard, moved):
            size = m.numel()
            part = table[:, start:start + size].reshape(
                (n * m.shape[0],) + tuple(m.shape[1:]))
            out[k] = part.movedim(0, dims[k])
            start += size
        return out


@dataclasses.dataclass
class ModelLayout:
    """How an LM's leaves lie on a plan's mesh (`model_layout`), by
    parameter name: ``full`` the whole shapes, ``axes`` the logical
    axes as the rank holds the leaf (a leaf whole over "model" loses
    its model names), ``specs`` those resolved against the whole
    shapes, ``model_dims`` / ``data_dims`` the dim cut over "model" and
    the dim its "embed" axis resolves to over "data" (-1: none).
    ``fsdp``: the leaves are cut over "data" at rest
    (`MeshPlan.place_params_`).  ``fused``: {name: (dim, pieces)} of the
    leaves a layer cut by heads within a fused dim (`Mamba2.fused_cuts`:
    each piece cut over "model" or held whole by every rank); ``partial``
    the leaves whole over "model" that a split layer reads in part
    (`read_in_part`): each rank holds a part of their gradient."""

    plan: Any
    full: dict
    axes: dict
    specs: dict
    model_dims: dict
    data_dims: dict
    fsdp: bool = False
    fused: dict = dataclasses.field(default_factory=dict)
    partial: tuple = ()

    @property
    def dup(self) -> dict:
        """{name: (dim, [(start, stop)])}: the ranges of each fused leaf,
        in this rank's slice, that every model rank holds alike."""
        out = {}
        for k, (dim, pieces) in self.fused.items():
            size, start, ranges = self.plan.model_size, 0, []
            for width, cut in pieces:
                held = width // size if cut else width
                if not cut:
                    ranges.append((start, start + held))
                start += held
            out[k] = (dim, ranges)
        return out

    def rank_part(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This model rank's part of the whole leaf `name` (its slice on
        the dim cut over "model", its pieces of a fused leaf)."""
        dim = self.model_dims[name]
        if dim < 0:
            return whole
        axis = self.plan.mesh.axes[MODEL_AXIS]
        if name in self.fused:
            return collectives.fused_slice(whole, dim, self.fused[name][1],
                                           axis)
        width = whole.shape[dim] // axis.size
        return whole.narrow(dim, axis.index * width, width)


def _split_dim(full: tuple, local: tuple) -> int:
    """The one dim on which a leaf's local shape is cut from its full
    shape, or -1 when it is whole."""
    cut = [i for i, (a, b) in enumerate(zip(full, local)) if a != b]
    if len(cut) > 1:
        raise ValueError(f"a leaf of {full} cut to {local} on dims {cut}")
    return cut[0] if cut else -1


def _whole_over_model(axes: tuple, rules: Mapping) -> tuple:
    """`axes` with every name the rules put on "model" dropped (a leaf
    that stays whole on every model rank)."""
    def on_model(name):
        target = rules.get(name) if name is not None else None
        return MODEL_AXIS in (target if isinstance(target, (tuple, list))
                              else (target,))
    return tuple(None if on_model(a) else a for a in axes)


def _module_leaves(model, method: str) -> dict:
    """{parameter name: value} of what each submodule's `method` gives
    by its own leaf names ({leaf: value}, or a tuple of leaves)."""
    out = {}
    for prefix, mod in model.named_modules():
        if not hasattr(mod, method):
            continue
        got = getattr(mod, method)()
        items = got.items() if isinstance(got, dict) else (
            (leaf, None) for leaf in got)
        for leaf, value in items:
            out[f"{prefix}.{leaf}" if prefix else leaf] = value
    return out


def model_layout(model, plan: "MeshPlan", param_axes=None) -> ModelLayout:
    """Split `model` over the plan's "model" axis in place (tensor
    parallelism: the model's ``split_``, every family's; a layer whose
    heads or experts the axis does not divide takes the resolver's
    fall-through: experts by hidden width, attention's weights cut at
    rest by fused columns) and return its `ModelLayout` (``param_axes``:
    {name: logical axes}, the model's own declarations when None).  A fused leaf cut by heads (B and C whole
    on every rank) is held to its axes as an even cut of its held width
    would be.  Raises ValueError where a leaf's split disagrees with its
    axes."""
    from repro_torch.nn.layers import param_axes as declared_axes
    axes = dict(param_axes if param_axes is not None
                else declared_axes(model))
    full = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if plan.model_axis:
        model.split_(plan.mesh.axes[MODEL_AXIS])
    params = dict(model.named_parameters())
    model_dims = {k: _split_dim(full[k], tuple(p.shape))
                  for k, p in params.items()}
    fused = _module_leaves(model, "fused_cuts")
    rules = plan.param_rules
    held = {k: axes[k] if model_dims[k] >= 0
            else _whole_over_model(axes[k], rules) for k in params}
    ctx = plan._ctx()

    def judged(k):  # the shape the spec is resolved against
        if k not in fused:
            return full[k]
        shape = list(full[k])
        shape[model_dims[k]] = params[k].shape[model_dims[k]] \
            * plan.model_size
        return tuple(shape)
    specs = {k: ctx.resolve(held[k], rules, shape=judged(k)) for k in params}
    for k, spec in specs.items():
        on_model = [i for i, e in enumerate(spec)
                    if MODEL_AXIS in (e if isinstance(e, tuple) else (e,))]
        if on_model != ([model_dims[k]] if model_dims[k] >= 0 else []):
            raise ValueError(f"{k}: split on dim {model_dims[k]} but its "
                             f"axes {held[k]} resolve to {spec}")
    return ModelLayout(plan, full, held, specs, model_dims,
                       {k: plan._spec_data_dim(s) for k, s in specs.items()},
                       fused=fused,
                       partial=tuple(_module_leaves(model, "read_in_part")))


def _place_params(plan: "MeshPlan", model, param_axes=None) -> ModelLayout:
    """`MeshPlan.place_params_`."""
    if getattr(model, "mesh_layout", None) is not None:
        raise ValueError("place_params_: the model is placed already")
    layout = model_layout(model, plan, param_axes)
    if not plan.zero_enabled():
        layout.data_dims = {k: -1 for k in layout.data_dims}
    axis = plan.data_axis
    for name, dim in layout.data_dims.items():
        if dim < 0:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = owner._parameters[leaf]
        with torch.no_grad():
            part = collectives.split_chunk(p.detach(), axis, dim).clone()
        owner._parameters[leaf] = torch.nn.Parameter(
            part, requires_grad=p.requires_grad)
        owner.fsdp_cut = dict(getattr(owner, "fsdp_cut", {}),
                              **{leaf: (dim, axis)})
    layout.fsdp = True
    model.mesh_layout = layout
    return layout


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split_flat(buf: torch.Tensor, like) -> list:
    out, start = [], 0
    for t in like:
        out.append(buf[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def make_plan(num_devices: Optional[int] = None, *, model_parallel: int = 1,
              pods: int = 1, param_rules: Mapping[str, Any] | None = None,
              act_rules: Mapping[str, Any] | None = None,
              device=None) -> MeshPlan:
    """Build the mesh and its MeshPlan in one call (the Trainer's
    entry); ``device`` is this rank's (CUDA unless given)."""
    return plan_for(make_mesh(num_devices, model_parallel=model_parallel,
                              pods=pods),
                    param_rules=param_rules, act_rules=act_rules,
                    device=device)


def plan_for(mesh: Mesh, *, param_rules=None, act_rules=None,
             device=None) -> MeshPlan:
    """Wrap an existing mesh in a MeshPlan."""
    return MeshPlan(mesh, dict(DEFAULT_PARAM_RULES, **(param_rules or {})),
                    dict(DEFAULT_ACT_RULES, **(act_rules or {})),
                    resolve_device(device))


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def _local_mean(loss_fn, graph_stack, labels):
    """Mean loss over this rank's local component groups."""
    groups = unstack_graph(graph_stack)
    total = 0.0
    for i, g in enumerate(groups):
        total = total + loss_fn(g, labels[i])
    return total / len(groups)


def make_train_step(plan: MeshPlan, loss_fn: Callable, optimizer, *,
                    num_groups: int, zero1: bool = True) -> Callable:
    """The 2-D training step.

    ``loss_fn(scalar_graph, group_labels) -> scalar`` over modules that
    own the parameters.  Returns ``(params, opt_state, graph_stack,
    labels) -> (params, opt_state, loss)``: ``params`` {name:
    nn.Parameter} replicated (`plan.replicate`), ``opt_state`` placed
    with `plan.place_opt_state`, ``graph_stack`` and ``labels`` this
    rank's block placed with `plan.put_super_batch`.  Per rank: the
    forward/backward over its groups with the ops' model-parallel
    gather boundaries, the gradient mean over every mesh axis, the
    ZeRO-1 update (each data rank updates its parameter slice with
    all-reduce-corrected clipping, then the slices are all-gathered),
    the new values written into the parameters."""
    dp = plan.data_size
    if num_groups % dp:
        raise ValueError(f"num_groups {num_groups} not divisible by "
                         f"{dp} data shards")
    zero = zero1 and plan.zero_enabled()
    world = plan.mesh.world

    def train_step(params, opt_state, graph_stack, labels):
        names = list(params)
        with plan.model_context():
            loss = _local_mean(loss_fn, graph_stack, labels)
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(names, grads))
        # over "data": the cross-replica mean; over "model": reassembles
        # the per-chunk cotangents the feature-split boundaries produce
        loss = collectives.all_reduce(loss.detach().reshape(1),
                                      world)[0] / world.size
        with torch.no_grad():
            current = {k: p.detach() for k, p in params.items()}
            if zero:
                dims = plan.zero_dims(plan.zero_param_specs(current))
                g_loc = plan.zero_reduce_grads(grads, dims)
                p_loc = plan.zero_slice(current, dims)
                p_new, opt_state, _ = optimizer.update(
                    g_loc, opt_state, p_loc, group=plan.data_axis,
                    shard_dims=dims)
                new = plan.zero_gather(p_new, dims)
            else:
                grads = plan.zero_reduce_grads(
                    grads, {k: -1 for k in names})
                new, opt_state, _ = optimizer.update(grads, opt_state,
                                                     current)
            for k, p in params.items():
                p.copy_(new[k])
        return params, opt_state, loss

    return train_step


def make_eval_step(plan: MeshPlan, metric_fn: Callable) -> Callable:
    """The 2-D eval step.  ``metric_fn(scalar_graph, group_labels)`` ->
    tuple of scalars; each is summed over this rank's groups and over
    the data axis (counts, not means — divide at the caller)."""

    def eval_step(graph_stack, labels):
        with torch.no_grad(), plan.model_context():
            totals = None
            for i, g in enumerate(unstack_graph(graph_stack)):
                out = metric_fn(g, labels[i])
                totals = out if totals is None else tuple(
                    a + b for a, b in zip(totals, out))
            # fp64: counts stay exact through the sum
            stacked = torch.stack([torch.as_tensor(t).to(torch.float64)
                                   .reshape(()) for t in totals])
            summed = collectives.all_reduce(stacked, plan.batch_axis)
        return tuple(summed[i] for i in range(len(totals)))

    return eval_step
