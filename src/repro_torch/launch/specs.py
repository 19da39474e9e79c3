"""Input specs and step factories for every (arch x shape) cell
(counterpart of `repro.launch.specs`).

`make_cell(arch, shape)` gives a `CellSpec`: the step function of the
cell and its inputs as meta tensors (shape and dtype, no memory) in the
places of the reference's ``ShapeDtypeStruct``s, with their logical
axes.  The parameter tree is the port's (per-layer names, ``blocks.3.…``;
`repro_torch.nn.layers.stack_groups` maps them onto the reference's
stacked leaves).  The dry run (`repro_torch.launch.dryrun`) builds the
same cell under fake tensors on rank 0 of a fake world, and
`cell_inputs` gives that rank's inputs.  Specs are made outside any
dispatch mode the caller runs, so the dry run's tally does not count
them.

The optimizer policy by model scale (`pick_optimizer`) and the cells'
sharding overrides are the reference's.  Under a plan, `make_cell`
applies a cell's overrides to both rule tables of its plan, as the
reference's dry run does (`repro/launch/dryrun.py:99-100`): with
``"seq": "model"`` the models cut the residual stream and the KV caches
by sequence over "model" where it divides them (`repro_torch.nn.
transformer`), and the dry run reports what stays unapplied (rwkv6's
and whisper's residual stream).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.partition import tree_bytes
from repro_torch.models.registry import build_model, get_config
from repro_torch.nn.layers import param_axes as module_param_axes
from repro_torch.nn.layers import stack_groups
from repro_torch.nn.transformer import torch_dtype
from repro_torch.train.optimizer import make_optimizer

# decoder sequence fraction for enc-dec training cells (models/whisper.py)
DEC_FRACTION = 4
WHISPER_DECODE_SELF_LEN = 1024
GIB = 1024 ** 3
# One NVIDIA H100 80GB HBM3: ``torch.cuda.mem_get_info()`` free bytes
# right after the CUDA context is made (of 85017493504 total; the
# context keeps the rest).  `chip_smoke.py` [dryrun] (d) holds it to the
# card it runs on.
HBM_PER_CARD = 84_462_993_408
# the microbatch memory model's allowance for attention / MoE transients
MICROBATCH_HEADROOM = int(1.5 * GIB)


class CellSpec(NamedTuple):
    """Everything needed to run one (arch x shape) cell.  ``model`` is
    the module the step runs (split over "model" under a plan)."""
    cfg: ArchConfig
    shape: ShapeConfig
    kind: str                     # train | prefill | decode
    fn: Callable                  # the step function
    args: tuple                   # meta-tensor trees
    arg_axes: tuple               # logical-axes trees (same structure)
    donate: tuple = ()            # arguments updated in place
    rule_overrides: dict = {}     # logical->mesh overrides of the cell
    model: Any = None
    plan: Any = None              # the plan with the overrides applied


# The reference's per-cell sharding overrides (`"seq" -> "model"`:
# sequence parallelism; the decode cells add it for their KV caches).
CELL_RULE_OVERRIDES: dict[tuple[str, str], dict] = {
    ("command-r-plus-104b", "train_4k"): {"seq": "model"},
    ("zamba2-1.2b", "train_4k"): {"seq": "model"},
    ("zamba2-1.2b", "prefill_32k"): {"seq": "model"},
}


def pick_optimizer(cfg: ArchConfig):
    """Optimizer policy by model scale: under 20 B parameters AdamW with
    fp32 moments; 20-100 B AdamW with bf16 moments; 100 B and up
    Adafactor (factored second moment).  The reference sized these
    classes for its TPU's memory; the policy is kept as it is."""
    n = cfg.param_count_estimate()
    if n >= 100e9:
        return make_optimizer("adafactor", 1e-4)
    if n >= 20e9:
        return make_optimizer("adamw", 3e-4, moment_dtype=torch.bfloat16)
    return make_optimizer("adamw", 3e-4)


def _meta(shape, dtype) -> torch.Tensor:
    """A spec: a meta tensor made outside any dispatch mode the caller
    runs (the dry run's tally counts the rank's tensors, not specs)."""
    with _disable_current_modes():
        return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch_specs(cfg: ArchConfig, batch: int, seq: int):
    """(specs, axes) for a training batch."""
    dtype = torch_dtype(cfg.compute_dtype)
    i32 = torch.int32
    if cfg.family == "audio":
        dec = max(seq // DEC_FRACTION, 8)
        specs = {"audio_embeds": _meta((batch, seq, cfg.d_model), dtype),
                 "tokens": _meta((batch, dec), i32),
                 "labels": _meta((batch, dec), i32)}
        axes = {"audio_embeds": ("batch", None, None),
                "tokens": ("batch", None), "labels": ("batch", None)}
    elif cfg.family == "vlm":
        p = cfg.num_patches
        toks = max(seq - p, 8)
        specs = {"patch_embeds": _meta((batch, p, cfg.d_model), dtype),
                 "tokens": _meta((batch, toks), i32),
                 "labels": _meta((batch, toks), i32)}
        axes = {"patch_embeds": ("batch", None, None),
                "tokens": ("batch", None), "labels": ("batch", None)}
    else:
        specs = {"tokens": _meta((batch, seq), i32),
                 "labels": _meta((batch, seq), i32)}
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    return specs, axes


def _cast_params(model, cfg: ArchConfig):
    """The floating parameters in the config's ``param_dtype``, in place
    (as `repro_torch.launch.train` holds them)."""
    pdt = torch_dtype(cfg.param_dtype)
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != pdt:
                p.data = p.data.to(pdt)
    return model


def _params_specs(model):
    """({name: meta tensor}, {name: logical axes}) of `model`'s
    parameters as they stand (shape and dtype)."""
    vals = {k: _meta(p.shape, p.dtype)
            for k, p in model.named_parameters()}
    return vals, module_param_axes(model)


def microbatch_terms(cfg: ArchConfig, shape: ShapeConfig, n: int,
                     dp_shards: int = 16, seq_chunk: int = 512) -> dict:
    """The reference's memory model of one microbatch a device (depth
    `n`), in bytes: the saved layer carries (L x tokens x d_model x 4 B),
    the chunked CE's logits and cotangent (2 x B x chunk x vocab x 4 B),
    and the headroom for attention / MoE transients."""
    b = max(1, shape.global_batch // dp_shards) // n
    toks = b * shape.seq_len
    layers = (cfg.enc_layers + cfg.dec_layers if cfg.family == "audio"
              else cfg.num_layers)
    return {"stack": layers * toks * cfg.d_model * 4,
            "ce": 2 * b * min(seq_chunk, shape.seq_len) * cfg.vocab_size * 4,
            "headroom": MICROBATCH_HEADROOM}


def auto_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                      dp_shards: int = 16, seq_chunk: int = 512, *,
                      state_bytes: int = 0) -> int:
    """The gradient-accumulation depth (a power of two) whose microbatch
    fits the budget by `microbatch_terms`: one card's memory
    (`HBM_PER_CARD`) less `state_bytes`, the rank's parameter, gradient
    and optimizer bytes."""
    budget = HBM_PER_CARD - state_bytes
    b_dev = max(1, shape.global_batch // dp_shards)
    n = 1
    while n < b_dev:
        terms = microbatch_terms(cfg, shape, n, dp_shards, seq_chunk)
        if sum(terms.values()) <= budget:
            break
        n *= 2
    return n


def train_state_bytes(params: dict, optimizer) -> dict:
    """Bytes a rank holds between steps: its parameters as it holds
    them (under a plan, its slices), their gradients (the parameter
    dtype) and the optimizer state over them, counted on meta copies."""
    meta = {k: _meta(p.shape, p.dtype) for k, p in params.items()}
    with _disable_current_modes():
        state = optimizer.init(meta, stack_groups(meta))
    pb = tree_bytes(meta)
    return {"params": pb, "grads": pb, "opt": tree_bytes(state)}


def _place(model, plan) -> None:
    """A cell's model placed on the plan's mesh as the reference's
    ``run_cell`` places every cell's parameters
    (`MeshPlan.place_params_`): split over "model" (every family's
    ``split_``) and cut over "data" (FSDP), gathered a layer at use."""
    if plan is not None:
        plan.place_params_(model)


def _splits_rows(plan, rows: int) -> bool:
    """Whether a batch of `rows` splits over the plan's data ranks; one
    that does not stays whole on every rank, as the reference constrains
    a batch leaf only where its rows divide."""
    return plan is not None and plan.data_size > 1 \
        and rows % plan.data_size == 0


def _rank_rows(plan, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a global batch leaf."""
    if not _splits_rows(plan, x.shape[0]):
        return x
    return collectives.split_chunk(x, plan.batch_axis, 0)


def _plan_context(plan):
    """The plan's sharding context (a null one without a plan)."""
    import contextlib
    from repro_torch.distributed.sharding import use_sharding
    if plan is None:
        return contextlib.nullcontext()
    return use_sharding(plan.mesh, plan.param_rules, plan.act_rules)


def _under_plan(plan, fn: Callable) -> Callable:
    """`fn` under the plan's sharding context (the MoE layers read the
    data-parallel ranks from it, the models the ``"seq"`` rule), without
    autograd."""
    def run(*args):
        with torch.no_grad(), _plan_context(plan):
            return fn(*args)
    return run


def with_overrides(plan, overrides: dict):
    """`plan` with a cell's rule overrides in both of its tables (the
    plan itself where there are none)."""
    if plan is None or not overrides:
        return plan
    import dataclasses
    return dataclasses.replace(
        plan, param_rules=dict(plan.param_rules, **overrides),
        act_rules=dict(plan.act_rules, **overrides))


def make_cell(arch: str, shape_name, *, n_microbatches: int | None = None,
              plan=None) -> CellSpec:
    """The cell's step and inputs.  Without a plan the step is the
    one-device step (its microbatch budget counts the whole model's
    state on one card); with one (a `repro_torch.distributed.partition.
    MeshPlan`) the cell's rule overrides go into both of its tables
    (`with_overrides`; the cell's ``plan``), every cell's model is
    placed as the reference's ``run_cell`` places it (`_place`: split
    over "model", cut over "data"), the train step is `MeshTrainStep`
    over those slices, and a serving cell's step runs on the rank's
    block of the batch.  The model is built on the meta device (no
    memory), and the args are meta tensors of the global shapes."""
    from repro_torch.train.train_loop import make_train_step
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if not cfg.supports_shape(shape.name):
        raise ValueError(f"{arch} does not support {shape.name} "
                         "(full attention at 500k) — documented skip")
    model = _cast_params(build_model(cfg, "meta"), cfg)
    param_specs, param_axes = _params_specs(model)
    overrides = CELL_RULE_OVERRIDES.get((arch, shape.name), {})
    if shape.kind == "decode":
        overrides = dict({"seq": "model"}, **overrides)
    plan = with_overrides(plan, overrides)

    if shape.kind == "train":
        opt = pick_optimizer(cfg)
        groups = stack_groups(param_specs)
        with _disable_current_modes():
            opt_state_specs = opt.init(param_specs, groups)
        opt_axes = opt.state_axes(param_axes, groups)
        batch_specs, batch_axes = _token_batch_specs(
            cfg, shape.global_batch, shape.seq_len)
        if plan is not None:
            # places the model in place; the depth is set below
            _place(model, plan)
            step = make_train_step(model, cfg, opt, plan=plan, zero1=True)
        if n_microbatches is None:
            # the rank's parameters are its slices already
            state = train_state_bytes(dict(model.named_parameters()), opt)
            n_microbatches = auto_microbatches(
                cfg, shape, plan.data_size if plan is not None else 16,
                state_bytes=sum(state.values()))
        if plan is not None:
            step.n_microbatches = n_microbatches
        else:
            step = make_train_step(model, cfg, opt,
                                   n_microbatches=n_microbatches)
        return CellSpec(cfg, shape, "train", step,
                        (param_specs, opt_state_specs, batch_specs),
                        (param_axes, opt_axes, batch_axes),
                        donate=(0, 1), rule_overrides=overrides,
                        model=model, plan=plan)

    if shape.kind == "prefill":
        batch_specs, batch_axes = _token_batch_specs(
            cfg, shape.global_batch, shape.seq_len)
        _place(model, plan)
        if cfg.family == "audio":
            # encode full frames; decoder prefill of a short prompt
            def prefill_fn(params, batch):
                out, cache = model.prefill(
                    _rank_rows(plan, batch["tokens"][:, :8]),
                    max_len=WHISPER_DECODE_SELF_LEN,
                    audio_embeds=_rank_rows(plan, batch["audio_embeds"]))
                return out.logits, cache
        else:
            def prefill_fn(params, batch):
                extras = {k: _rank_rows(plan, batch[k])
                          for k in ("patch_embeds",) if k in batch}
                out, cache = model.prefill(_rank_rows(plan, batch["tokens"]),
                                           max_len=shape.seq_len, **extras)
                return out.logits, cache
        return CellSpec(cfg, shape, "prefill", _under_plan(plan, prefill_fn),
                        (param_specs, batch_specs),
                        (param_axes, batch_axes),
                        rule_overrides=overrides, model=model, plan=plan)

    # decode: one new token against a seq_len-deep cache
    b = shape.global_batch
    with _disable_current_modes():
        meta_model = _cast_params(build_model(cfg, "meta"), cfg)
        cache_spec = _init_cache(meta_model, cfg, shape, b)
    _place(model, plan)
    tok_spec = _meta((b, 1), torch.int32)

    def decode_fn(params, tokens, cache):
        out, new_cache = model.decode_step(_rank_rows(plan, tokens), cache)
        return out.logits, new_cache

    return CellSpec(cfg, shape, "decode", _under_plan(plan, decode_fn),
                    (param_specs, tok_spec, cache_spec),
                    (param_axes, ("batch", None), model.cache_axes()),
                    donate=(2,), rule_overrides=overrides, model=model,
                    plan=plan)


def _init_cache(model, cfg: ArchConfig, shape: ShapeConfig, batch: int):
    """A decode cell's cache for `batch` sequences, as the reference
    sizes it (Whisper: a 1024-token decoder over the cell's frames; an
    SSM: its O(1) state)."""
    if cfg.family == "audio":
        return model.init_cache(batch, WHISPER_DECODE_SELF_LEN,
                                enc_len=shape.seq_len)
    if cfg.family == "ssm":
        return model.init_cache(batch)
    return model.init_cache(batch, shape.seq_len)


def cell_inputs(cell: CellSpec, plan=None) -> tuple:
    """This rank's inputs to ``cell.fn``, meta tensors: the model's
    own parameters (its slices); for a train cell the optimizer state
    over them and the global batch (the step takes its block); for a
    prefill the global batch; for a decode the global tokens and a cache
    of the rank's rows, cut as the cell's plan cuts it (by sequence
    under its ``"seq"`` override, else by the rank's kv heads; the SSM
    states by the rank's heads).
    `plan` is the cell's (``cell.plan``) unless given."""
    plan = cell.plan if plan is None else plan
    params = dict(cell.model.named_parameters())

    def zeros(tree):
        return {k: torch.zeros(v.shape, dtype=v.dtype, device="meta")
                for k, v in tree.items()}

    if cell.kind == "train":
        if hasattr(cell.fn, "init_opt_state"):   # MeshTrainStep
            state = cell.fn.init_opt_state(params)
        else:
            state = pick_optimizer(cell.cfg).init(params,
                                                  stack_groups(params))
        return params, state, zeros(cell.args[2])
    if cell.kind == "prefill":
        return params, zeros(cell.args[1])
    rows = cell.shape.global_batch
    if _splits_rows(plan, rows):
        rows //= plan.data_size
    tokens = torch.zeros(cell.args[1].shape, dtype=cell.args[1].dtype,
                         device="meta")
    with _plan_context(plan):
        cache = _init_cache(cell.model, cell.cfg, cell.shape, rows)
    return params, tokens, cache


def input_specs(arch: str, shape_name: str):
    """The meta-tensor stand-ins for a cell's inputs."""
    return make_cell(arch, shape_name).args
