"""What each rank of the port's LM mesh tests runs (imported by name in
the spawned rank processes, so it imports torch and `repro_torch`
only, never JAX).

`CASES` are the four runs of `tests/test_torch_lm_mesh.py`, each the
reference's ``make_train_step(plan=, zero1=True)`` on a (data=2,
model=2) mesh for `STEPS` steps at an arch's ``-smoke`` config; the JAX
subprocess of that file runs the same table.  Parameter trees travel as
``{dotted key path: array}`` of the reference's (stacked) tree.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

STEPS = 3
CASES = {
    # AdamW, two microbatches, a loss mask whose counts differ between
    # the data halves of each microbatch
    "qwen": dict(arch="qwen1.5-4b", opt="adamw", n_micro=2, batch=4,
                 seq=32, mask=True),
    # capacity factor 0.5: 32 tokens a group, capacity 8, so tokens drop
    "granite": dict(arch="granite-moe-3b-a800m", opt="adamw", n_micro=1,
                    batch=4, seq=128, capacity_factor=0.5),
    # pick_optimizer's Adafactor (the full config's, >= 100B)
    "command_r": dict(arch="command-r-plus-104b", opt="pick", n_micro=1,
                      batch=4, seq=32),
    # the attention-free family, split by heads (time mix) and hidden
    # width (channel mix) over "model", ZeRO-1 over "data"
    "rwkv": dict(arch="rwkv6-3b", opt="adamw", n_micro=1, batch=4, seq=32),
}
LR = 1e-4


def config(module, case: dict):
    """The case's smoke config from a registry module (the reference's
    or the port's): its ``remat``, ``heads`` (query heads, and kv heads
    unless ``kv_heads`` is given), ``d_model``, ``experts`` and
    ``capacity_factor`` override the config's."""
    cfg = module.get_config(case["arch"] + "-smoke")
    if "remat" in case:
        cfg = dataclasses.replace(cfg, remat=case["remat"])
    if "heads" in case:
        cfg = dataclasses.replace(cfg, n_heads=case["heads"],
                                  n_kv_heads=case.get("kv_heads",
                                                      case["heads"]))
    if "d_model" in case:
        cfg = dataclasses.replace(cfg, d_model=case["d_model"])
    if "experts" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=case["experts"]))
    if "capacity_factor" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    return cfg


def zero_grad_leaves(names) -> list:
    """The leaves whose true gradient is zero, by rule: the key bias of
    every attention (``wk.b``: ``q . b_k`` shifts a row of logits
    alike, which the softmax does not see).  Their gradient is rounding,
    which Adam turns into steps of up to the learning rate with the
    rounding's sign, so two correct runs part by up to ``steps x lr``
    there."""
    return sorted(k for k in names if k.endswith("wk.b"))


def batch_np(cfg, case: dict, seed: int = 0) -> dict:
    """Tokens and labels (and the case's uneven loss mask; an audio
    model's frame embeddings, ``frames`` of them, from their own
    generator)."""
    rng = np.random.default_rng(seed)
    b, s = case["batch"], case["seq"]
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if case.get("mask"):
        mask = np.ones((b, s), np.float32)
        mask[1, s // 4:] = 0.0   # microbatch 0's second data half
        mask[2, : s // 2] = 0.0  # microbatch 1's first data half
        out["loss_mask"] = mask
    if cfg.family == "audio":
        out["audio_embeds"] = np.random.default_rng(seed + 1).standard_normal(
            (b, case["frames"], cfg.d_model)).astype(np.float32)
    return out


def nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def case_optimizer(module, case: dict):
    """The case's ``opt`` ("adamw" or "adafactor") at its rate from an
    optimizer module (the reference's or the port's)."""
    kind = {"adamw": module.AdamW, "adafactor": module.Adafactor}
    return kind[case["opt"]](learning_rate=case.get("lr", LR))


def optimizer(case: dict):
    from repro_torch.launch.specs import pick_optimizer
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt
    if case["opt"] == "pick":
        return pick_optimizer(registry.get_config(case["arch"]))
    return case_optimizer(opt, case)


def train_case(case: dict, initial: dict, *, model_parallel: int = 2,
               mesh: bool = True, steps: int = STEPS,
               device: str = "cpu", pods: int = 1,
               placed: bool = False, act_rules=None) -> dict:
    """The case on this rank's mesh (led by `pods` pods; or, with
    ``mesh=False``, the one-device step) from the reference's initial
    tree, on `device` (fp32, TF32 off): per-step metrics, the whole final parameters as the
    reference's flat tree, the bytes this rank holds of parameters and
    of optimizer state.  ``placed``: the parameters placed first
    (`MeshPlan.place_params_`, FSDP over "data"); ``act_rules``: the
    plan's activation rules over the defaults (``SEQ_RULES``: sequence
    parallelism); the case's ``remat`` overrides the config's."""
    from repro_torch.distributed import partition
    from repro_torch.distributed.partition import tree_bytes
    from repro_torch.models import registry
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(registry, case)
    model = layers.load_jax_lm_params(registry.build_model(cfg, device),
                                      nest(initial))
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    opt = optimizer(case)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_np(cfg, case).items()}
    if mesh:
        plan = partition.make_plan(model_parallel=model_parallel,
                                   pods=pods, device=device,
                                   act_rules=act_rules)
        if placed:
            plan.place_params_(model)
        step = train_loop.make_train_step(
            model, cfg, opt, plan=plan, zero1=True,
            n_microbatches=case["n_micro"])
        params = dict(model.named_parameters())
        state = step.init_opt_state(params)
    else:
        step = train_loop.make_train_step(model, cfg, opt,
                                          n_microbatches=case["n_micro"])
        params = dict(model.named_parameters())
        state = opt.init(params, layers.stack_groups(params))
    metrics = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    full = step.gather_params(params) if mesh else params
    return {"metrics": metrics,
            "params": flatten(layers.stack_lm_tree(full)),
            "param_bytes": tree_bytes({k: p.detach()
                                       for k, p in params.items()}),
            "opt_bytes": tree_bytes(state),
            "whole_leaves": sorted(k for k, p in params.items()
                                   if tuple(p.shape) == whole[k])}


def train_cases(names: list, initial: dict) -> dict:
    """Every named case in this world, one after another."""
    return {n: train_case(CASES[n], initial[n]) for n in names}


# the optimizer on both axes: a tree cut over "data" (ZeRO-1) and over
# "model" (tensor parallelism), dims per leaf (-1 = whole)
PIECE_SHAPES = {"w": (8, 6), "b": (6,), "blocks.0.k": (4, 6),
                "blocks.1.k": (4, 6), "e": (4, 8, 6), "n": (4,),
                "blocks.0.s": (8,), "blocks.1.s": (8,)}
PIECE_DATA = {"w": 0, "b": -1, "blocks.0.k": 0, "blocks.1.k": 0, "e": 1,
              "n": -1, "blocks.0.s": 0, "blocks.1.s": 0}
PIECE_MODEL = {"w": 1, "b": 0, "blocks.0.k": 1, "blocks.1.k": 1, "e": 0,
               "n": 0, "blocks.0.s": -1, "blocks.1.s": -1}
# leaves fused on their model dim as Mamba2's in_proj and conv bias are:
# (dim, pieces of (width, cut over "model")), the uncut piece held alike
# by every model rank (`ModelLayout.dup`); a 2-D one cut over "data" on
# its rows, and a layer stack of 1-D ones (2-D once stacked)
FUSED = ((4, True), (2, False), (4, True))
PIECE_SHAPES.update({"f": (8, 10), "blocks.0.c": (10,), "blocks.1.c": (10,)})
PIECE_DATA.update({"f": 0, "blocks.0.c": -1, "blocks.1.c": -1})
PIECE_MODEL.update({"f": 1, "blocks.0.c": 0, "blocks.1.c": 0})
PIECE_FUSED = {"f": (1, FUSED), "blocks.0.c": (0, FUSED),
               "blocks.1.c": (0, FUSED)}
PIECE_DUP = {k: (dim, [(2, 4)]) for k, (dim, _) in PIECE_FUSED.items()}


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.asarray(
        scale * np.random.default_rng(seed).standard_normal(shape),
        np.float32))


def optimizer_pieces() -> dict:
    """Three Adafactor updates and one global norm on this rank's slices
    of `PIECE_SHAPES` (cut over both axes of a (data=2, model=2) mesh;
    the `PIECE_FUSED` leaves by their pieces, the alike ranges
    `PIECE_DUP`), against the same on the whole tree; returns both, this
    rank's slices of the whole result beside its own."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.nn.layers import stack_groups
    from repro_torch.train import optimizer as opt
    plan = partition.make_plan(model_parallel=2, device="cpu")
    data, model = plan.data_axis, plan.mesh.axes["model"]

    def mine(tree):
        out = {}
        for k, x in tree.items():
            if k in PIECE_FUSED:
                x = collectives.fused_slice(x, *PIECE_FUSED[k], model)
            for axis, dims in ((data, PIECE_DATA), (model, PIECE_MODEL)):
                if dims[k] >= 0 and not (axis is model and k in PIECE_FUSED):
                    x = collectives.split_chunk(x, axis, dims[k])
            out[k] = x.clone()
        return out

    ada = opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    full = {k: _normal(s, i) for i, (k, s) in enumerate(PIECE_SHAPES.items())}
    part = mine(full)
    groups = stack_groups(full)
    s_full, s_part = ada.init(full, groups), ada.init(part, groups)
    kw = dict(group=data, shard_dims=PIECE_DATA, model=model,
              model_dims=PIECE_MODEL, groups=groups, model_dup=PIECE_DUP)
    for step in range(3):
        grads = {k: _normal(s, 50 + 10 * step + i, 0.5)
                 for i, (k, s) in enumerate(PIECE_SHAPES.items())}
        full, s_full, _ = ada.update(grads, s_full, full, groups=groups)
        part, s_part, _ = ada.update(mine(grads), s_part, part, **kw)
    norm = opt.global_norm(mine(grads), group=data, shard_dims=PIECE_DATA,
                           model=model, model_dims=PIECE_MODEL,
                           model_dup=PIECE_DUP)
    return {"params": ({k: v.numpy() for k, v in part.items()},
                       {k: v.numpy() for k, v in mine(full).items()}),
            "norm": (float(norm), float(opt.global_norm(grads)))}


def lm_mesh_world(names: list, initial: dict,
                  compress_ref: dict | None = None) -> dict:
    """What a rank of the 4-rank world of `tests/test_torch_lm_mesh.py`
    returns: every named case trained, and the optimizer pieces; with
    `compress_ref` ({piece name: the reference's compressed trees}), the
    compressed step of every `COMPRESS_CASES` case (from the qwen case's
    initial parameters) and the compressor on every piece's slices."""
    out = train_cases(names, initial)
    out["pieces"] = optimizer_pieces()
    if compress_ref is not None:
        out["compress"] = {n: compress_case(c, initial["qwen"])
                           for n, c in COMPRESS_CASES.items()}
        out["compress_pieces"] = {n: compress_pieces_case(n, ref)
                                  for n, ref in compress_ref.items()}
    return out


def pipeline_rank(ws: np.ndarray, x: np.ndarray, n_microbatches: int,
                  stages: int, ct: np.ndarray | None = None) -> dict:
    """`pipeline_apply` of the reference's test body (``tanh(h @ w)``)
    over a "stage" mesh of this world's ranks, and with `ct` the
    gradient of ``sum(out * ct)`` in ``ws`` (this stage's slice) and
    ``x``; then a DecoderBlock stage a rank (qwen1.5-4b-smoke, fp32)
    against the blocks in sequence (a microbatch at a time, and whole in
    float64 for the judge): the output, its gradient in the input and in
    this stage's block for a seeded cotangent, and the output again
    under `torch.no_grad()`."""
    from repro_torch.distributed import partition
    from repro_torch.distributed.pipeline_parallel import (pipeline_apply,
                                                           stage_layers)
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.nn.transformer import DecoderBlock
    mesh = partition.make_mesh(stages=stages)
    stage = mesh.axes["stage"].index
    fn = pipeline_apply(lambda w, h: torch.tanh(h @ w), mesh,
                        n_microbatches=n_microbatches)
    ws_t = torch.from_numpy(ws).requires_grad_(ct is not None)
    x_t = torch.from_numpy(x).requires_grad_(ct is not None)
    out = fn(stage_layers(ws_t, mesh), x_t)
    grads = None
    if ct is not None:
        (out * torch.from_numpy(ct)).sum().backward()
        width = len(ws) // stages
        rows = slice(stage * width, (stage + 1) * width)
        grads = {"ws": ws_t.grad[rows].numpy(), "x": x_t.grad.numpy(),
                 "ws_rest": float(ws_t.grad.abs().sum()
                                  - ws_t.grad[rows].abs().sum())}

    cfg = registry.get_config("qwen1.5-4b-smoke")
    blocks = [init_params(DecoderBlock(cfg), 10 + i) for i in range(stages)]
    rng = np.random.default_rng(5)
    h_np = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    ct_b = torch.from_numpy(rng.standard_normal(h_np.shape).astype(
        np.float32))
    run = pipeline_apply(lambda block, y: block(y)[0], mesh,
                         n_microbatches=4)
    h = torch.from_numpy(h_np).requires_grad_(True)
    got = run(stage_layers(blocks, mesh), h)
    requires_grad = got.requires_grad
    (got * ct_b).sum().backward()
    mine = blocks[stage]
    got_grads = {k: p.grad.numpy() for k, p in mine.named_parameters()}
    with torch.no_grad():
        quiet = run(stage_layers(blocks, mesh), h)
    # the blocks in sequence a microbatch (row) at a time: the pipeline's
    # products, so a gradient differs from it only in the order its
    # microbatches' parts are summed
    h2 = torch.from_numpy(h_np).requires_grad_(True)
    want = []
    for row in h2.split(1):
        for block in blocks:
            row = block(row)[0]
        want.append(row)
    want = torch.cat(want)
    names = [k for k, _ in mine.named_parameters()]
    found = torch.autograd.grad((want * ct_b).sum(),
                                [h2] + list(mine.parameters()))
    # the judge of an element that misses: the sequence in float64
    wide = [copy.deepcopy(block).double() for block in blocks]
    h64 = torch.from_numpy(h_np).double().requires_grad_(True)
    y64 = h64
    for block in wide:
        y64 = block(y64)[0]
    exact = torch.autograd.grad((y64 * ct_b.double()).sum(),
                                [h64] + list(wide[stage].parameters()))
    return {"mesh": (mesh.axis_names, dict(mesh.shape),
                     mesh.axes["stage"].ranks),
            "out": out.detach().numpy(), "grads": grads,
            "blocks": (got.detach().numpy(), want.detach().numpy()),
            "block_grads": ({"x": h.grad.numpy(), **got_grads},
                            {"x": found[0].numpy(),
                             **{k: g.numpy() for k, g in zip(names,
                                                             found[1:])}}),
            "block_grads64": {"x": exact[0].numpy(),
                              **{k: g.numpy() for k, g in zip(names,
                                                              exact[1:])}},
            "quiet": (quiet.numpy(), quiet.requires_grad),
            "requires_grad": requires_grad}


# ---------------------------------------------------------------------------
# FSDP: the step over parameters placed by `MeshPlan.place_params_`
# (`tests/test_torch_lm_fsdp.py`)
# ---------------------------------------------------------------------------

FSDP_CASES = {
    # AdamW, two microbatches, the uneven loss mask; remat "layer"
    "qwen": CASES["qwen"],
    # remat "dots" (the config's), capacity factor 0.5: drops
    "granite": CASES["granite"],
    # remat "none": what autograd saves of a gathered weight is regathered
    "qwen_none": dict(CASES["qwen"], remat="none"),
}
# the MoE layer at (pod=2, data=2, model=1) with 2 groups: each group
# spans two batch ranks
MOE_PODS = dict(dim=32, hidden=48, n_experts=4, top_k=2,
                capacity_factor=1.0, n_groups=2, batch=4, seq=8)


def placed_step(case: dict, initial: dict):
    """(model, cfg, plan, step, params, batch): the case's model from the
    reference's initial tree placed on this rank's (data=2, model=2)
    plan, and its mesh step."""
    from repro_torch.distributed import partition
    from repro_torch.models import registry
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    cfg = config(registry, case)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      nest(initial))
    plan = partition.make_plan(model_parallel=2, device="cpu")
    plan.place_params_(model)
    step = train_loop.make_train_step(model, cfg, optimizer(case),
                                      plan=plan, zero1=True,
                                      n_microbatches=case["n_micro"])
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, case).items()}
    return model, cfg, plan, step, dict(model.named_parameters()), batch


def fsdp_grads(case: dict, initial: dict) -> dict:
    """The step's gradient at the initial parameters on this rank's
    placed plan (the microbatches' mean, summed over the mesh, every
    leaf whole) as the reference's flat tree."""
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    _, _, plan, step, params, batch = placed_step(case, initial)
    with use_sharding(plan.mesh, plan.param_rules, plan.act_rules):
        train_loop._backward_metrics(step.loss_fn, step._microbatches(batch))
    grads = train_loop._gradients(params, case["n_micro"])
    with torch.no_grad():
        grads = plan.zero_reduce_grads(grads, step.data_dims, mean=False,
                                       sliced=True)
    return flatten(layers.stack_lm_tree(step.gather_params(grads)))


def fsdp_liveness(case: dict, initial: dict) -> dict:
    """One placed step with every whole tensor gathered watched
    (`fsdp.observers`): the bytes of them alive when each microbatch's
    forward returns, the most alive at once, and the largest unit a
    forward gathers at once (a layer, or the embedding table, the
    final norm and the head)."""
    import weakref
    from repro_torch.distributed import fsdp
    from repro_torch.nn.layers import LAYER_STACKS
    model, _, plan, step, params, batch = placed_step(case, initial)
    refs, most = [], [0]

    def alive() -> int:
        return sum(n for r, n in refs if r() is not None)

    def seen(t):
        refs.append((weakref.ref(t), t.numel() * t.element_size()))
        most[0] = max(most[0], alive())

    after_forward = []
    loss_fn = step.loss_fn

    def watched(mb):
        out = loss_fn(mb)
        after_forward.append(alive())
        return out

    def unit_bytes(module) -> int:
        return sum(p.numel() * p.element_size() * axis.size
                   for mod, name, _, axis in fsdp.cut_leaves(module)
                   for p in [mod._parameters[name]])

    units = [unit_bytes(block) for key in LAYER_STACKS
             for block in getattr(model, key, [])]
    stacks = {id(b) for key in LAYER_STACKS
              for b in getattr(model, key, [])}
    units.append(sum(unit_bytes(m) for m in model.children()
                     if id(m) not in stacks
                     and not isinstance(m, torch.nn.ModuleList)))
    step.loss_fn = watched
    fsdp.observers.append(seen)
    try:
        state = step.init_opt_state(params)
        step(params, state, batch)
    finally:
        fsdp.observers.remove(seen)
    return {"after_forward": after_forward, "most": most[0],
            "largest_unit": max(units), "gathers": len(refs)}


def fsdp_case(case: dict, initial: dict) -> dict:
    """`train_case` on the placed plan, its gradient at the start and
    the liveness of what it gathers."""
    out = train_case(case, initial, placed=True)
    out["grads"] = fsdp_grads(case, initial)
    out["liveness"] = fsdp_liveness(case, initial)
    return out


def gather_pieces(dim: int, size: int = 2) -> tuple:
    """(slices, weights) of every rank of a data line of `size`, from a
    seed: slice ``r`` is [3, 4] (cut on `dim` of the whole), weight ``r``
    the whole's shape."""
    rng = np.random.default_rng(11 + dim)
    shape = [3, 4]
    whole = list(shape)
    whole[dim] *= size
    return ([rng.standard_normal(shape).astype(np.float32)
             for _ in range(size)],
            [rng.standard_normal(whole).astype(np.float32)
             for _ in range(size)])


def gather_at_use_case() -> dict:
    """`collectives.gather_at_use` on this rank's data line, on dims 0
    and 1: the whole it gives, and its slice's gradient of
    ``sum(whole * weight_r)`` (rank ``r``'s own weight)."""
    from repro_torch.distributed import collectives, partition
    plan = partition.make_plan(model_parallel=2, device="cpu")
    axis = plan.data_axis
    out = {"index": axis.index}
    for dim in (0, 1):
        parts, weights = gather_pieces(dim, axis.size)
        x = torch.from_numpy(parts[axis.index]).requires_grad_(True)
        y = collectives.gather_at_use(x, axis, dim)
        (y * torch.from_numpy(weights[axis.index])).sum().backward()
        out[dim] = (y.detach().numpy(), x.grad.numpy())
    return out


def moe_pods_inputs() -> dict:
    c = MOE_PODS
    rng = np.random.default_rng(21)
    shape = (c["batch"], c["seq"], c["dim"])
    return {"x": rng.standard_normal(shape).astype(np.float32),
            "r": rng.standard_normal(shape).astype(np.float32)}


def moe_pods_case(tree: dict) -> dict:
    """`MOE_PODS`' layer from the reference's tree on this rank's rows of
    a (pod=2, data=2, model=1) mesh: its output, the auxiliary values,
    the rows' input gradient and the parameters' gradient summed over
    the batch ranks, of ``sum(y * r) + lb + z``."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.nn.layers import load_jax_params
    from repro_torch.nn.moe import MoELayer
    c = MOE_PODS
    layer = load_jax_params(MoELayer(
        c["dim"], c["hidden"], c["n_experts"], c["top_k"],
        capacity_factor=c["capacity_factor"], n_groups=c["n_groups"]),
        nest(tree))
    plan = partition.make_plan(pods=2, device="cpu")
    axis = plan.batch_axis
    inputs = {k: collectives.split_chunk(torch.from_numpy(v), axis, 0)
              for k, v in moe_pods_inputs().items()}
    x = inputs["x"].requires_grad_(True)
    with use_sharding(plan.mesh, plan.param_rules, plan.act_rules):
        y, aux = layer(x)
    loss = (y * inputs["r"]).sum() + aux.load_balance_loss \
        + aux.router_z_loss
    loss.backward()
    grads = {k: collectives.all_reduce(p.grad, axis).numpy()
             for k, p in layer.named_parameters()}
    return {"index": axis.index, "y": y.detach().numpy(),
            "aux": [float(a) for a in aux], "x_grad": x.grad.numpy(),
            "grads": grads}


def fsdp_world(initial: dict, moe_tree: dict) -> dict:
    """What a rank of the 4-rank world of `tests/test_torch_lm_fsdp.py`
    returns: every FSDP case, the gather Function, the placed serving
    cases and the MoE over pods."""
    import torch_launch_ranks as L
    out = {name: fsdp_case(case, initial[name])
           for name, case in FSDP_CASES.items()}
    out["gather"] = gather_at_use_case()
    out["serve"] = {name: L.serve_case(arch, initial["serve/" + name],
                                       placed=True)
                    for name, arch in L.SERVE_CASES.items()}
    out["moe_pods"] = moe_pods_case(moe_tree)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: the plan's act rule "seq" -> "model"
# (`tests/test_torch_lm_seq.py`)
# ---------------------------------------------------------------------------

SEQ_RULES = {"seq": "model"}
SEQ_CASES = {
    # the parallel block, LayerNorm, tied embeddings, Adafactor
    "command_r": dict(CASES["command_r"], remat="layer"),
    # the MoE under the cut (capacity factor 0.5: drops), remat "dots"
    "granite": dict(CASES["granite"], remat="dots"),
    # 5 heads on a model axis of 2: attention whole, the MLP split; two
    # microbatches and the uneven mask
    "heads5": dict(CASES["qwen"], heads=5),
    # the hybrid family, whole over "model"
    "zamba": dict(arch="zamba2-1.2b", opt="adamw", n_micro=1, batch=4,
                  seq=32),
    # the attention-free family, its time mix split by heads (4 over 2):
    # the token shifts and the wkv recurrence over the gathered sequence
    "rwkv": dict(CASES["rwkv"]),
    # 3 heads of 32 over 2: the time mix by value columns, its weights
    # cut at rest, its ``o`` parts reduce-scattered along the sequence
    "rwkv_uneven": dict(arch="rwkv6-3b", opt="adamw", n_micro=1, batch=4,
                        seq=32, d_model=96),
    # the encoder's frames and the decoder's tokens both cut, the cross
    # K/V over the gathered frames; its key biases held as in
    # `zero_grad_leaves`
    "whisper": dict(arch="whisper-medium", opt="adamw", n_micro=1, batch=4,
                    seq=32, frames=32),
}
# prefill and greedy decode with the caches cut by sequence (rwkv6's
# state has no sequence dim: its prefill's residual is cut)
SEQ_SERVE = {"qwen": "qwen1.5-4b", "granite": "granite-moe-3b-a800m",
             "phi": "phi-3-vision-4.2b", "zamba": "zamba2-1.2b",
             "whisper": "whisper-medium", "rwkv": "rwkv6-3b"}
SEQ_FRAMES = 32   # whisper's encoder frames
# the liveness runs: (arch, remat)
SEQ_LIVENESS = {"layer": ("qwen1.5-4b", "layer"),
                "dots": ("granite-moe-3b-a800m", "dots"),
                "none": ("qwen1.5-4b", "none"),
                "rwkv_none": ("rwkv6-3b", "none"),
                "whisper_dots": ("whisper-medium", "dots")}
SEQ_TALLY_ARCH = "command-r-plus-104b"


def seq_plan():
    from repro_torch.distributed import partition
    return partition.make_plan(model_parallel=2, device="cpu",
                               act_rules=SEQ_RULES)


def seq_grads(case: dict, initial: dict) -> dict:
    """The first step's gradient under the rule (the microbatches' mean,
    summed over the mesh as the step sums it, every leaf whole) as the
    reference's flat tree."""
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models import registry
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    cfg = config(registry, case)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      nest(initial))
    plan = seq_plan()
    step = train_loop.make_train_step(model, cfg, optimizer(case),
                                      plan=plan, zero1=True,
                                      n_microbatches=case["n_micro"])
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, case).items()}
    with use_sharding(plan.mesh, plan.param_rules, plan.act_rules):
        train_loop._backward_metrics(step.loss_fn, step._microbatches(batch))
    assert model.head_seq is not None, "the sequence was not cut"
    grads = train_loop._gradients(params, case["n_micro"])
    with torch.no_grad():
        grads = plan.zero_reduce_grads(grads, {k: -1 for k in grads},
                                       mean=False,
                                       model_sum=step.model_sum(),
                                       model_dup=step.layout.dup)
    return flatten(layers.stack_lm_tree(step.gather_params(grads)))


def seq_serve_inputs(cfg) -> dict:
    import torch_launch_ranks as L
    out = L.serve_inputs(cfg)
    if cfg.family == "audio":
        rng = np.random.default_rng(4)
        out["audio_embeds"] = rng.standard_normal(
            (L.SERVE_BATCH, SEQ_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def seq_serve_case(arch: str, initial: dict, act_rules=SEQ_RULES,
                   over: dict | None = None) -> dict:
    """Prefill and greedy decode of `arch`'s smoke model (its config
    fields `over` replaced) split over "model" on this rank's (data=2,
    model=2) plan under the rule (or under `act_rules` over the
    defaults): each step's logits and the tokens of this rank's rows,
    and the shapes of the cache it holds and of the whole."""
    import torch_launch_ranks as L
    from repro_torch.distributed import collectives, partition
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models import registry
    from repro_torch.nn import layers
    cfg = dataclasses.replace(L.serve_config(registry, arch), **(over or {}))
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      nest(initial))
    plan = partition.make_plan(model_parallel=2, device="cpu",
                               act_rules=act_rules)
    model.split_(plan.mesh.axes["model"])
    axis = plan.batch_axis
    width = L.SERVE_BATCH // axis.size
    inputs = {k: collectives.split_chunk(torch.from_numpy(v), axis, 0)
              for k, v in seq_serve_inputs(cfg).items()}
    extras = {k: v for k, v in inputs.items() if k != "tokens"}
    max_len = L.SERVE_PROMPT + L.SERVE_STEPS + cfg.num_patches
    logits, tokens, gathers = [], [], []
    with torch.no_grad(), use_sharding(plan.mesh, plan.param_rules,
                                       plan.act_rules):
        collectives.seq_observers.append(gathers.append)
        try:
            out, cache = model.prefill(inputs["tokens"], max_len=max_len,
                                       **extras)
        finally:
            collectives.seq_observers.remove(gathers.append)
        held = {k: tuple(v.shape) for k, v in vars(cache).items()
                if isinstance(v, torch.Tensor)}
        cuts = {k: v is not None for k, v in vars(cache).items()
                if k in ("seq", "enc_seq")}
        for _ in range(L.SERVE_STEPS):
            last = out.logits[:, -1]
            logits.append(last.numpy())
            tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            tokens.append(tok.numpy())
            out, cache = model.decode_step(tok, cache)
        logits.append(out.logits[:, -1].numpy())
    # the whole cache of the rank's rows: every kv head, every position
    whole = {k: tuple(v.shape) for k, v in vars(registry.build_model(
        cfg, "meta").init_cache(width, max_len, **(
            {"enc_len": SEQ_FRAMES} if cfg.family == "audio" else {}))
    ).items() if isinstance(v, torch.Tensor)}
    return {"logits": np.stack(logits, 1),
            "tokens": np.concatenate(tokens, 1),
            "rows": (axis.index * width, (axis.index + 1) * width),
            "held": held, "whole": whole, "cuts": cuts,
            "prefill_gathers": len(gathers)}


def seq_liveness(arch: str, remat: str) -> dict:
    """One step of `arch`'s smoke model (fp32, remat `remat`, two
    microbatches) under the rule with every whole sequence gathered
    watched (`collectives.seq_observers`): the count of their storages
    alive when
    each microbatch's forward returns, the most alive at once during the
    forwards, and the gathers made in all."""
    import weakref
    from repro_torch.distributed import collectives
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamW
    case = dict(arch=arch, remat=remat, n_micro=2, batch=4, seq=32,
                frames=SEQ_FRAMES)
    if arch.startswith("granite"):
        case["capacity_factor"] = 1.0
    cfg = config(registry, case)
    model = init_params(registry.build_model(cfg, "cpu"), 0)
    plan = seq_plan()
    step = train_loop.make_train_step(model, cfg, AdamW(learning_rate=LR),
                                      plan=plan, zero1=True, n_microbatches=2)
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, case).items()}
    refs, most, forward = [], [0], [False]

    def alive() -> int:
        return sum(r() is not None for r in refs)

    def seen(t):
        # the storage: autograd keeps views of a gathered tensor
        refs.append(weakref.ref(t.untyped_storage()))
        if forward[0]:
            most[0] = max(most[0], alive())

    after_forward = []
    loss_fn = step.loss_fn

    def watched(mb):
        forward[0] = True
        out = loss_fn(mb)
        forward[0] = False
        after_forward.append(alive())
        return out

    step.loss_fn = watched
    collectives.seq_observers.append(seen)
    try:
        step(params, step.init_opt_state(params), batch)
    finally:
        collectives.seq_observers.remove(seen)
    return {"after_forward": after_forward, "most": most[0],
            "gathers": len(refs), "layers": cfg.num_layers}


def seq_collectives_case() -> dict:
    """`gather_seq` and `reduce_scatter_seq` on this rank's model axis
    (dim 1 of [2, 3, 4] pieces from `gather_pieces`'s seeds): the whole
    the gather gives and its slice's gradient of ``sum(whole *
    weight_r)``; the slice the reduce-scatter gives of rank ``r``'s
    whole-shaped part and its gradient of ``sum(slice * weight_r)``."""
    from repro_torch.distributed import collectives
    axis = seq_plan().mesh.axes["model"]
    rng = np.random.default_rng(12)
    parts = [rng.standard_normal((2, 3, 4)).astype(np.float32)
             for _ in range(axis.size)]
    weights = [rng.standard_normal((2, 3 * axis.size, 4)).astype(np.float32)
               for _ in range(axis.size)]
    halves = [rng.standard_normal((2, 3, 4)).astype(np.float32)
              for _ in range(axis.size)]
    x = torch.from_numpy(parts[axis.index]).requires_grad_(True)
    y = collectives.gather_seq(x, axis)
    (y * torch.from_numpy(weights[axis.index])).sum().backward()
    z = torch.from_numpy(weights[axis.index]).requires_grad_(True)
    w = collectives.reduce_scatter_seq(z, axis)
    (w * torch.from_numpy(halves[axis.index])).sum().backward()
    return {"index": axis.index,
            "gather": (y.detach().numpy(), x.grad.numpy()),
            "scatter": (w.detach().numpy(), z.grad.numpy()),
            "inputs": (parts, weights, halves)}


def seq_tally_case(*, fake: bool, device: str | None = None) -> dict:
    """One traced train step of `SEQ_TALLY_ARCH`'s smoke config (AdamW,
    fp32, two microbatches of 2 x 64) under the rule on this rank's
    (data=2, model=2) plan (`repro_torch.launch.dryrun.trace_train`):
    on meta tensors in a fake world, or on real CPU ones."""
    import torch_launch_ranks as L
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import AdamW
    cfg = registry.get_config(SEQ_TALLY_ARCH + "-smoke")
    device = device or ("meta" if fake else "cpu")

    def init(model):
        if device != "meta":
            init_params(model, 0)

    t = trace_train(cfg, AdamW(learning_rate=1e-4), L.tally_batch(cfg),
                    plan=seq_plan(), n_microbatches=L.TALLY_MICRO,
                    device=device, init=init)
    return {k: t[k] for k in ("held", "collectives", "peak", "flops")}


def seq_tally_fake() -> dict:
    """`seq_tally_case` on rank 0 of a fake world of 4, on meta and on
    real CPU tensors."""
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        return {device: seq_tally_case(fake=True, device=device)
                for device in ("meta", "cpu")}


def seq_world(initial: dict, serve_initial: dict) -> dict:
    """What a rank of the 4-rank world of `tests/test_torch_lm_seq.py`
    returns: every case trained and its first gradient, the serving
    cases, the liveness runs, the two collectives and the tally."""
    out = {}
    for name, case in SEQ_CASES.items():
        out[name] = train_case(case, initial[name], act_rules=SEQ_RULES)
        out[name]["grads"] = seq_grads(case, initial[name])
    out["serve"] = {name: seq_serve_case(arch, serve_initial[name])
                    for name, arch in SEQ_SERVE.items()}
    out["liveness"] = {name: seq_liveness(arch, remat)
                       for name, (arch, remat) in SEQ_LIVENESS.items()}
    out["collectives"] = seq_collectives_case()
    out["tally"] = seq_tally_case(fake=False)
    return out


# ---------------------------------------------------------------------------
# tensor parallelism for rwkv6, zamba2 and whisper
# (`tests/test_torch_lm_tp_families.py`)
# ---------------------------------------------------------------------------

TP_CASES = {
    # the time mix split by heads (4 over 2), the channel mix by its
    # hidden width, the head by vocabulary
    "rwkv": CASES["rwkv"],
    # Mamba2 by SSM heads (8 over 2), the shared block, the tied table
    "zamba": dict(arch="zamba2-1.2b", opt="adamw", n_micro=1, batch=4,
                  seq=32),
    # the same with Adafactor: its factored statistics and update RMS
    # over the fused in_proj, conv_w and the stacked conv_b count the B
    # and C ranges every model rank holds alike once
    "zamba_adafactor": dict(arch="zamba2-1.2b", opt="adafactor", n_micro=1,
                            batch=4, seq=32),
    # the same placed (FSDP) under the "seq" rule, remat "layer", two
    # microbatches and the uneven mask
    "zamba_seq": dict(arch="zamba2-1.2b", opt="adamw", n_micro=2, batch=4,
                      seq=32, remat="layer", mask=True),
    # encoder and decoder attention and MLPs over 32 frames; its key
    # biases are held by `zero_grad_leaves`' bound
    "whisper": dict(arch="whisper-medium", opt="adamw", n_micro=1, batch=4,
                    seq=32, frames=32),
    # uneven over model=2, placed (FSDP): 3 experts fall through to their
    # hidden width (64), 3 query heads over 1 kv head of 32 to the fused
    # columns (96 and 32), cut at rest and gathered at use; capacity
    # factor 0.5, so tokens drop
    "granite_uneven": dict(arch="granite-moe-3b-a800m", opt="adamw",
                           n_micro=1, batch=4, seq=64, experts=3, heads=3,
                           kv_heads=1, capacity_factor=0.5),
    # 3 heads of 32 (d_model 96): the heads do not split over 2, so the
    # time mix runs by value columns (16 of every head a rank, the wkv
    # state so cut), its r, k, v, g and o cut at rest by the fused
    # columns and gathered at use
    "rwkv_uneven": dict(arch="rwkv6-3b", opt="adamw", n_micro=1, batch=4,
                        seq=32, d_model=96),
}
TP_RULES = {"zamba_seq": SEQ_RULES}   # a case's act rules over the defaults
TP_PLACED = ("zamba_seq", "granite_uneven")  # placed by place_params_
TP_SERVE = {"rwkv": "rwkv6-3b", "zamba": "zamba2-1.2b",
            "whisper": "whisper-medium", "rwkv_uneven": "rwkv6-3b"}
# a serving case's config fields over the smoke config's: rwkv_uneven
# served from its cache cut by value columns
TP_SERVE_OVER = {"rwkv_uneven": dict(d_model=96)}
TP_TALLY_ARCH = "zamba2-1.2b"


def tp_plan(name: str):
    from repro_torch.distributed import partition
    return partition.make_plan(model_parallel=2, device="cpu",
                               act_rules=TP_RULES.get(name))


def tp_grads(name: str, initial: dict) -> dict:
    """The first step's gradient of `TP_CASES[name]` on this rank's plan
    (the microbatches' mean, summed over the mesh as the step sums it,
    every leaf whole) as the reference's flat tree."""
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models import registry
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    case = TP_CASES[name]
    cfg = config(registry, case)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      nest(initial))
    plan = tp_plan(name)
    if name in TP_PLACED:
        plan.place_params_(model)
    step = train_loop.make_train_step(model, cfg, optimizer(case),
                                      plan=plan, zero1=True,
                                      n_microbatches=case["n_micro"])
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, case).items()}
    with use_sharding(plan.mesh, plan.param_rules, plan.act_rules):
        train_loop._backward_metrics(step.loss_fn, step._microbatches(batch))
    grads = train_loop._gradients(params, case["n_micro"])
    with torch.no_grad():
        dims = step.data_dims if step.fsdp else {k: -1 for k in grads}
        grads = plan.zero_reduce_grads(
            grads, dims, mean=False, sliced=step.fsdp,
            model_sum=step.model_sum(), model_dup=step.layout.dup)
    return flatten(layers.stack_lm_tree(step.gather_params(grads)))


def tp_serve_config(module, name: str):
    """`TP_SERVE[name]`'s smoke config from a registry module, with its
    `TP_SERVE_OVER` fields."""
    import torch_launch_ranks as L
    return dataclasses.replace(L.serve_config(module, TP_SERVE[name]),
                               **TP_SERVE_OVER.get(name, {}))


def tp_leaves_case(name: str) -> dict:
    """`TP_SERVE[name]`'s smoke model (`tp_serve_config`) drawn from
    seed 5 and split on this rank's (data=2, model=2) plan
    (`partition.model_layout`): the shape of each leaf whole and held,
    the dim cut over "model", the fused leaves' pieces, whether
    `gather_params` rebuilds every whole leaf bit for bit, and whether
    `ModelLayout.rank_part` of each whole leaf is what the rank holds."""
    from repro_torch.distributed import partition
    from repro_torch.models import registry
    from repro_torch.nn import layers
    cfg = tp_serve_config(registry, name)
    model = layers.init_params(registry.build_model(cfg, "cpu"), 5)
    whole = {k: p.detach().clone() for k, p in model.named_parameters()}
    plan = partition.make_plan(model_parallel=2, device="cpu")
    layout = partition.model_layout(model, plan)
    held = {k: p.detach() for k, p in model.named_parameters()}
    back = plan.gather_params(held, layout.model_dims, layout.fused)
    return {"whole": {k: tuple(v.shape) for k, v in whole.items()},
            "held": {k: tuple(v.shape) for k, v in held.items()},
            "model_dims": dict(layout.model_dims),
            "fused": {k: (d, [tuple(p) for p in pieces])
                      for k, (d, pieces) in layout.fused.items()},
            "dup": layout.dup, "partial": list(layout.partial),
            "gathered_equal": [k for k in whole
                               if torch.equal(back[k], whole[k])],
            "part_equal": [k for k in whole if torch.equal(
                layout.rank_part(k, whole[k]), held[k])],
            "index": plan.mesh.axes["model"].index}


def split_norm_case() -> dict:
    """One `LayerNorm` (48 channels, a drawn scale and bias) split over
    this rank's model axis of a world of 2, against the whole one: each
    rank's output channels, and the gradients of ``sum(y * w)`` (its
    input channels', and the scale's and bias' summed over the axis)."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.nn.layers import LayerNorm
    plan = partition.make_plan(model_parallel=2, device="cpu")
    axis = plan.mesh.axes["model"]
    rng = np.random.default_rng(17)
    x, w, scale, bias = (rng.standard_normal(shape).astype(np.float32)
                         for shape in ((3, 5, 48), (3, 5, 48), 48, 48))
    x = 3 * x + 1
    out = {"index": axis.index, "x": x, "w": w}
    for split in (False, True):
        norm = LayerNorm(48)
        with torch.no_grad():
            norm.scale.copy_(torch.from_numpy(scale))
            norm.bias.copy_(torch.from_numpy(bias))
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        if split:
            norm.split_(axis)
            xt = collectives.split_chunk(xt, axis, 2)
            wt = collectives.split_chunk(wt, axis, 2)
        xt.requires_grad_(True)
        y = norm(xt)
        (y * wt).sum().backward()
        grads = [norm.scale.grad, norm.bias.grad]
        if split:
            grads = [collectives.all_reduce(g, axis) for g in grads]
        out["split" if split else "whole"] = {
            "y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "scale_grad": grads[0].numpy(), "bias_grad": grads[1].numpy()}
    return out


def tp_tally_case(*, fake: bool, device: str | None = None) -> dict:
    """One traced train step of `TP_TALLY_ARCH`'s smoke config (AdamW,
    fp32, two microbatches of 2 x 64), placed (FSDP) and under the
    "seq" rule on this rank's (data=2, model=2) plan: on meta tensors in
    a fake world, or on real CPU ones."""
    import torch_launch_ranks as L
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import AdamW
    cfg = registry.get_config(TP_TALLY_ARCH + "-smoke")
    device = device or ("meta" if fake else "cpu")

    def init(model):
        if device != "meta":
            init_params(model, 0)

    t = trace_train(cfg, AdamW(learning_rate=1e-4), L.tally_batch(cfg),
                    plan=seq_plan(), n_microbatches=L.TALLY_MICRO,
                    device=device, init=init, place=True)
    return {k: t[k] for k in ("held", "collectives", "peak", "flops")}


def tp_tally_fake() -> dict:
    """`tp_tally_case` on rank 0 of a fake world of 4, on meta tensors."""
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        return tp_tally_case(fake=True)


def tp_world(initial: dict, serve_initial: dict) -> dict:
    """What a rank of the 4-rank world of
    `tests/test_torch_lm_tp_families.py` returns: every case trained and
    its first gradient, the serving cases, each family's split leaves,
    and the tally."""
    out = {}
    for name, case in TP_CASES.items():
        out[name] = train_case(case, initial[name],
                               placed=name in TP_PLACED,
                               act_rules=TP_RULES.get(name))
        out[name]["grads"] = tp_grads(name, initial[name])
    out["serve"] = {name: seq_serve_case(arch, serve_initial[name],
                                         act_rules=None,
                                         over=TP_SERVE_OVER.get(name))
                    for name, arch in TP_SERVE.items()}
    out["leaves"] = {name: tp_leaves_case(name) for name in TP_SERVE}
    out["tally"] = tp_tally_case(fake=False)
    return out


# ---------------------------------------------------------------------------
# gradient compression on the mesh (`tests/test_torch_lm_mesh.py`)
# ---------------------------------------------------------------------------

# the compressed step against the reference's ``make_train_step(...,
# plan=, zero1=True, grad_compression=compress_int8_stateless)``: the
# qwen case under ZeRO-1 and placed (FSDP); both are held to the one
# reference run (its placement changes no value)
COMPRESS_CASES = {"qwen_int8": dict(CASES["qwen"]),
                  "qwen_int8_placed": dict(CASES["qwen"], placed=True)}
# the compressor on slices: models whose leaves on the (data=2, model=2)
# plan cover every kind `COMPRESS_KINDS` names
COMPRESS_PIECES = {
    # attention split by heads, whole norms, ZeRO-1 slices
    "qwen": dict(arch="qwen1.5-4b"),
    # Mamba2's fused in_proj cut by pieces, B and C alike on every rank
    "zamba": dict(arch="zamba2-1.2b"),
    # 3 experts cut by hidden width, 3 heads cut at rest, placed (FSDP)
    "granite_uneven": dict(TP_CASES["granite_uneven"], placed=True),
}
COMPRESS_KINDS = ("whole", "heads", "rank_part", "rest_cut", "moe_mlp",
                  "dup", "zero1", "fsdp")
COMPRESS_CALLS = 3   # error-feedback calls held to the reference's


def int8_codes(x: np.ndarray) -> tuple:
    """The reference's int8 rule in fp32 numpy: (codes, scale, x / scale)
    (`np.round` rounds half to even, as `jnp.round`)."""
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
        / np.float32(127.0)
    ratio = x / scale
    return np.clip(np.round(ratio), -127, 127), scale, ratio


def code_misses(x_ref: dict, x_got: dict, out_got: dict, label: str,
                max_misses: int | None) -> dict:
    """The code rule of a compressed gradient against the reference's
    (flat trees: the reference's gradient before compression, the port's
    before and after): every scale within ``1e-6 + 1e-4 |s|``, the
    port's output its codes times its scale exactly, and (given
    `max_misses`: the first step's gradient) the codes equal but where
    the reference's ``x / scale`` lies within 1e-3 of a half-integer, at
    most `max_misses` a leaf.  A later step's gradient follows
    parameters a differing code has moved, so its differing codes are
    listed only.  Returns {leaf: mask of the codes that differ} for the
    leaves with any."""
    assert sorted(x_got) == sorted(x_ref)
    differed = {}
    for k, x in x_ref.items():
        q_ref, s_ref, ratio = int8_codes(x)
        _, s_got, _ = int8_codes(x_got[k])
        assert abs(s_got - s_ref) <= 1e-6 + 1e-4 * abs(s_ref), (label, k)
        q_got = np.round(out_got[k] / s_got)
        np.testing.assert_array_equal(
            (q_got.astype(np.float32) * s_got).astype(np.float32),
            out_got[k], err_msg=f"{label} {k}")
        miss = q_got != q_ref
        if not miss.any():
            continue
        if max_misses is not None:
            tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-3
            assert tie[miss].all(), (
                f"{label} {k}: a code differs away from a rounding tie")
            assert miss.sum() <= max_misses, (label, k, int(miss.sum()))
        print(f"{label} {k}: {int(miss.sum())} of {miss.size} codes differ, "
              f"at {np.argwhere(miss).tolist()}")
        differed[k] = miss
    return differed


def final_within(got: dict, want: dict, differed: dict, label: str) -> None:
    """Final parameters at rtol 1e-4 / atol 1e-5, but ``STEPS x LR +
    1e-5`` at the elements whose codes differed in a step."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        atol = np.full(v.shape, 1e-5)
        if k in differed:
            atol[differed[k]] = STEPS * LR + 1e-5
        bad = np.abs(got[k] - v) > atol + 1e-4 * np.abs(v)
        assert not bad.any(), (label, k, np.argwhere(bad).tolist()[:5])


def compress_names(name: str) -> dict:
    """{parameter name: whole shape} of `COMPRESS_PIECES[name]`'s model
    (built on meta tensors)."""
    from repro_torch.models import registry
    model = registry.build_model(config(registry, COMPRESS_PIECES[name]),
                                 "meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def compress_trees(name: str) -> list:
    """`COMPRESS_CALLS` whole gradient trees ({parameter name: fp32
    array}) for `COMPRESS_PIECES[name]`'s model, from a seed; each leaf
    has its own magnitude, so a layer's and its stack's maxima differ."""
    rng = np.random.default_rng(31)
    shapes = compress_names(name)
    return [{k: (rng.standard_normal(s) * (0.5 + (i % 7))).astype(np.float32)
             for i, (k, s) in enumerate(shapes.items())}
            for _ in range(COMPRESS_CALLS)]


def stack_np(tree: dict) -> dict:
    """The port's per-layer tree as the reference's stacked one (numpy)."""
    from repro_torch.nn.layers import stack_groups
    return {key: (np.stack([tree[k] for k in members])
                  if not isinstance(members, str) else tree[members])
            for key, members in stack_groups(list(tree)).items()}


def unstack_np(flat: dict, names) -> dict:
    """The reference's stacked tree as the port's per-layer leaves."""
    from repro_torch.nn.layers import stack_groups
    out = {}
    for key, members in stack_groups(list(names)).items():
        if isinstance(members, str):
            out[members] = flat[key]
        else:
            out.update((k, flat[key][i]) for i, k in enumerate(members))
    return out


def _leaf_kinds(model, step) -> dict:
    """{parameter name: the `COMPRESS_KINDS` it falls under}."""
    from repro_torch.nn.layers import Linear
    from repro_torch.nn.moe import MoELayer
    layout, out = step.layout, {}
    dup = {k for k, (_, ranges) in layout.dup.items() if ranges}
    for k in dict(model.named_parameters()):
        owner_name = k.rpartition(".")[0]
        owner = model.get_submodule(owner_name)
        kinds = set()
        if layout.model_dims[k] < 0 and step.data_dims[k] < 0:
            kinds.add("whole")
        if isinstance(owner, Linear) and owner.rest_cut is not None:
            kinds.add("rest_cut")
        elif (isinstance(owner, Linear) and owner.split is not None
              and "attn" in owner_name):
            kinds.add("heads")
        if isinstance(owner, MoELayer) and owner.cut == "mlp":
            kinds.add("moe_mlp")
        if k in layout.fused:
            kinds.add("rank_part")
        if k in dup:
            kinds.add("dup")
        if step.data_dims[k] >= 0:
            kinds.add("fsdp" if step.fsdp else "zero1")
        out[k] = sorted(kinds)
    return out


def compress_pieces_case(name: str, ref: dict) -> dict:
    """`COMPRESS_PIECES[name]` split (and placed) on this rank's (data=2,
    model=2) plan: the step's `compress` of this rank's slices of
    `compress_trees(name)`, stateless and then through a bound
    error-feedback compressor for `COMPRESS_CALLS` calls, against this
    rank's slices of the reference's compressors on the whole stacked
    trees (`ref`: {"stateless" | "ef{i}" | "res{i}": stacked tree}).
    Returns the unequal elements of each (call, leaf), the leaf kinds
    covered and the `all_max` calls of each compression."""
    from repro_torch.distributed import collectives, compression, partition
    from repro_torch.models import registry
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamW
    case = COMPRESS_PIECES[name]
    cfg = config(registry, case)
    model = registry.build_model(cfg, "cpu")
    plan = partition.make_plan(model_parallel=2, device="cpu")
    if case.get("placed"):
        plan.place_params_(model)
    step = train_loop.make_train_step(model, cfg, AdamW(), plan=plan,
                                      zero1=True)
    names = list(dict(model.named_parameters()))

    def mine(whole: dict) -> dict:
        out = {}
        for k in names:
            x = step.layout.rank_part(k, torch.from_numpy(
                np.ascontiguousarray(whole[k])))
            if step.data_dims[k] >= 0:
                x = collectives.split_chunk(x, plan.data_axis,
                                            step.data_dims[k])
            out[k] = x.contiguous()
        return out

    calls, real = [], collectives.all_max

    def counted(x, axis):
        calls[-1] += 1
        return real(x, axis)

    def run(grads):
        calls.append(0)
        collectives.all_max = counted
        try:
            return step.compress(grads)
        finally:
            collectives.all_max = real

    def unequal(got: dict, want: dict) -> dict:
        return {k: int((got[k] != want[k]).sum()) for k in names}

    trees = compress_trees(name)
    mismatch = {}
    step.grad_compression = compression.compress_int8_stateless
    mismatch["stateless"] = unequal(run(mine(trees[0])),
                                    mine(unstack_np(ref["stateless"], names)))
    bound = compression.ErrorFeedbackCompressor().bind()
    step.grad_compression = bound
    for i, tree in enumerate(trees):
        mismatch[f"ef{i}"] = unequal(run(mine(tree)),
                                     mine(unstack_np(ref[f"ef{i}"], names)))
        mismatch[f"res{i}"] = unequal(
            bound.state.residual, mine(unstack_np(ref[f"res{i}"], names)))
    kinds = sorted({kind for ks in _leaf_kinds(model, step).values()
                    for kind in ks})
    return {"mismatch": mismatch, "kinds": kinds, "calls": calls,
            "elements": sum(x.numel() for x in mine(trees[0]).values())}


def _whole_tree(step, tree: dict) -> dict:
    """The whole leaves (as the reference's flat stacked tree) from this
    rank's gradient slices (collectives: every rank calls it)."""
    from repro_torch.nn import layers
    plan = step.plan
    tree = plan.zero_gather({k: v.detach() for k, v in tree.items()},
                            step.data_dims)
    tree = plan.gather_params(tree, step.model_dims, step.layout.fused)
    return flatten(layers.stack_lm_tree(tree))


def compress_case(case: dict, initial: dict) -> dict:
    """`train_case` of `case` with ``grad_compression=
    compress_int8_stateless`` on this rank's (data=2, model=2) plan
    (placed first where the case says so): per-step metrics, the whole
    final parameters, and on rank 0 each step's whole gradient before
    and after the compression; every rank's `all_max` calls a
    compression."""
    from repro_torch.distributed import collectives, compression, partition
    from repro_torch.models import registry
    from repro_torch.nn import layers
    from repro_torch.train import train_loop
    cfg = config(registry, case)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      nest(initial))
    plan = partition.make_plan(model_parallel=2, device="cpu")
    if case.get("placed"):
        plan.place_params_(model)
    step = train_loop.make_train_step(
        model, cfg, optimizer(case), plan=plan, zero1=True,
        n_microbatches=case["n_micro"],
        grad_compression=compression.compress_int8_stateless)
    params = dict(model.named_parameters())
    state = step.init_opt_state(params)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, case).items()}
    seen, calls, real = [], [], collectives.all_max
    inner = step.compress

    def counted(x, axis):
        calls[-1] += 1
        return real(x, axis)

    def spy(grads):
        calls.append(0)
        collectives.all_max = counted
        try:
            out = inner(grads)
        finally:
            collectives.all_max = real
        pair = (_whole_tree(step, grads), _whole_tree(step, out))
        seen.append(pair if plan.rank == 0 else None)
        return out

    step.compress = spy
    metrics = []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    full = step.gather_params(params)
    return {"metrics": metrics,
            "params": flatten(layers.stack_lm_tree(full)),
            "grads": seen, "calls": calls}
