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
    # the family without tensor parallelism: data parallel + ZeRO-1
    "rwkv": dict(arch="rwkv6-3b", opt="adamw", n_micro=1, batch=4, seq=32),
}
LR = 1e-4


def config(module, case: dict):
    """The case's smoke config from a registry module (the reference's
    or the port's)."""
    cfg = module.get_config(case["arch"] + "-smoke")
    if "capacity_factor" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    return cfg


def batch_np(cfg, case: dict, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    b, s = case["batch"], case["seq"]
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if case.get("mask"):
        mask = np.ones((b, s), np.float32)
        mask[1, s // 4:] = 0.0   # microbatch 0's second data half
        mask[2, : s // 2] = 0.0  # microbatch 1's first data half
        out["loss_mask"] = mask
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


def optimizer(case: dict):
    from repro_torch.launch.specs import pick_optimizer
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt
    if case["opt"] == "pick":
        return pick_optimizer(registry.get_config(case["arch"]))
    return opt.AdamW(learning_rate=LR)


def train_case(case: dict, initial: dict, *, model_parallel: int = 2,
               mesh: bool = True, steps: int = STEPS,
               device: str = "cpu", pods: int = 1) -> dict:
    """The case on this rank's mesh (led by `pods` pods; or, with
    ``mesh=False``, the one-device step) from the reference's initial
    tree, on `device` (fp32, TF32 off): per-step metrics, the whole final parameters as the
    reference's flat tree, the bytes this rank holds of parameters and
    of optimizer state."""
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
    opt = optimizer(case)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_np(cfg, case).items()}
    if mesh:
        plan = partition.make_plan(model_parallel=model_parallel,
                                   pods=pods, device=device)
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
            "opt_bytes": tree_bytes(state)}


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


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.asarray(
        scale * np.random.default_rng(seed).standard_normal(shape),
        np.float32))


def optimizer_pieces() -> dict:
    """Three Adafactor updates and one global norm on this rank's slices
    of `PIECE_SHAPES` (cut over both axes of a (data=2, model=2) mesh),
    against the same on the whole tree; returns both, this rank's slices
    of the whole result beside its own."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.nn.layers import stack_groups
    from repro_torch.train import optimizer as opt
    plan = partition.make_plan(model_parallel=2, device="cpu")
    data, model = plan.data_axis, plan.mesh.axes["model"]

    def mine(tree):
        out = {}
        for k, x in tree.items():
            for axis, dims in ((data, PIECE_DATA), (model, PIECE_MODEL)):
                if dims[k] >= 0:
                    x = collectives.split_chunk(x, axis, dims[k])
            out[k] = x.clone()
        return out

    ada = opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    full = {k: _normal(s, i) for i, (k, s) in enumerate(PIECE_SHAPES.items())}
    part = mine(full)
    groups = stack_groups(full)
    s_full, s_part = ada.init(full, groups), ada.init(part, groups)
    kw = dict(group=data, shard_dims=PIECE_DATA, model=model,
              model_dims=PIECE_MODEL, groups=groups)
    for step in range(3):
        grads = {k: _normal(s, 50 + 10 * step + i, 0.5)
                 for i, (k, s) in enumerate(PIECE_SHAPES.items())}
        full, s_full, _ = ada.update(grads, s_full, full, groups=groups)
        part, s_part, _ = ada.update(mine(grads), s_part, part, **kw)
    norm = opt.global_norm(mine(grads), group=data, shard_dims=PIECE_DATA,
                           model=model, model_dims=PIECE_MODEL)
    return {"params": ({k: v.numpy() for k, v in part.items()},
                       {k: v.numpy() for k, v in mine(full).items()}),
            "norm": (float(norm), float(opt.global_norm(grads)))}


def lm_mesh_world(names: list, initial: dict) -> dict:
    """What a rank of the 4-rank world of `tests/test_torch_lm_mesh.py`
    returns: every named case trained, and the optimizer pieces."""
    out = train_cases(names, initial)
    out["pieces"] = optimizer_pieces()
    return out


def pipeline_rank(ws: np.ndarray, x: np.ndarray, n_microbatches: int,
                  stages: int) -> dict:
    """`pipeline_apply` of the reference's test body (``tanh(h @ w)``)
    over a "stage" mesh of this world's ranks, and a DecoderBlock stage
    a rank (qwen1.5-4b-smoke, fp32) against the blocks in sequence."""
    from repro_torch.distributed import partition
    from repro_torch.distributed.pipeline_parallel import (pipeline_apply,
                                                           stage_layers)
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.nn.transformer import DecoderBlock
    mesh = partition.make_mesh(stages=stages)
    fn = pipeline_apply(lambda w, h: torch.tanh(h @ w), mesh,
                        n_microbatches=n_microbatches)
    out = fn(stage_layers(torch.from_numpy(ws), mesh), torch.from_numpy(x))

    cfg = registry.get_config("qwen1.5-4b-smoke")
    blocks = [init_params(DecoderBlock(cfg), 10 + i) for i in range(stages)]
    h = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    run = pipeline_apply(lambda block, y: block(y)[0], mesh,
                         n_microbatches=4)
    got = run(stage_layers(blocks, mesh), h)
    with torch.no_grad():
        want = h
        for block in blocks:
            want = block(want)[0]
    return {"mesh": (mesh.axis_names, dict(mesh.shape),
                     mesh.axes["stage"].ranks),
            "out": out.numpy(), "blocks": (got.numpy(), want.numpy()),
            "requires_grad": got.requires_grad}
