"""What each rank of the launch tests runs (imported by name in the
spawned rank processes, so it imports torch and `repro_torch` only,
never JAX).

* `serve_world`: prefill and greedy decode of the `SERVE_CASES` smoke
  models split over (data=2, model=2) — each rank its data block of the
  prompts, the vocabulary gathered into whole logits — and `pod_case`,
  a train case of `torch_lm_mesh_ranks` on (pod=2, data=1, model=2).
* `tally_world` / `tally_fake`: one traced train step of the
  `TALLY_CASES` on (data=2, model=2), on real gloo ranks or on rank 0 of
  a fake world of 4 (`repro_torch.launch.dryrun`), over parameters
  placed by `MeshPlan.place_params_` with ``place``; `fsdp_tally_fake`
  the placed step on meta and on real CPU tensors in one fake world.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

import torch_lm_mesh_ranks as R

SERVE_CASES = {"qwen": "qwen1.5-4b", "granite": "granite-moe-3b-a800m",
               "phi": "phi-3-vision-4.2b"}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 16, 4
POD_CASE = dict(R.CASES["qwen"])
TALLY_CASES = {"qwen": "qwen1.5-4b", "granite": "granite-moe-3b-a800m"}
TALLY_BATCH, TALLY_SEQ, TALLY_MICRO = 4, 64, 2


def serve_config(module, arch: str):
    """The arch's smoke config in fp32 (the reference's smoke configs
    compute in fp32 already)."""
    return module.get_config(arch + "-smoke")


def serve_inputs(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (SERVE_BATCH, SERVE_PROMPT)
                                  ).astype(np.int32)}
    if cfg.num_patches:
        out["patch_embeds"] = rng.standard_normal(
            (SERVE_BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def serve_case(arch: str, initial: dict, *, split: bool = True,
               placed: bool = False) -> dict:
    """Prefill (max_len prompt + SERVE_STEPS + patches) and SERVE_STEPS
    greedy decode steps: each step's logits and the tokens, for this
    rank's rows (all of them with ``split=False``, one rank alone).
    ``placed``: the parameters placed by `MeshPlan.place_params_` (cut
    over "data" too, gathered a layer at use) where ``split`` only
    splits them over "model"; the bytes held a rank come back too."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models import registry
    from repro_torch.nn import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_config(registry, arch)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      R.nest(initial))
    inputs = {k: torch.from_numpy(v) for k, v in serve_inputs(cfg).items()}
    max_len = SERVE_PROMPT + SERVE_STEPS + cfg.num_patches
    rows = slice(None)
    plan = None
    if split:
        plan = partition.make_plan(model_parallel=2, device="cpu")
        if placed:
            plan.place_params_(model)
        else:
            model.split_(plan.mesh.axes["model"])
        axis = plan.batch_axis
        width = SERVE_BATCH // axis.size
        rows = slice(axis.index * width, (axis.index + 1) * width)
        inputs = {k: collectives.split_chunk(v, axis, 0)
                  for k, v in inputs.items()}
    extras = {k: v for k, v in inputs.items() if k != "tokens"}
    logits, tokens = [], []
    with torch.no_grad(), (use_sharding(plan.mesh, plan.param_rules,
                                        plan.act_rules) if plan else
                           contextlib.nullcontext()):
        out, cache = model.prefill(inputs["tokens"], max_len=max_len,
                                   **extras)
        kv_heads = cache.k.shape[3]
        for _ in range(SERVE_STEPS):
            last = out.logits[:, -1]
            logits.append(last.numpy())
            tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            tokens.append(tok.numpy())
            out, cache = model.decode_step(tok, cache)
        logits.append(out.logits[:, -1].numpy())
    return {"logits": np.stack(logits, 1), "tokens": np.concatenate(tokens, 1),
            "rows": (rows.start, rows.stop), "kv_heads": kv_heads,
            "param_bytes": partition.tree_bytes(
                {k: p.detach() for k, p in model.named_parameters()})}


def pod_case(initial: dict) -> dict:
    """`POD_CASE` trained on (pod=2, data=1, model=2)."""
    return R.train_case(POD_CASE, initial, pods=2)


def serve_world(initial: dict, pod_initial: dict) -> dict:
    """What a rank of the 4-rank world of the launch tests returns."""
    out = {name: serve_case(arch, initial[name])
           for name, arch in SERVE_CASES.items()}
    out["pod"] = pod_case(pod_initial)
    return out


def tally_batch(cfg) -> dict:
    return {"tokens": ((TALLY_BATCH, TALLY_SEQ), torch.int64),
            "labels": ((TALLY_BATCH, TALLY_SEQ), torch.int64)}


def tally_case(arch: str, *, fake: bool, place: bool = False,
               remat: str | None = None, device: str | None = None) -> dict:
    """One traced train step of `arch`'s smoke config (AdamW, fp32) on
    this rank's (data=2, model=2) plan: the tally's figures, and on real
    ranks the bytes held as the mesh counts them.  ``place``: over
    parameters placed first (FSDP); ``remat`` overrides the config's;
    ``device``: where the tensors live ("meta" in a fake world, "cpu"
    on real ranks, by default), drawn from seed 0 on the CPU."""
    from repro_torch.distributed import partition
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.models import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import AdamW
    cfg = registry.get_config(arch + "-smoke")
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    plan = partition.make_plan(model_parallel=2, device="cpu")
    held = {}
    device = device or ("meta" if fake else "cpu")

    def init(model):
        if device != "meta":
            init_params(model, 0)

    t = trace_train(cfg, AdamW(learning_rate=1e-4), tally_batch(cfg),
                    plan=plan, n_microbatches=TALLY_MICRO,
                    device=device, init=init, place=place)
    held.update(t["held"])
    return {"held": held, "collectives": t["collectives"],
            "peak": t["peak"], "setup_peak": t["setup_peak"],
            "flops": t["flops"]}


def tally_world(place: bool = False) -> dict:
    """Every tally case on this rank of a real gloo world of 4, with the
    bytes the plan counts itself beside the tally's (``place``: FSDP)."""
    from repro_torch.distributed import partition
    from repro_torch.models import registry
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import make_train_step
    out = {}
    for name, arch in TALLY_CASES.items():
        out[name] = tally_case(arch, fake=False, place=place)
        # the same layout counted by the mesh's own functions
        cfg = registry.get_config(arch + "-smoke")
        model = registry.build_model(cfg, "cpu")
        plan = partition.make_plan(model_parallel=2, device="cpu")
        if place:
            plan.place_params_(model)
        step = make_train_step(model, cfg, AdamW(), plan=plan, zero1=True)
        params = dict(model.named_parameters())
        state = step.init_opt_state(params)
        out[name]["mesh_bytes"] = {
            "params": partition.tree_bytes({k: p.detach()
                                            for k, p in params.items()}),
            "opt_state": plan.opt_state_bytes_per_device(state)}
    return out


def tally_fake(place: bool = False) -> dict:
    """Every tally case on rank 0 of a fake world of 4 (a spawned
    process with no process group of its own)."""
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        return {name: tally_case(arch, fake=True, place=place)
                for name, arch in TALLY_CASES.items()}


# the FSDP tally on real CPU tensors against meta: one case per remat
FSDP_TALLY = {"layer": "qwen1.5-4b", "dots": "granite-moe-3b-a800m",
              "none": "qwen1.5-4b"}


def fsdp_tally_fake() -> dict:
    """Each `FSDP_TALLY` case traced over placed parameters on rank 0 of
    a fake world of 4, on meta tensors and on real CPU tensors (the
    collectives move nothing there; every storage is made and freed as
    on a rank), and the placed tally cases on meta for the real ranks'
    counts."""
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        out = {f"{remat}/{device}": tally_case(arch, fake=True, place=True,
                                               remat=remat, device=device)
               for remat, arch in FSDP_TALLY.items()
               for device in ("meta", "cpu")}
        out.update({name: tally_case(arch, fake=True, place=True)
                    for name, arch in TALLY_CASES.items()})
    return out
