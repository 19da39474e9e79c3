"""End-to-end training entry point for the LM architectures (twin of
`repro.launch.train`, the same flags plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen1.5-4b-smoke --steps 50 --batch 8 --seq 128 \
        --ckpt-dir /tmp/ckpt

Runs on the card unless ``--device cpu`` is given.  The model's
parameters are drawn from seed 0 on the device (`init_params`) and its
floating parameters cast to the config's ``param_dtype``; the optimizer
is `pick_optimizer`'s.  With ``--ckpt-dir`` it resumes from the latest
checkpoint there, saves every ``--ckpt-every`` steps in the background
and at the end, and saves at once on SIGTERM; after a restore the data
stream skips the batches already trained on, so each is trained on
exactly once.  ``--lr`` is parsed and, as in the reference, unused: the
policy fixes the learning rate.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.synthetic import token_batches
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch.specs import pick_optimizer
from repro_torch.models.registry import build_model, get_config
from repro_torch.nn.layers import init_params, stack_groups
from repro_torch.nn.transformer import torch_dtype
from repro_torch.train.train_loop import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to "
                           "train on the CPU")
    cfg = get_config(args.arch)
    model = build_model(cfg, args.device)
    pdt = torch_dtype(cfg.param_dtype)
    with torch.no_grad():
        init_params(model, 0)
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(pdt)
    params = dict(model.named_parameters())
    opt = pick_optimizer(cfg)
    opt_state = opt.init(params, stack_groups(params))
    step = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval_steps=args.ckpt_every)
        restored = mgr.restore_latest((params, opt_state))
        if restored is not None:
            step, (values, opt_state), _ = restored
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(values[k])
            print(f"restored checkpoint at step {step}")

    train_step = make_train_step(model, cfg, opt)
    data = token_batches(batch=args.batch, seq=args.seq,
                         vocab=cfg.vocab_size, steps=args.steps, seed=1)
    if mgr is not None:
        mgr.install_preemption_hook(lambda: (step, (params, opt_state), {}))

    t0 = time.time()
    for i, batch in enumerate(data):
        if i < step:  # skip-ahead after restore (exactly-once replay)
            continue
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in batch.items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        step = i + 1
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            toks = args.batch * args.seq * args.log_every
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"({toks / max(dt, 1e-9):,.0f} tok/s)", flush=True)
            t0 = time.time()
        if mgr is not None and mgr.should_save(step):
            mgr.save_async(step, (params, opt_state))
    if mgr is not None:
        mgr.save_async(step, (params, opt_state))
        mgr.wait()
    print("training complete at step", step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
