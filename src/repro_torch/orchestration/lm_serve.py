"""Serve a small LM with batched requests through the continuous-batching
engine: prefill, one decode step a tick, slot recycling (the port's twin
of `examples/lm_serve.py`).

The defaults are the example's: `qwen1.5-4b-smoke`, 6 requests of 12
prompt tokens drawn from ``default_rng(0)``, 16 new tokens each, every
other request at temperature 0.8, 4 slots, max_len 128, weights drawn
from seed 0 (the port's draw, not `jax.random`'s).  `--arch` takes any
arch id the engine serves: the dense decoders, the MoE ones
(`granite-moe-3b-a800m-smoke`), `rwkv6-3b-smoke` (the example's own
docstring command) and `zamba2-1.2b-smoke`; Whisper needs its audio and
is served through its own `prefill` / `decode_step`.  Runs on CUDA
unless asked for the CPU (``--device cpu``):

    PYTHONPATH=src python -m repro_torch.orchestration.lm_serve
    PYTHONPATH=src python -m repro_torch.orchestration.lm_serve --device cpu
    PYTHONPATH=src python -m repro_torch.orchestration.lm_serve \
        --arch rwkv6-3b-smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.graph_tensor import resolve_device
from repro_torch.models.registry import build_model, get_config
from repro_torch.nn.layers import init_params
from repro_torch.serve.engine import Request, ServeEngine

N_SLOTS, MAX_LEN, PROMPT_LEN, SEED = 4, 128, 12, 0


def requests(cfg, n: int, new_tokens: int) -> list:
    """The example's requests: prompts from ``default_rng(0)``, greedy
    and temperature 0.8 in turn."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN)
                    .astype(np.int32),
                    max_new_tokens=new_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(n)]


def run(arch: str, n_requests: int, new_tokens: int, device=None,
        params=None) -> tuple:
    """(done requests, seconds, device name).  `params`: a reference
    parameter tree to serve instead of the seed-0 draw."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if params is None:
        with torch.no_grad():
            params = init_params(build_model(cfg, device), SEED)
    engine = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                         device=device)
    reqs = requests(cfg, n_requests, new_tokens)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return done, time.perf_counter() - t0, name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b-smoke")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    done, dt, name = run(args.arch, args.requests, args.new_tokens,
                         args.device)
    total_new = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s on {name})")
    for i, r in enumerate(done[:3]):
        print(f"req{i}: prompt={r.prompt[:6].tolist()}... "
              f"generated={r.generated[:8]}...")
    if len(done) != args.requests or not all(
            r.done and len(r.generated) >= args.new_tokens for r in done):
        print("lm_serve FAILED: a request is unfinished or short")
        return 1
    print("lm_serve OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
