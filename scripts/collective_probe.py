#!/usr/bin/env python3
"""Which collectives each torch.distributed backend takes on this machine.

Spawns two ranks on gloo (a `FileStore` in a temporary directory) and
calls every collective the port's mesh uses — `all_reduce`,
`all_gather_into_tensor`, `reduce_scatter_tensor`, `broadcast`,
`barrier` — on CPU tensors and, where a card is present, on CUDA tensors
of device 0 (both ranks share it).  Then one rank alone initializes
NCCL (world 1) and calls `all_reduce`.  Each result is the value check
or the error text, verbatim; the script prints one JSON object and
exits 0 whatever the backends accept (it is a probe, not a check).

    python3 scripts/collective_probe.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import traceback


def _ops(torch, dist, device, rank, world):
    out = {}

    def attempt(name, fn):
        try:
            ok = fn()
            out[name] = "ok" if ok else "wrong values"
        except Exception as exc:  # noqa: BLE001 — the probe records the
            #                       backend's refusal verbatim
            out[name] = f"{type(exc).__name__}: {exc}"[:400]

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=device)
        dist.all_reduce(x)
        return bool((x == sum(range(1, world + 1))).all())

    def all_gather():
        x = torch.full((2, 3), float(rank), device=device)
        y = torch.empty((2 * world, 3), device=device)
        dist.all_gather_into_tensor(y, x)
        return bool((y[2:] == 1).all()) and bool((y[:2] == 0).all())

    def reduce_scatter():
        x = torch.arange(2 * world, dtype=torch.float32, device=device)
        y = torch.empty((2,), device=device)
        dist.reduce_scatter_tensor(y, x)
        return bool((y == world * x[2 * rank:2 * rank + 2]).all())

    def broadcast():
        x = torch.full((3,), float(rank), device=device)
        dist.broadcast(x, 0)
        return bool((x == 0).all())

    def barrier():
        dist.barrier()
        return True

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("broadcast", broadcast), ("barrier", barrier)):
        attempt(name, fn)
    return out


def _gloo_rank(rank, world, store_path, result_path):
    import torch
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    found = {"cpu": _ops(torch, dist, "cpu", rank, world)}
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        found["cuda"] = _ops(torch, dist, "cuda:0", rank, world)
    dist.destroy_process_group()
    if rank == 0:
        with open(result_path, "w") as f:
            json.dump(found, f)


def _nccl_world1(result_path):
    import torch
    import torch.distributed as dist
    found = {}
    try:
        torch.cuda.set_device(0)
        store = dist.FileStore(result_path + ".store", 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        found["nccl_world1"] = "ok" if bool((x == 1).all()) else \
            "wrong values"
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — recorded verbatim
        found["nccl_world1"] = traceback.format_exc()[-1500:]
    with open(result_path, "w") as f:
        json.dump(found, f)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    report = {"python": sys.version.split()[0], "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "cuda_available": torch.cuda.is_available()}
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "gloo.json")
        procs = [ctx.Process(target=_gloo_rank,
                             args=(r, 2, os.path.join(tmp, "store"), result))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join()
        report["gloo_exitcodes"] = [p.exitcode for p in procs]
        if os.path.exists(result):
            with open(result) as f:
                report["gloo"] = json.load(f)
        if torch.cuda.is_available():
            result = os.path.join(tmp, "nccl.json")
            p = ctx.Process(target=_nccl_world1, args=(result,))
            p.start()
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join()
            report["nccl_exitcode"] = p.exitcode
            if os.path.exists(result):
                with open(result) as f:
                    report.update(json.load(f))
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
