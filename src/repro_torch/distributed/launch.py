"""Start a world of `torch.distributed` ranks on this host and collect
what each returns.

``run_ranks(target, world, args=..., kwargs=..., backend=...)`` spawns
`world`
processes (the spawn start method: a process forked after CUDA
initialization cannot use the card), joins them to one process group
through a `FileStore` in a fresh temporary directory (no port to race
for), calls ``target(*args, **kwargs)`` in each and returns the ranks' return
values in rank order.  `target` must be importable by name (a
module-level function).  A rank that raises, dies or outlives
``timeout_s`` fails the whole world: every rank still running is killed
and `RankFailure` names each rank's exit and the tail of its error.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence


class RankFailure(RuntimeError):
    """A rank of a `run_ranks` world failed or timed out."""


def _rank_main(target, rank: int, world: int, store: str, backend: str,
               args: tuple, kwargs: dict, out_dir: str,
               threads: Optional[int], device: Optional[str]) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.partition import initialize_distributed
    if threads:
        torch.set_num_threads(threads)
    if device is not None and device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device).index or 0)
    try:
        initialize_distributed(f"file://{store}", world, rank,
                               backend=backend)
        result = target(*args, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:  # noqa: BLE001 — recorded for the parent's
        #                     report, then re-raised: the rank exits non-zero
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: Callable, world: int, *, args: Sequence = (),
              kwargs: Optional[dict] = None, backend: str = "gloo",
              timeout_s: float = 300.0, threads: Optional[int] = None,
              device: Optional[str] = None) -> list:
    """``[target(*args, **kwargs) on rank r for r in range(world)]``, each
    rank in its own spawned process of one `torch.distributed` world.

    ``backend``: "gloo" or "nccl" (the caller's choice; NCCL needs a
    card a rank).  ``threads``: torch's intra-op threads a rank (several
    ranks share the host's cores).  ``device``: the CUDA device each
    rank makes current ("cuda" is card 0; two gloo ranks may share one
    card)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world, store, backend,
                                   tuple(args), dict(kwargs or {}), tmp,
                                   threads, device),
                             name=f"rank{r}")
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    failed = True
                    break
                for p in procs:
                    p.join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if failed or any(c != 0 for c in codes):
            raise RankFailure(_report(tmp, codes, timeout_s,
                                      time.monotonic() > deadline))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _report(tmp: str, codes: list, timeout_s: float, timed_out: bool
            ) -> str:
    lines = [f"ranks exited {codes}"
             + (f" (timed out after {timeout_s:.0f}s)" if timed_out else "")]
    for r, code in enumerate(codes):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r} (exit {code}) ---\n"
                             + f.read()[-3000:])
    return "\n".join(lines)

