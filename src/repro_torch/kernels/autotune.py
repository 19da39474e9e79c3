"""Empirical kernel autotuner for the port's CUDA kernels (counterpart of
`repro.kernels.autotune`): time candidate (kernel, tile) choices per
exact key on the card and cache the winners in
``results/autotune_cache_cuda.json``.

What is tuned.  The reference tunes a variant (one-hot or CSR-run) and
an edge block.  Here a record names a kernel (`segment_pool` or
`segment_pool_runs`, `edge_mpnn` or `edge_mpnn_runs`) and its tile
height, a run-time argument of the C entries: fp32 edge tiles of 32, 64
or 128 edges, 16-bit edge tiles of 64 (so only the kernel is tuned
there), run-pool tiles of 16 or 32 rows at D >= 32 (none below: a piece
is a warp's 32 rows), and no tile for the any-order pool (each kernel
module's `tiles` lists what is built, its default first).  Tile 0 in a
record is a kernel without a tile knob at that shape.

Contract
--------
* **Keys are exact**: ``segment_pool|backend=cuda|d=64|dtype=float32|
  e=8000|layout=sorted|n=1000|reduce=sum|sm=90`` — the reference's
  attributes, plus `sm` (the card's compute capability: a record from
  another card is other work) and `e` (the edge count: on the H100 the
  best tile depends on how many tiles the grid holds, and the port's
  batches are padded to fixed sizes per rung and per step, so a key
  recurs).  Mean tunes as sum.
* **Sorted keys stay repeatable.**  The any-order kernels add by
  atomics, so their sums change order from call to call; the run kernels
  are bit-repeatable on sorted ids (`carry.cuh`).  A ``layout=sorted``
  key takes its winner from the run kernel only; the fastest any-order
  time stays in its ``candidates``.  The registry ignores a record that
  names an unknown kernel, a tile that is not built, or the any-order
  kernel on a sorted key.
* **Records**: ``{"variant", "tile", "us", "default_us", "candidates":
  {"kernel/tile": us}, "device"}``; `us` is device µs per call, and
  `default_us` the time of what the registry runs without a record (the
  run kernel on sorted ids, the any-order one otherwise, at its default
  tile).
* **Timing**: CUDA events on the current stream around `iters`
  back-to-back calls queued behind a sleep kernel, so the host's launch
  cost stays out of the device time; after a warm call, the median of 5
  such runs.
* **Consultation is a memoized dict read** (`lookup`): the file is read
  once per process and never synchronises the host, so a decision made
  inside a CUDA graph capture takes the tuned launch.  The registry
  consults only under ``use_autotune(True)`` or ``REPRO_AUTOTUNE=1``.
* **To clear**: delete the file or call :func:`clear`.  This file is
  never the reference's ``results/autotune_cache.json``, which the JAX
  package's bench writes.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.edge_mpnn import kernel as _mpnn_kernel
from repro_torch.kernels.segment_pool import kernel as _seg_kernel

DEFAULT_CACHE_PATH = build.REPO_ROOT / "results" / "autotune_cache_cuda.json"

# path -> parsed cache dict; one read per process, so lookups made while
# the kernels launch never touch the filesystem after the first
_LOADED: dict[str, dict] = {}

# timed runs a candidate, whose median is its time
_REPS = 5
# the longest sleep queued ahead of a timed run (cycles, ~0.6 s at the
# H100's clock): a host that cannot queue the calls ahead of that is
# measured wrongly, so tuning raises instead
_MAX_SLEEP_CYCLES = 1 << 30


def cache_key(kernel: str, **attrs) -> str:
    """Deterministic key: kernel name + sorted ``k=v`` attribute pairs."""
    parts = [kernel] + [f"{k}={v}" for k, v in sorted(attrs.items())]
    return "|".join(parts)


def dtype_name(dtype) -> str:
    """`torch.float32` or "float32" -> "float32" (the keys' spelling)."""
    return str(dtype).removeprefix("torch.")


@functools.cache
def _sm(index: int) -> int:
    major, minor = torch.cuda.get_device_capability(index)
    return 10 * major + minor


def device_sm(device: torch.device) -> int:
    """The compute capability of a CUDA device as one number (90 for
    sm_90), queried once per device."""
    index = device.index
    return _sm(torch.cuda.current_device() if index is None else index)


def pool_key(*, n: int, d: int, dtype, reduce: str, layout: str, e: int,
             sm: int) -> str:
    """The key of one segment reduction; mean is keyed as sum."""
    return cache_key("segment_pool", n=n, d=d, dtype=dtype_name(dtype),
                     reduce="sum" if reduce == "mean" else reduce,
                     layout=layout, backend="cuda", sm=sm, e=e)


def edge_key(*, n_src: int, n_tgt: int, ds: int, dt: int, m: int, dtype,
             activation: str, layout: str, e: int, sm: int) -> str:
    """The key of one fused edge convolution."""
    return cache_key("edge_mpnn", n_src=n_src, n_tgt=n_tgt, ds=ds, dt=dt,
                     m=m, dtype=dtype_name(dtype), activation=activation,
                     layout=layout, backend="cuda", sm=sm, e=e)


def _load(path: Path | str | None = None) -> dict:
    path = DEFAULT_CACHE_PATH if path is None else path
    key = str(path)
    if key not in _LOADED:
        try:
            with open(path) as f:
                data = json.load(f)
            _LOADED[key] = data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            _LOADED[key] = {}
    return _LOADED[key]


def lookup(key: str, path: Path | str | None = None) -> dict | None:
    """Cached winner for `key`, or None.  Pure dict read after first load."""
    rec = _load(path).get(key)
    return rec if isinstance(rec, dict) else None


def _store(key: str, rec: dict, path: Path | str | None) -> None:
    path = Path(DEFAULT_CACHE_PATH if path is None else path)
    cache = _load(path)
    cache[key] = rec
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def clear(path: Path | str | None = None) -> None:
    path = DEFAULT_CACHE_PATH if path is None else path
    _LOADED.pop(str(path), None)
    try:
        os.remove(path)
    except OSError:
        pass


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("autotuning times the CUDA kernels and needs a "
                           "CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _time_us(fn, iters: int) -> float:
    """Device µs per call of `fn`: CUDA events on the current stream
    around `iters` calls queued behind `torch.cuda._sleep`, so the device
    runs them back to back whatever the host's launch cost; a run the
    host did not queue in full before the device reached its start event
    is taken again behind a sleep twice as long.  The median of _REPS
    runs, after a warm call."""
    fn()
    torch.cuda.synchronize()
    times, cycles = [], 1 << 20
    while len(times) < _REPS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end) * 1e3 / iters)
        elif cycles < _MAX_SLEEP_CYCLES:
            cycles *= 2
        else:
            raise RuntimeError("the host could not queue the timed calls "
                               "ahead of the device")
    return statistics.median(times)


def _tune(key: str, kernels: dict, tiles, call, sorted_ids: bool,
          iters: int, path) -> dict:
    """Time `call(kernel, tile)` for every kernel in `kernels` ({name:
    wrapper}, the any-order kernel first, then the run kernel) at every
    tile `tiles(name)` lists (or tile 0 where none is built), pick the
    winner (the run kernel's only on sorted ids), store and return the
    record."""
    times = {}
    for name, kernel in kernels.items():
        for tile in tiles(name) or (0,):
            times[(name, tile)] = _time_us(
                lambda kernel=kernel, tile=tile: call(kernel, tile), iters)
    any_order, runs = list(kernels)
    eligible = [c for c in times if not (sorted_ids and c[0] == any_order)]
    best = min(eligible, key=times.get)
    default_kernel = runs if sorted_ids else any_order
    default = (default_kernel, (tiles(default_kernel) or (0,))[0])
    rec = {"variant": best[0], "tile": best[1],
           "us": round(times[best], 3),
           "default_us": round(times[default], 3),
           "candidates": {f"{k}/{t}": round(us, 3)
                          for (k, t), us in times.items()},
           "device": torch.cuda.get_device_name()}
    _store(key, rec, path)
    return rec


def tune_segment_pool(n_segments: int, d: int, *, dtype="float32",
                      reduce: str = "sum", sorted_ids: bool = True,
                      n_edges: int, iters: int = 10,
                      path: Path | str | None = None) -> dict:
    """Time `segment_pool` against `segment_pool_runs` at each of its
    tiles on seeded values [n_edges, d] with uniform ids (sorted when
    `sorted_ids`) and cache the winner.  Returns the winning record."""
    dev = _device()
    base = "sum" if reduce == "mean" else reduce
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n_segments, n_edges).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    torch_dtype = getattr(torch, dtype_name(dtype))
    vals = torch.from_numpy(rng.standard_normal((n_edges, d)).astype(
        np.float32)).to(dev, torch_dtype)
    ids = torch.from_numpy(ids).to(dev)
    key = pool_key(n=n_segments, d=d, dtype=torch_dtype, reduce=base,
                   layout="sorted" if sorted_ids else "unsorted",
                   e=n_edges, sm=device_sm(dev))
    return _tune(
        key, {"segment_pool": _seg_kernel.segment_pool,
              "segment_pool_runs": _seg_kernel.segment_pool_runs},
        lambda name: _seg_kernel.tiles(name, torch_dtype, d),
        lambda kernel, tile: kernel(vals, ids, n_segments=n_segments,
                                    reduce=base, tile=tile),
        sorted_ids, iters, path)


def tune_edge_mpnn(n_src: int, n_tgt: int, ds: int, dt: int, m: int, *,
                   dtype="float32", activation: str = "relu",
                   sorted_ids: bool = True, n_edges: int, iters: int = 10,
                   path: Path | str | None = None) -> dict:
    """Time `edge_mpnn` against `edge_mpnn_runs`, each at every tile
    height of the dtype, on seeded inputs with uniform ids (sorted by
    target when `sorted_ids`) and cache the winner."""
    dev = _device()
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    tgt = rng.integers(0, n_tgt, n_edges).astype(np.int32)
    if sorted_ids:
        order = np.argsort(tgt, kind="stable")
        src, tgt = src[order], tgt[order]
    torch_dtype = getattr(torch, dtype_name(dtype))
    h_src, h_tgt, w, b = (
        torch.from_numpy(a.astype(np.float32)).to(dev, torch_dtype)
        for a in (rng.standard_normal((n_src, ds)),
                  rng.standard_normal((n_tgt, dt)),
                  rng.standard_normal((ds + dt, m)) * 0.1,
                  rng.standard_normal((m,))))
    src, tgt = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
    key = edge_key(n_src=n_src, n_tgt=n_tgt, ds=ds, dt=dt, m=m,
                   dtype=torch_dtype, activation=activation,
                   layout="sorted" if sorted_ids else "unsorted",
                   e=n_edges, sm=device_sm(dev))
    return _tune(
        key, {"edge_mpnn": _mpnn_kernel.edge_mpnn,
              "edge_mpnn_runs": _mpnn_kernel.edge_mpnn_runs},
        lambda name: _mpnn_kernel.tiles(name, torch_dtype, m),
        lambda kernel, tile: kernel(h_src, h_tgt, src, tgt, w, b,
                                    n_src=n_src, n_tgt=n_tgt,
                                    activation=activation, tile=tile),
        sorted_ids, iters, path)
