#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the five hand-written CUDA kernels from the sources in the
checkout (one `nvcc` per source, all in parallel) and holds each against
its plain PyTorch version: `edge_mpnn` and `segment_pool` at the served
shapes, `edge_mpnn_runs` and `segment_pool_runs` at the trained shapes,
on sorted and unsorted ids (`segment_pool_runs` also at the 64-wide
chunks of the model-parallel mean model), and `flash_attention` at the
graph-attention shape of a training batch, the reference envelope's
corner and an LM causal GQA prefill.  Then it drives the port's paths at
the full width of the §8 OGBN-MAG model (init states -> 4-round
vanilla_mpnn over all five edge sets, 128 wide, LayerNorm -> root-node
head, 8 classes):

* serving: `repro_torch.serve.gnn.GNNServer` on the card, the same
  requests served twice in one call, eagerly and from one CUDA graph per
  bucket rung captured at warmup (`[serve]`, with a rung-8 batch's host
  stages, forward wall and device busy for both in `[profile]`); the
  mean-pooling variant of the same model from captured graphs
  (`[mean]`); then load generation through `repro_torch.serve.loadgen`
  over all 20000 papers (a closed loop of 4 clients x 125, an open loop
  at half its QPS for 5 s), the freshness step (`add_edges` bumps the
  store's version, stale entries are evicted, the resampled root's
  logits match the plain forward) and the twin
  `repro_torch.orchestration.gnn_serve.main([])` at the example's
  defaults, which must exit 0 (`[serveloop]`).  With graphs, launches
  are counted at capture (each rung's capture must hold the forward's
  20 `edge_mpnn` or `segment_pool` launches, replays none) and one
  replay of each rung is read through torch.profiler (20 such device
  kernels, no run kernel, no copy);
* training: `repro_torch.orchestration.trainer.Trainer` over a
  `StoreProvider` of target-sorted 16-root batches, AdamW +
  warmup-cosine, then an eval pass (`[train]`, `[train-mean]`), with the
  gradients of step 1 and the per-step losses held to the same run
  through the plain versions on the card;
* graph attention: `repro_torch.orchestration.gat_flash_parity.run`
  (`GraphSelfAttention` on the flash kernel) at the example's size and
  over the paper states of a training batch (`[attention]`);
* the model zoo: `rgcn`, `gcn`, `graph_sage`, `gatv2` and `hgt_like` on
  a training batch, gradients held to the plain path, and `gatv2` and
  `hgt_like` trained a few steps through the Trainer (`[zoo]`);
* the example twins in `repro_torch.orchestration` at the examples'
  defaults: `quickstart` against the plain versions (`[quickstart]`),
  `link_prediction` trained twice, bit-identical (`[linkpred]`), and
  `graph_classification` checkpointing to a temporary directory, with a
  run stopped at its first save and resumed that must repeat the
  uninterrupted losses exactly, and one full Graph Networks round
  against the plain path (`[graphcls]`);
* the sampler fleet: `[train]`'s run again through
  `runner.run(sampler="service")` over a process fleet of 2 workers
  forked from this CUDA-initialized process, each batch copied from
  pinned buffers on a side stream a step ahead, every loss bit-identical
  to `[train]`'s (`[service]`); and `repro_torch.orchestration.
  out_of_core.run` at the example's defaults, a thread fleet against a
  dial fleet of subprocess workers over an on-disk GraphDirectory:
  losses exactly equal, each worker's peak RSS below the directory's
  bytes (`[outofcore]`);
* the mesh (`[mesh]`): the §8 model trained by `Trainer(num_devices=,
  model_parallel=)` on super-batches of 4 component groups x 4 roots —
  (a) one rank, the sum model, held to the plain versions by the
  [train] rule; (b) 2 ranks sharing the card on gloo, (data=2), ZeRO-1
  optimizer state; (c) 2 ranks, (data=1, model=2), the mean model, its
  pools on 64-wide feature chunks; (d) one rank of the mean model —
  (b)'s losses held to (a)'s and (c)'s to (d)'s within 1e-4, (c)'s
  step-1 gradients to (d)'s by the [train] rule, (b)'s
  optimizer state a rank at most (a)'s / 1.8, 20 `edge_mpnn_runs` (sum)
  or `segment_pool_runs` (mean) a group forward on every rank; then the
  twin `repro_torch.orchestration.ogbn_mag_train.main(["--steps", "3"])`,
  which must exit 0;
* multi-host sampling (`[multihost]`): the `ogbn_mag_train` twin at
  ``--multihost 2 --num-devices 2`` (through `run_twin`, what its `main`
  runs), two processes of one gloo world sharing the card, rank 0
  hosting a `SamplerEndpoint` whose per-rank sampler fleets stream every
  rank's batches over loopback TCP; then the same argv without
  ``--multihost`` through `run_ranks`, the in-process stream on the same
  2-rank mesh.  Every per-step loss of each rank within 1e-4 of the
  in-process run's, 20 `edge_mpnn_runs` a group forward on each rank,
  and the step time, batch wait and roots/s of both runs and their
  ratio printed.

The run kernels fold in a fixed order on sorted ids, so `[kernels]`
holds them to 20 bit-identical repeats and `[train]` two independent
kernel runs to the same bits over all 24 steps.

Each path is run with every kernel's launch count set to 0 just before
it and read just after.  Each phase prints one line; any failure prints
``FAIL:`` and exits non-zero.  The line before the last is a JSON record
of every kernel (launches on its path, error against the plain version,
times on the card, bound; for the two pooling kernels also host and
device µs per call, device kernels per call, a second `index_add_`
yardstick and the zoo's score shape; for the two edge kernels device µs
and device kernels and memsets per call in fp32 and bf16, the build's
registers and spills over their instantiations, and the fp32 CUDA-core
and bf16 tensor-core bounds; for `flash_attention` at each of its three
shapes the fp32 and bf16 times, device us and device kernels per call,
the 3xTF32 bound (its `bound_ms`), the fp32 CUDA-core and bf16
tensor-core bounds, and the build's registers and spills; its text lines
add the CTA the C entry chose and the kv tiles its skip rule visits and
the pairs they compute against the pairs the mask allows);
the edge and pooling kernels' launch budgets (EDGE_BUDGET, POOL_BUDGET:
exact device kernels a call, each after at most one memset) and flash's
(at most two device kernels a call) fail the run past them, and each
fp32 edge case must stay within FP64_ERR_MULTIPLE of the plain version's
error against an fp64 result; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or without the `src/repro_torch` package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12        # fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12       # bf16 / fp16 on the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores

# the served model (paper §8 / examples/ogbn_mag_train.py, full width)
DIM = 128
FEAT_DIM = 128
N_CLASSES = 8
ROUNDS = 4
VOCAB = 4096
MAX_BATCH = 8
SEED = 0
DEVICE = "cuda"

# closed loop: one outstanding request per client, every root fresh; 500
# requests, so p99 is a tail and not the single slowest request
LOOP_CLIENTS = 4
LOOP_REQUESTS = 125

# training (examples/ogbn_mag_train.py: batch 16; lr 3e-3 over 600 steps
# with the Trainer's warmup 50 and weight decay 1e-5), cut to 24 steps of
# one epoch over 384 roots, then an eval pass over 64 held-out roots
TRAIN_BATCH = 16
TRAIN_STEPS = 24
EVAL_ROOTS = 64
TRAIN_LR = 3e-3
TRAIN_TOTAL = 600
MEAN_STEPS = 3
# kernel path vs plain path on the card: fp32 atomics sum in another
# order than index_add_, so gradients agree to a relative 1e-3 of each
# parameter's largest gradient entry, losses on shared parameters to 1e-4,
# and independent runs' losses to 1e-3 over their first PARITY_STEPS steps
GRAD_RTOL = 1e-3
LOSS_ATOL = 1e-3
PARITY_STEPS = 5
STEP_LOSS_ATOL = 1e-4
# the run kernels fold each sum in a fixed order on sorted ids (carry.cuh):
# REPEATS calls on the same inputs must return the same bits, and
# independent training runs on the kernel path the same losses
REPEATS = 20
# an edge kernel's fp32 error against the fp64 result, held to this
# multiple of the plain fp32 version's own (the product and the sum run
# in other orders than cuBLAS and index_add_, with errors of one size)
FP64_ERR_MULTIPLE = 4.0

# device kernels per call, held exactly (each after at most one memset):
# an any-order fp32 sum or edge call is one kernel; a run kernel's sum
# adds its carry fold (carry.cuh); max/min and 16-bit outputs add a
# finalize or cast pass
EDGE_BUDGET = {"edge_mpnn": {"fp32": 1, "bf16": 2},
               "edge_mpnn_runs": {"fp32": 2, "bf16": 3}}
POOL_BUDGET = {
    "segment_pool": {"sum fp32": 1, "max fp32": 2, "min fp32": 2,
                     "sum bf16": 2},
    "segment_pool_runs": {"sum fp32": 2, "max fp32": 2, "min fp32": 2,
                          "sum bf16": 3}}

# graph attention at full width: GraphSelfAttention(4 heads x 32) over the
# 128-wide paper states; the zoo at the reference's defaults, two of its
# models trained ZOO_STEPS steps on each path
ATTN_HEADS = 4
ATTN_PER_HEAD = 32
ZOO_STEPS = 3
# the LM prefill shape the flash kernel is also held at: qwen2.5-32b's
# attention (src/repro/configs/qwen2_5_32b.py: 40 q heads, 8 kv heads,
# d_model 5120 -> head width 128), batch 1, 2048 tokens, causal
PREFILL = dict(b=1, s=2048, h=40, kh=8, d=128)
# the mesh (`[mesh]`): super-batches of MESH_GROUPS component groups of
# MESH_ROOTS roots (16 roots a step, as [train]), MESH_STEPS steps a run;
# two ranks share the one card on gloo
MESH_GROUPS = 4
MESH_ROOTS = 4
MESH_STEPS = 12
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
MESH_LOSS_ATOL = 1e-4           # reference: tests/test_graph_sharding.py
MESH_ZERO_SHRINK = 1.8          # reference: tests/test_partition.py
# multi-host sampling: the ogbn_mag_train twin on two ranks, 24 steps of
# 16 roots; 600 papers, half the example's, since every process of both
# runs samples all of them before its first step (the phase stays under
# a minute)
MULTIHOST_STEPS = 24
MULTIHOST_PAPERS = 600
MULTIHOST_RANKS = 2


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    raise SystemExit(1)


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def time_ms(torch, fn, calls: int = 50, reps: int = 5,
            warmup: int = 5) -> float:
    """Per-call time (ms): CUDA events around `calls` back-to-back calls,
    so the device never waits on the host between them; the median of
    `reps` such runs.  Inputs stay in L2 (a few MB), as they do when the
    previous layer of the forward has just written them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200, reps: int = 5,
            warmup: int = 10) -> float:
    """Host µs per call to enqueue `fn`: the host clock around `calls`
    back-to-back calls with no synchronize among them (the device runs
    behind and never makes the host wait, unless `fn` itself syncs); the
    median of `reps` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_per_call(torch, fn, calls: int = 20, tries: int = 6) -> dict:
    """The device work of one call of `fn`, from torch.profiler over
    `calls` calls: device µs (kernels and memsets), and the kernels and
    memsets it ran, per call, with the kernels' names.  The profiler
    misses an event now and then, and now and then every event: a run
    that saw no device event, or in which some kernel's or memset's events
    are not a whole multiple of `calls`, is profiled again after a short
    pause, up to `tries` runs.  If the last still misses, a name short of
    a whole multiple by one event counts as that multiple (`missed`
    says how many such events), and a larger shortfall leaves its count
    fractional, so that a launch budget fails.  A name's device µs are
    its mean per event times its launches a call; `by_name` splits the
    device µs by kernel name (memsets under "memset"),
    `launches_by_name` the launches a call by the same names."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == cuda and ev.count]
        if events and all(ev.count % calls == 0 for ev in events):
            break
    us, kernels, memsets, missed, by_name, counts = 0.0, 0.0, 0.0, 0, {}, {}
    for ev in events:
        launches = ev.count / calls
        if -ev.count % calls == 1:  # one event missed
            launches, missed = -(-ev.count // calls), missed + 1
        ev_us = (getattr(ev, "self_device_time_total", 0) or 0) \
            / ev.count * launches
        us += ev_us
        if "memset" in ev.key.lower():
            memsets += launches
            name = "memset"
        else:
            kernels += launches
            name = ev.key.replace("(anonymous namespace)::", "")
            name = (name.split("(")[0].split("<")[0].split("::")[-1]
                    .removeprefix("void "))
        by_name[name] = by_name.get(name, 0.0) + ev_us
        counts[name] = counts.get(name, 0.0) + launches
    return dict(device_us=us, kernels=kernels, memsets=memsets,
                missed=missed, names=sorted(set(by_name) - {"memset"}),
                by_name=by_name, launches_by_name=counts)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def full_fp32(torch) -> None:
    """Every fp32 product in full fp32, as the kernels and the JAX
    reference compute: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    full_fp32(torch)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, TF32 off")
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(list(build.SOURCES))
    seconds = time.perf_counter() - t0
    for name, rep in report.items():
        usage = [f"{x['name']} {x.get('registers', '?')} registers "
                 f"{x.get('smem', 0)} B smem {x.get('spill_stores', '?')}/"
                 f"{x.get('spill_loads', '?')} B spills"
                 for x in ptxas_entries(rep["log"])]
        phase("build", f"{name}: {rep['seconds']:.1f}s; "
              + (" | ".join(usage) or "no ptxas report (cached build)"))
    phase("build", f"{len(report)} kernels built in parallel in "
          f"{seconds:.1f}s")
    return report


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the served shapes
# ---------------------------------------------------------------------------

def _close(torch, name, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        fail(f"{name}: max |kernel - plain| {err:.3e} exceeds rtol "
             f"{rtol} atol {atol}")
    return (got - want).abs().max().item()


def _close_sum(torch, name, got, want, abs_sum, counts, rtol) -> float:
    """`got` vs `want` where both are fp32 sums of `counts` terms per row
    whose absolute values sum to `abs_sum`, taken in different orders
    (tile runs and atomics vs index_add_).  Each order may be off by up
    to n * 2**-24 * sum|terms| (recursive summation), so a row of n terms
    is held to (rtol + 2 * n * 2**-24) * sum|terms| + 1e-6: rtol covers
    the terms themselves (an FMA chain vs a library matmul).  The
    training batches' padding edges form one run of thousands of edges
    into the padding node, where a plain relative tolerance on the sum
    would not hold for either order."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    tol = (rtol + 2 * counts.float()[:, None] * 2.0 ** -24) * abs_sum + 1e-6
    err = (got - want).abs()
    if bool((err > tol).any()):
        worst = int(torch.argmax((err - tol).max(1).values))
        fail(f"{name}: max |kernel - plain| {err.max().item():.3e}; row "
             f"{worst} ({int(counts[worst])} terms, sum|terms| "
             f"{abs_sum[worst].max().item():.3e}) exceeds its tolerance")
    return err.max().item()


def edge_fp64(torch, h_src, h_tgt, src, tgt, w, b, n_tgt, act):
    """The edge function of fp32 inputs in fp64 on the card: the result
    that both the fp32 kernel and the fp32 plain version approximate."""
    from repro_torch.kernels.edge_mpnn.ref import activate
    src, tgt = src.long(), tgt.long()
    valid = (tgt >= 0) & (tgt < n_tgt)
    x = torch.cat([h_src[src.clamp(0, h_src.shape[0] - 1)],
                   h_tgt[tgt.clamp(0, n_tgt - 1)]], dim=-1).double()
    msg = activate(x @ w.double() + b.double(), act)
    msg = torch.where(valid[:, None], msg, 0.0)
    return torch.zeros(n_tgt + 1, w.shape[1], dtype=torch.float64,
                       device=x.device).index_add_(
        0, torch.where(valid, tgt, n_tgt), msg)[:n_tgt]


def fp64_check(torch, name, got, want, exact) -> tuple:
    """(kernel, plain) max |fp32 - fp64| of an edge call: fails when the
    kernel's exceeds FP64_ERR_MULTIPLE times the plain version's."""
    kernel_err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    if kernel_err > FP64_ERR_MULTIPLE * plain_err:
        fail(f"{name}: |kernel - fp64| {kernel_err:.3e} exceeds "
             f"{FP64_ERR_MULTIPLE:g} x the plain version's {plain_err:.3e}")
    return kernel_err, plain_err


def repeat_check(torch, name, fn) -> None:
    """Fails unless REPEATS calls of `fn` return the same bits."""
    first = fn()
    for _ in range(REPEATS - 1):
        if not torch.equal(fn(), first):
            fail(f"{name}: {REPEATS} calls on the same inputs are not "
                 "bit-identical")


def _bound(nbytes: int, flops: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and fp32 operations over its fp32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_entries(log: str) -> list:
    """Every kernel instantiation in a `-Xptxas -v` build log, as dicts
    (name as `kernel<template arguments>`, registers, static shared
    memory, spill stores and loads in bytes); what a line does not say is
    left out, and nothing fails on a line it cannot read."""
    import re
    entries, current = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            current = dict(name=short_name(found.group(1)))
            entries.append(current)
        elif current is not None and "spill stores" in line:
            for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                got = re.search(pat, line)
                if got:
                    current[key] = int(got.group(1))
        elif current is not None and "Used" in line:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                got = re.search(pat, line)
                if got:
                    current[key] = int(got.group(1))
            current = None
    return entries


def short_name(mangled: str) -> str:
    """`name<1,2,...>` of an Itanium-mangled kernel name whose template
    arguments are integers or bools (`_ZN..16edge_mpnn_kernelILi0E..`),
    else the name as given."""
    import re
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = None
    while (got := re.match(r"(\d+)", rest)) is not None:
        n = int(got.group(1))
        name, rest = rest[got.end():got.end() + n], rest[got.end() + n:]
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)
    if name is None:
        return mangled
    if args is None:
        return name
    return f"{name}<{','.join(re.findall(r'L[a-z]+(\d+)E', args.group(1)))}>"


def ptxas_summary(entries: list, prefix: str) -> dict:
    """Registers (least, most) and the largest spills over the entries
    whose name starts with `prefix`."""
    mine = [x for x in entries if x["name"].startswith(prefix + "<")]
    regs = [x["registers"] for x in mine if "registers" in x]
    return dict(instantiations=len(mine),
                registers=[min(regs), max(regs)] if regs else None,
                spill_stores=max((x.get("spill_stores", 0) for x in mine),
                                 default=0),
                spill_loads=max((x.get("spill_loads", 0) for x in mine),
                                default=0))


def edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_out, isz) -> int:
    """Bytes one edge kernel call must move: the distinct (clamped)
    source rows and distinct target rows of the valid edges, W and b read
    once, both id arrays read once, the [n_tgt, M] output written once."""
    n_tgt = h_tgt.shape[0]
    valid = (tgt >= 0) & (tgt < n_tgt)
    rows_src = torch.unique(src[valid].clamp(0, h_src.shape[0] - 1)).numel()
    rows_tgt = torch.unique(tgt[valid]).numel()
    return ((rows_src * h_src.shape[1] + rows_tgt * h_tgt.shape[1]
             + w.numel() + b.numel() + n_out) * isz + 2 * src.numel() * 4)


def edge_kernel_costs(torch, kernel, args, kw, n_valid, n_out,
                      build_report) -> dict:
    """One edge kernel at (args, kw): device us and device kernels and
    memsets per call (torch.profiler) for fp32 and bf16, the bf16 time,
    the build's registers and spills over the kernel's instantiations,
    and two bounds: fp32 on the CUDA cores (the product that ships for
    fp32) and bf16 on the tensor cores, each the larger of its operations
    and its bytes (`edge_bytes`).  Fails unless each call runs exactly
    its EDGE_BUDGET kernels after at most 1 memset (the profiler may miss
    a memset event now and then, as in pool_launch_costs' check)."""
    name = kernel.__name__
    h_src, h_tgt, src, tgt, w, b = args
    ds, dt, m = h_src.shape[1], h_tgt.shape[1], w.shape[1]
    bf = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in args]
    fp32 = device_per_call(torch, lambda: kernel(*args, **kw))
    bf16 = device_per_call(torch, lambda: kernel(*bf, **kw))
    for label, cost in (("fp32", fp32), ("bf16", bf16)):
        want = EDGE_BUDGET[name][label]
        if cost["kernels"] != want or cost["memsets"] > 1:
            fail(f"{name}: a {label} call ran {cost['kernels']} device "
                 f"kernels ({cost['names']}) and {cost['memsets']} memsets "
                 f"({want} kernels and at most 1 memset expected)")
    flops = 2 * n_valid * (ds + dt) * m
    fp32_bound = _bound(edge_bytes(torch, *args, n_out, 4), flops)
    t_bytes = edge_bytes(torch, *args, n_out, 2) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    bf16_bound = (max(t_bytes, t_ops) * 1e3,
                  "bytes" if t_bytes >= t_ops else "operations")
    ms_bf16 = time_ms(torch, lambda: kernel(*bf, **kw))
    return dict(
        device_us=fp32["device_us"], device_kernels=fp32["kernels"],
        memsets=fp32["memsets"], device_names=fp32["names"],
        device_us_by_name=fp32["by_name"],
        bf16_ms=ms_bf16, bf16_device_us=bf16["device_us"],
        bf16_device_kernels=bf16["kernels"], bf16_memsets=bf16["memsets"],
        ptxas=ptxas_summary(ptxas_entries(build_report[name]["log"]),
                            f"{name}_kernel"),
        cuda_core_bound_ms=fp32_bound[0], cuda_core_bound_by=fp32_bound[1],
        tensor_bound_ms=bf16_bound[0], tensor_bound_by=bf16_bound[1])


def edge_costs_line(name, rec) -> str:
    """The [kernels] line of edge_kernel_costs' numbers."""
    p = rec["ptxas"]
    regs = ("-".join(map(str, p["registers"])) if p["registers"]
            else "not reported")
    return (f"{name} per call: fp32 device {rec['device_us']:.2f} us in "
            f"{rec['device_kernels']:g} kernel + {rec['memsets']:g} memset ("
            + ", ".join(f"{k} {v:.2f}"
                        for k, v in rec["device_us_by_name"].items())
            + "); "
            f"bf16 {rec['bf16_ms']:.4f} ms, device "
            f"{rec['bf16_device_us']:.2f} us in "
            f"{rec['bf16_device_kernels']:g} kernels + "
            f"{rec['bf16_memsets']:g} memset; build: {p['instantiations']} "
            f"instantiations, {regs} registers, at most "
            f"{p['spill_stores']}/{p['spill_loads']} B spill stores/loads; "
            f"bounds: fp32 CUDA cores {rec['cuda_core_bound_ms']:.5f} ms "
            f"({rec['cuda_core_bound_by']}, share of ms "
            f"{rec['cuda_core_bound_ms'] / rec['ms']:.3f}, of device time "
            f"{rec['cuda_core_bound_ms'] * 1e3 / rec['device_us']:.3f}), "
            f"bf16 tensor cores {rec['tensor_bound_ms']:.5f} ms "
            f"({rec['tensor_bound_by']}, share of bf16 ms "
            f"{rec['tensor_bound_ms'] / rec['bf16_ms']:.3f}, of device time "
            f"{rec['tensor_bound_ms'] * 1e3 / rec['bf16_device_us']:.3f})")


def served_inputs(torch) -> types.SimpleNamespace:
    """The has_topic conv at rung 8, drawn from seed SEED: n_src = 1224
    papers, n_tgt = 4896 fields, E = 4896 edges, 128 wide; ~5% padding
    edges (tgt >= n_tgt), and ~37% of the targets receive no edge.  `rng`
    and `normal` carry on the same draw."""
    dev = torch.device(DEVICE)
    n_src, n_tgt, e, d = 1224, 4896, 4896, DIM
    rng = np.random.default_rng(SEED)
    src = torch.from_numpy(rng.integers(0, n_src, e).astype(np.int32)).to(dev)
    tgt_np = rng.integers(0, n_tgt, e).astype(np.int32)
    tgt_np[rng.random(e) < 0.05] = n_tgt + 7  # padding edges

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    h_src, h_tgt = normal(n_src, d), normal(n_tgt, d)
    w, b = normal(2 * d, d, scale=(2 * d) ** -0.5), normal(d, scale=0.1)
    vals = normal(e, d)
    ints = torch.from_numpy(rng.integers(-8, 8, (e, d)).astype(np.float32)
                            ).to(dev)
    return types.SimpleNamespace(
        rng=rng, normal=normal, n_src=n_src, n_tgt=n_tgt, e=e, d=d, src=src,
        tgt=torch.from_numpy(tgt_np).to(dev),
        n_valid=int((tgt_np < n_tgt).sum()),
        n_empty=n_tgt - len(np.unique(tgt_np[tgt_np < n_tgt])),
        h_src=h_src, h_tgt=h_tgt, w=w, b=b, vals=vals, ints=ints)


def pool_launch_costs(torch, kernel, vals, ids, n) -> dict:
    """One pooling kernel's launch costs at (vals, ids): host µs to
    enqueue an fp32 sum, its device µs, kernels and memsets per call
    (torch.profiler), and the device kernels per call of max, min and a
    bf16 sum.  Fails unless every case runs exactly its POOL_BUDGET
    kernels and an fp32 sum at most one memset."""
    name = kernel.__name__
    fn = functools.partial(kernel, vals, ids, n_segments=n)
    dev = device_per_call(torch, fn)
    by_case = {"sum fp32": dev["kernels"]}
    for label, reduce, dtype in (("max fp32", "max", torch.float32),
                                 ("min fp32", "min", torch.float32),
                                 ("sum bf16", "sum", torch.bfloat16)):
        by_case[label] = device_per_call(torch, functools.partial(
            kernel, vals.to(dtype), ids, n_segments=n,
            reduce=reduce))["kernels"]
    if dev["memsets"] > 1:
        fail(f"{name}: an fp32 sum ran {dev['memsets']} memsets per call "
             "(at most 1 expected)")
    for label, k in by_case.items():
        if k != POOL_BUDGET[name][label]:
            fail(f"{name}: {label} ran {k} device kernels per call "
                 f"({dev['names']} for the fp32 sum; "
                 f"{POOL_BUDGET[name][label]} expected)")
    return dict(host_us=host_us(torch, fn), device_us=dev["device_us"],
                device_kernels=dev["kernels"], memsets=dev["memsets"],
                device_us_by_name=dev["by_name"], kernels_by_case=by_case)


def host_breakdown(torch, vals, ids, n) -> dict:
    """Host µs per call of each step of the launch path of an fp32 sum at
    (vals, ids): the wrapper's steps one by one (dtype code, allocation,
    stream handle, the ctypes entry call that launches), the wrapper
    whole, and the registry's steps around it (kernel_ids, the autograd
    Function, `segment_reduce` with and without a gradient to record, the
    count of the mean)."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.segment_pool import kernel as seg
    index = vals.get_device()
    e, d = vals.shape
    ids64 = ids.long()
    leaf = vals.detach().clone().requires_grad_(True)
    out = vals.new_empty((n, d))
    stream = torch.cuda.current_stream(index).cuda_stream
    entry = seg._entry("segment_pool")
    args = (vals.data_ptr(), ids.data_ptr(), out.data_ptr(), out.data_ptr(),
            e, d, n, seg._DTYPE_CODES[vals.dtype], seg._REDUCE_CODES["sum"],
            stream)
    off = contextlib.nullcontext
    steps = {
        "dtype code, dict by torch.dtype": (
            lambda: seg._DTYPE_CODES[vals.dtype], off),
        "values.new_empty [N, D]": (lambda: vals.new_empty((n, d)), off),
        "current_stream(index).cuda_stream": (
            lambda: torch.cuda.current_stream(index).cuda_stream, off),
        "ctypes entry call (launches)": (lambda: entry(*args), off),
        "wrapper segment_pool": (
            lambda: seg.segment_pool(vals, ids, n_segments=n), off),
        "kernel_ids int64 -> int32": (lambda: registry.kernel_ids(ids64),
                                      off),
        "SegmentPoolFunction.apply, grad": (
            lambda: registry.SegmentPoolFunction.apply(
                leaf, ids, n, "sum", seg.segment_pool), off),
        "SegmentPoolFunction.apply, inference": (
            lambda: registry.SegmentPoolFunction.apply(
                vals, ids, n, "sum", seg.segment_pool), torch.inference_mode),
        "segment_reduce sum, grad": (
            lambda: registry.segment_reduce(leaf, ids64, n, "sum",
                                            sorted_ids=False), off),
        "segment_reduce sum, inference": (
            lambda: registry.segment_reduce(vals, ids64, n, "sum",
                                            sorted_ids=False),
            torch.inference_mode),
        "segment_count": (lambda: registry.segment_count(ids64, n), off),
        "segment_reduce mean, inference": (
            lambda: registry.segment_reduce(vals, ids64, n, "mean",
                                            sorted_ids=False),
            torch.inference_mode),
    }
    result = {}
    for label, (fn, ctx) in steps.items():
        with ctx():
            result[label] = host_us(torch, fn)
    return result


BINCOUNT = "torch.bincount (control)"


def sync_check(torch, batch) -> dict:
    """Mean pooling (both pooling kernels) and `node_degree` on the card
    under torch.cuda.set_sync_debug_mode("error"): {op: None, or the
    error a host sync raised}.  A control, `BINCOUNT` of the same ids,
    must raise: it reads the ids' max back to the host to size its
    output, so it shows that the mode sees a sync."""
    from repro_torch.core import ops
    from repro_torch.core.graph_tensor import TARGET
    from repro_torch.kernels import registry
    feat = torch.ones(batch.edge_sets["has_topic"].capacity, DIM,
                      device=DEVICE)

    def mean(sorted_ids):
        def run():
            with registry.layout(sorted_by_target=sorted_ids):
                ops.pool_edges_to_node(batch, "has_topic", TARGET, "mean",
                                       feature_value=feat)
        return run

    cases = {"mean, segment_pool_runs": mean(True),
             "mean, segment_pool": mean(False),
             "node_degree": lambda: ops.node_degree(batch, "has_topic",
                                                    TARGET),
             BINCOUNT: lambda: torch.bincount(
                 batch.edge_sets["has_topic"].adjacency.target.long()
                 .clamp(min=0))}
    result = {}
    for name, fn in cases.items():
        fn()  # first calls (library loads) are not the steady state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            result[name] = None
        except RuntimeError as err:
            result[name] = str(err).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return result


def index_add_yardsticks(torch, vals, ids, n) -> tuple:
    """(ms, ms) of the two library yardsticks of an fp32 segment sum, timed
    only (the port never calls them): `index_add_` into an accumulator
    allocated once and never zeroed again, and the whole function in one
    expression, `torch.zeros(N + 1, D).index_add_(...)`, with padding ids
    on the spare row."""
    safe = torch.where(ids < n, ids, n).long()
    acc = torch.zeros(n + 1, vals.shape[1], device=vals.device)
    return (time_ms(torch, lambda: acc.index_add_(0, safe, vals)),
            time_ms(torch, lambda: torch.zeros(
                n + 1, vals.shape[1], device=vals.device).index_add_(
                    0, safe, vals)))


def kernels_phase(torch, build_report):
    """Each kernel of the served conv (`served_inputs`) against its plain
    version, timed beside its bound and a library call."""
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref

    dev = torch.device(DEVICE)
    s = served_inputs(torch)
    n_src, n_tgt, e, d = s.n_src, s.n_tgt, s.e, s.d
    rng, normal, src, tgt = s.rng, s.normal, s.src, s.tgt
    n_valid, n_empty = s.n_valid, s.n_empty
    h_src, h_tgt, w, b = s.h_src, s.h_tgt, s.w, s.b
    records = {}

    # -- edge_mpnn ----------------------------------------------------------
    errs, fp64_errs = [], []
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        args = [t.to(dtype) for t in (h_src, h_tgt)]
        wb = [t.to(dtype) for t in (w, b)]
        for act in ("relu", "gelu", "identity"):
            got = edge_mpnn(args[0], args[1], src, tgt, wb[0], wb[1],
                            n_src=n_src, n_tgt=n_tgt, activation=act)
            want = edge_mpnn_ref(args[0], args[1], src, tgt, wb[0], wb[1],
                                 n_src=n_src, n_tgt=n_tgt, activation=act)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (n_tgt, d):
                fail(f"edge_mpnn: got {got.dtype} {tuple(got.shape)}")
            err = _close(torch, f"edge_mpnn[{dtype}, {act}]", got, want,
                         rtol, atol)
            if dtype == torch.float32:
                errs.append(err)
                fp64_errs.append(fp64_check(
                    torch, f"edge_mpnn[{act}] vs fp64", got, want,
                    edge_fp64(torch, h_src, h_tgt, src, tgt, w, b, n_tgt,
                              act)))
    ms = time_ms(torch, lambda: edge_mpnn(h_src, h_tgt, src, tgt, w, b,
                                          n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    bound_ms, bound_by = _bound(
        edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_tgt * d, 4),
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn"] = dict(
        name="edge_mpnn", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:182",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
        fp64_err=max(k for k, _ in fp64_errs),
        plain_fp64_err=max(p for _, p in fp64_errs))
    records["edge_mpnn"].update(edge_kernel_costs(
        torch, edge_mpnn, (h_src, h_tgt, src, tgt, w, b),
        dict(n_src=n_src, n_tgt=n_tgt), n_valid, n_tgt * d, build_report))
    phase("kernels", f"edge_mpnn fp32/bf16 x relu/gelu/identity match the "
          f"plain version (fp32 max err {max(errs):.2e}); vs fp64 "
          f"(relu, gelu, identity) kernel / plain "
          + ", ".join(f"{k:.2e} / {p:.2e}" for k, p in fp64_errs)
          + f" (kernel held to {FP64_ERR_MULTIPLE:g}x plain); fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{records['edge_mpnn']['bound_ms']:.4f} ms "
          f"({records['edge_mpnn']['bound_by']}); {n_valid} valid edges")
    phase("kernels", edge_costs_line("edge_mpnn", records["edge_mpnn"]))

    # -- segment_pool --------------------------------------------------------
    vals, ints = s.vals, s.ints
    got = segment_pool(ints, tgt, n_segments=n_tgt, reduce="sum")
    want = segment_pool_ref(ints, tgt, n_segments=n_tgt, reduce="sum")
    if not torch.equal(got, want):
        fail("segment_pool: integer-valued fp32 sums are not bit-identical")
    for reduce in ("max", "min"):
        got = segment_pool(vals, tgt, n_segments=n_tgt, reduce=reduce)
        want = segment_pool_ref(vals, tgt, n_segments=n_tgt, reduce=reduce)
        if not torch.equal(got, want):
            fail(f"segment_pool: {reduce} differs from the plain version")
    empty_rows = torch.ones(n_tgt, dtype=torch.bool, device=dev)
    empty_rows[tgt[tgt < n_tgt].long()] = False
    if got[empty_rows].abs().max().item() != 0:
        fail("segment_pool: empty segments must yield 0")
    err = _close(torch, "segment_pool[sum, fp32]",
                 segment_pool(vals, tgt, n_segments=n_tgt),
                 segment_pool_ref(vals, tgt, n_segments=n_tgt), 1e-5, 1e-5)
    vb = vals.to(torch.bfloat16)
    got = segment_pool(vb, tgt, n_segments=n_tgt)
    if got.dtype != torch.bfloat16:
        fail(f"segment_pool: bf16 input gave {got.dtype}")
    _close(torch, "segment_pool[sum, bf16]", got,
           segment_pool_ref(vb, tgt, n_segments=n_tgt), 2e-2, 2e-2)
    ms = time_ms(torch, lambda: segment_pool(vals, tgt, n_segments=n_tgt))
    plain_ms = time_ms(torch, lambda: segment_pool_ref(
        vals, tgt, n_segments=n_tgt))
    library_ms, zeroed_ms = index_add_yardsticks(torch, vals, tgt, n_tgt)
    # padding rows' values are never read
    isz = 4
    bound_ms, bound_by = _bound(n_valid * d * isz + e * 4 + n_tgt * d * isz,
                                n_valid * d)
    costs = pool_launch_costs(torch, segment_pool, vals, tgt, n_tgt)
    steps = host_breakdown(torch, vals, tgt, n_tgt)
    records["segment_pool"] = dict(
        name="segment_pool", route="cuda",
        source="src/repro_torch/kernels/segment_pool/segment_pool.cu",
        replaces="src/repro/kernels/segment_pool/kernel.py:193",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_zeroed_ms=zeroed_ms, **costs, host_steps_us=steps)
    phase("kernels", f"segment_pool: int sums bit-exact, max/min exact, "
          f"sum fp32 max err {err:.2e}, bf16 cast back; {n_empty} empty "
          f"segments; sum {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"index_add_ {library_ms:.4f} ms (zeros + index_add_ "
          f"{zeroed_ms:.4f} ms), bound {bound_ms:.4f} ms; per call: host "
          f"{costs['host_us']:.2f} us, device {costs['device_us']:.2f} us, "
          f"device kernels {costs['kernels_by_case']}, memsets "
          f"{costs['memsets']}")
    phase("kernels", "segment_pool launch path, host us per call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))

    # -- widths past one tile: edge_mpnn walks M in 64-column tiles, and
    # segment_pool has no width limit, so a wider model stays on both
    n_w, e_w = 300, 1000
    src_w = torch.from_numpy(rng.integers(0, n_w, e_w).astype(np.int32)
                             ).to(dev)
    tgt_w = torch.from_numpy(rng.integers(0, n_w + 5, e_w).astype(np.int32)
                             ).to(dev)  # >= n_w: padding
    h_w = normal(n_w, 256)
    w_w, b_w = normal(512, 384, scale=512 ** -0.5), normal(384, scale=0.1)
    mpnn_err = _close(
        torch, "edge_mpnn[fp32, 256+256 -> 384]",
        edge_mpnn(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w, n_tgt=n_w),
        edge_mpnn_ref(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                      n_tgt=n_w), 1e-5, 1e-5)
    v_w = normal(e_w, 640)
    pool_err = _close(torch, "segment_pool[sum, fp32, 640 wide]",
                      segment_pool(v_w, tgt_w, n_segments=n_w),
                      segment_pool_ref(v_w, tgt_w, n_segments=n_w),
                      1e-5, 1e-5)
    phase("kernels", f"wide: edge_mpnn 512 -> 384 (six column tiles) max "
          f"err {mpnn_err:.2e}, segment_pool 640 wide max err "
          f"{pool_err:.2e}")
    return records


def trained_inputs(torch, batch) -> types.SimpleNamespace:
    """The has_topic conv of the first 16-root training batch (n_src
    papers, n_tgt fields, E edges, 128 wide), its targets sorted as the
    batcher emits them (padding last) and in a seeded random order, with
    values drawn from seed SEED + 4, and the zoo's attention scores on the
    same edges ([E, 4]: gatv2 / hgt_like's 4 heads)."""
    from repro_torch.kernels.registry import kernel_ids
    dev = torch.device(DEVICE)
    es = batch.edge_sets["has_topic"]
    n_src = batch.node_sets["paper"].capacity
    n_tgt = batch.node_sets["field_of_study"].capacity
    e, d = es.capacity, DIM
    src = kernel_ids(es.adjacency.source)
    tgt = kernel_ids(torch.where(es.mask(), es.adjacency.target,
                                 torch.full_like(es.adjacency.target,
                                                 n_tgt)))
    if not bool((tgt[1:] >= tgt[:-1]).all()):
        fail("training batch: has_topic targets are not sorted")
    rng = np.random.default_rng(SEED + 4)
    perm = torch.from_numpy(rng.permutation(e)).to(dev)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    h_src, h_tgt = normal(n_src, d), normal(n_tgt, d)
    w, b = normal(2 * d, d, scale=(2 * d) ** -0.5), normal(d, scale=0.1)
    vals = normal(e, d)
    ints = torch.from_numpy(rng.integers(-8, 8, (e, d)).astype(np.float32)
                            ).to(dev)
    scores = normal(e, ATTN_HEADS)
    return types.SimpleNamespace(
        rng=rng, normal=normal, n_src=n_src, n_tgt=n_tgt, e=e, d=d,
        layouts={"sorted": (src, tgt), "unsorted": (src[perm], tgt[perm])},
        src=src, tgt=tgt, n_valid=int((tgt < n_tgt).sum()),
        n_runs=int(torch.unique(tgt[tgt < n_tgt]).numel()),
        counts=torch.zeros(n_tgt + 1, dtype=torch.int64, device=dev
                           ).index_add_(0, tgt.long(),
                                        torch.ones_like(tgt.long()))[:n_tgt],
        h_src=h_src, h_tgt=h_tgt, w=w, b=b, vals=vals, ints=ints,
        scores=scores)


def runs_kernels_phase(torch, batch, records, build_report):
    """The run kernels at the trained shape (`trained_inputs`), on sorted
    and unsorted ids, and `segment_pool_runs` at the zoo's score shape."""
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn, edge_mpnn_runs
    from repro_torch.kernels.edge_mpnn.ref import activate, edge_mpnn_ref
    from repro_torch.kernels.segment_pool.kernel import (segment_pool,
                                                         segment_pool_runs)
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref

    dev = torch.device(DEVICE)
    t = trained_inputs(torch, batch)
    n_src, n_tgt, e, d = t.n_src, t.n_tgt, t.e, t.d
    rng, normal, src, tgt, layouts = t.rng, t.normal, t.src, t.tgt, t.layouts
    n_valid, n_runs, counts = t.n_valid, t.n_runs, t.counts
    h_src, h_tgt, w, b = t.h_src, t.h_tgt, t.w, t.b

    def message_sums(act):
        """Per target row, the sum of |message| over its edges."""
        x = torch.cat([h_src[src.long()], h_tgt[tgt.clamp(max=n_tgt - 1)
                                                .long()]], dim=-1)
        msg = activate(x @ w + b, act)
        msg = torch.where((tgt < n_tgt)[:, None], msg.abs(), 0.0)
        return torch.zeros(n_tgt + 1, d, device=dev).index_add_(
            0, tgt.long(), msg)[:n_tgt]

    # -- edge_mpnn_runs ------------------------------------------------------
    errs, fp64_errs = [], []
    for act in ("relu", "gelu", "identity"):
        abs_sum = message_sums(act)
        for layout, (s_ids, t_ids) in layouts.items():
            for dtype in (torch.float32, torch.bfloat16):
                args = [t.to(dtype) for t in (h_src, h_tgt, w, b)]
                got = edge_mpnn_runs(args[0], args[1], s_ids, t_ids,
                                     args[2], args[3], n_src=n_src,
                                     n_tgt=n_tgt, activation=act)
                want = edge_mpnn_ref(args[0], args[1], s_ids, t_ids,
                                     args[2], args[3], n_src=n_src,
                                     n_tgt=n_tgt, activation=act)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != (n_tgt, d):
                    fail(f"edge_mpnn_runs: got {got.dtype} "
                         f"{tuple(got.shape)}")
                name = f"edge_mpnn_runs[{layout}, {dtype}, {act}]"
                if dtype == torch.float32:
                    errs.append(_close_sum(torch, name, got, want, abs_sum,
                                           counts, 1e-5))
                    fp64_errs.append(fp64_check(
                        torch, f"{name} vs fp64", got, want, edge_fp64(
                            torch, h_src, h_tgt, s_ids, t_ids, w, b, n_tgt,
                            act)))
                else:  # the cast back to bf16 dominates
                    _close(torch, name, got, want, 2e-2, 2e-2)
    # sorted targets: every call returns the same bits (carry.cuh), the
    # padding node's run across its tiles included
    for act in ("relu", "gelu", "identity"):
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in (h_src, h_tgt, w, b)]
            repeat_check(torch, f"edge_mpnn_runs[sorted, {dtype}, {act}]",
                         lambda: edge_mpnn_runs(
                             args[0], args[1], src, tgt, args[2], args[3],
                             n_src=n_src, n_tgt=n_tgt, activation=act))
    ms = time_ms(torch, lambda: edge_mpnn_runs(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    any_order_ms = time_ms(torch, lambda: edge_mpnn(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    bound_ms, bound_by = _bound(
        edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_tgt * d, 4),
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn_runs"] = dict(
        name="edge_mpnn_runs", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn_runs.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:129",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
        fp64_err=max(k for k, _ in fp64_errs),
        plain_fp64_err=max(p for _, p in fp64_errs))
    records["edge_mpnn_runs"].update(edge_kernel_costs(
        torch, edge_mpnn_runs, (h_src, h_tgt, src, tgt, w, b),
        dict(n_src=n_src, n_tgt=n_tgt), n_valid, n_tgt * d, build_report))
    phase("kernels", f"edge_mpnn_runs sorted+unsorted x fp32/bf16 x "
          f"relu/gelu/identity match the plain version (fp32 max err "
          f"{max(errs):.2e}, the padding node's {int(counts.max())}-edge "
          f"run; vs fp64, worst of the 3 x 2 fp32 cases: kernel "
          f"{records['edge_mpnn_runs']['fp64_err']:.2e}, plain "
          f"{records['edge_mpnn_runs']['plain_fp64_err']:.2e}, held to "
          f"{FP64_ERR_MULTIPLE:g}x; sorted: {REPEATS} calls bit-identical "
          f"in fp32 and bf16); trained shape n_src {n_src} n_tgt {n_tgt} "
          f"E {e} ({n_valid} valid, {n_runs} target runs): sorted fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs edge_mpnn "
          f"{any_order_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    phase("kernels", edge_costs_line("edge_mpnn_runs",
                                     records["edge_mpnn_runs"]))

    # -- segment_pool_runs ---------------------------------------------------
    vals, ints = t.vals, t.ints
    abs_sum = segment_pool_ref(vals.abs(), tgt, n_segments=n_tgt)
    err = 0.0
    for layout, (_, t_ids) in layouts.items():
        kw = dict(n_segments=n_tgt)
        if not torch.equal(segment_pool_runs(ints, t_ids, **kw),
                           segment_pool_ref(ints, t_ids, **kw)):
            fail(f"segment_pool_runs[{layout}]: integer-valued fp32 sums "
                 "are not bit-identical")
        for reduce in ("max", "min"):
            if not torch.equal(
                    segment_pool_runs(vals, t_ids, reduce=reduce, **kw),
                    segment_pool_ref(vals, t_ids, reduce=reduce, **kw)):
                fail(f"segment_pool_runs[{layout}]: {reduce} differs from "
                     "the plain version")
        err = max(err, _close_sum(
            torch, f"segment_pool_runs[{layout}, sum, fp32]",
            segment_pool_runs(vals, t_ids, **kw),
            segment_pool_ref(vals, t_ids, **kw), abs_sum, counts, 0.0))
        vb = vals.to(torch.bfloat16)  # the cast back dominates
        got = segment_pool_runs(vb, t_ids, **kw)
        if got.dtype != torch.bfloat16:
            fail(f"segment_pool_runs: bf16 input gave {got.dtype}")
        _close(torch, f"segment_pool_runs[{layout}, sum, bf16]", got,
               segment_pool_ref(vb, t_ids, **kw), 2e-2, 2e-2)
    # sorted ids: every sum returns the same bits (carry.cuh), at the
    # trained shape and at drawn runs of 1 to 3000 rows, 128 and 4 wide
    for dtype in (torch.float32, torch.bfloat16):
        x = vals.to(dtype)
        repeat_check(torch, f"segment_pool_runs[sorted, sum, {dtype}]",
                     lambda: segment_pool_runs(x, tgt, n_segments=n_tgt))
    lengths = rng.integers(1, 3001, 12)
    long_ids = torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths)
                                .astype(np.int32)).to(dev)
    long_counts = torch.from_numpy(lengths).to(dev)
    for width in (d, ATTN_HEADS):
        x = normal(long_ids.numel(), width)
        got = segment_pool_runs(x, long_ids, n_segments=len(lengths))
        _close_sum(torch, f"segment_pool_runs[runs of 1-3000, D {width}]",
                   got, segment_pool_ref(x, long_ids,
                                         n_segments=len(lengths)),
                   segment_pool_ref(x.abs(), long_ids,
                                    n_segments=len(lengths)),
                   long_counts, 0.0)
        repeat_check(torch, f"segment_pool_runs[runs of 1-3000, D {width}]",
                     lambda: segment_pool_runs(x, long_ids,
                                               n_segments=len(lengths)))
    exact = torch.zeros(n_tgt + 1, d, dtype=torch.float64, device=dev
                        ).index_add_(0, tgt.long(), vals.double())[:n_tgt]
    kernel_err = (segment_pool_runs(vals, tgt, n_segments=n_tgt).double()
                  - exact).abs().max()
    plain_err = (segment_pool_ref(vals, tgt, n_segments=n_tgt).double()
                 - exact).abs().max()
    ms = time_ms(torch, lambda: segment_pool_runs(vals, tgt,
                                                  n_segments=n_tgt))
    plain_ms = time_ms(torch, lambda: segment_pool_ref(vals, tgt,
                                                       n_segments=n_tgt))
    any_order_ms = time_ms(torch, lambda: segment_pool(vals, tgt,
                                                       n_segments=n_tgt))
    library_ms, zeroed_ms = index_add_yardsticks(torch, vals, tgt, n_tgt)
    isz = 4
    bound_ms, bound_by = _bound(n_valid * d * isz + e * 4 + n_tgt * d * isz,
                                n_valid * d)
    costs = pool_launch_costs(torch, segment_pool_runs, vals, tgt, n_tgt)
    records["segment_pool_runs"] = dict(
        name="segment_pool_runs", route="cuda",
        source="src/repro_torch/kernels/segment_pool/runs.cu",
        replaces="src/repro/kernels/segment_pool/kernel.py:142",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_zeroed_ms=zeroed_ms, any_order_ms=any_order_ms, **costs)
    phase("kernels", f"segment_pool_runs sorted+unsorted: int sums "
          f"bit-exact, max/min exact, sorted sums {REPEATS} calls "
          f"bit-identical (fp32, bf16; also at runs of "
          f"{int(lengths.min())}-{int(lengths.max())} rows, D {d} and "
          f"{ATTN_HEADS}), sum fp32 max err {err:.2e} (vs "
          f"fp64: kernel {kernel_err.item():.2e}, plain "
          f"{plain_err.item():.2e}), bf16 cast back; sorted sum {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs segment_pool {any_order_ms:.4f} ms "
          f"vs index_add_ {library_ms:.4f} ms (zeros + index_add_ "
          f"{zeroed_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by}); per "
          f"call: host {costs['host_us']:.2f} us, device "
          f"{costs['device_us']:.2f} us ("
          + ", ".join(f"{k} {v:.2f}"
                      for k, v in costs["device_us_by_name"].items())
          + f"), device kernels "
          f"{costs['kernels_by_case']}, memsets {costs['memsets']}")

    # -- the zoo's attention scores: segment_softmax's max and exp-sum over
    # [E, 4] on the same sorted targets (gatv2 / hgt_like, 4 heads)
    scores = t.scores
    smax = segment_pool_runs(scores, tgt, n_segments=n_tgt, reduce="max")
    if not torch.equal(smax, segment_pool_ref(scores, tgt, n_segments=n_tgt,
                                              reduce="max")):
        fail("segment_pool_runs[D 4, max] differs from the plain version")
    ex = torch.where((tgt < n_tgt)[:, None],
                     torch.exp(scores - smax[tgt.clamp(max=n_tgt - 1).long()]),
                     0.0)
    ex_sum = segment_pool_ref(ex, tgt, n_segments=n_tgt)
    d4_err = _close_sum(torch, "segment_pool_runs[D 4, sum]",
                        segment_pool_runs(ex, tgt, n_segments=n_tgt), ex_sum,
                        ex_sum, counts, 0.0)
    repeat_check(torch, "segment_pool_runs[D 4, sum]",
                 lambda: segment_pool_runs(ex, tgt, n_segments=n_tgt))
    d4_bound = _bound(n_valid * ATTN_HEADS * isz + e * 4
                      + n_tgt * ATTN_HEADS * isz, n_valid * ATTN_HEADS)
    d4 = {}
    for reduce, x in (("max", scores), ("sum", ex)):
        kernel_fn = functools.partial(segment_pool_runs, x, tgt,
                                      n_segments=n_tgt, reduce=reduce)
        dev_cost = device_per_call(torch, kernel_fn)
        if dev_cost["kernels"] != POOL_BUDGET["segment_pool_runs"][
                f"{reduce} fp32"]:
            fail(f"segment_pool_runs[D 4, {reduce}]: {dev_cost['kernels']} "
                 "device kernels per call")
        d4[reduce] = dict(
            ms=time_ms(torch, kernel_fn),
            plain_ms=time_ms(torch, functools.partial(
                segment_pool_ref, x, tgt, n_segments=n_tgt, reduce=reduce)),
            host_us=host_us(torch, kernel_fn),
            device_us=dev_cost["device_us"],
            device_kernels=dev_cost["kernels"], memsets=dev_cost["memsets"],
            bound_ms=d4_bound[0])
    records["segment_pool_runs"]["d4_scores"] = d4
    phase("kernels", f"segment_pool_runs at the zoo's score shape [E {e}, "
          f"{ATTN_HEADS}]: max exact, exp-sum max err {d4_err:.2e}, "
          f"{REPEATS} calls bit-identical; "
          + "; ".join(f"{r} {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} "
                      f"ms, host {c['host_us']:.2f} us, device "
                      f"{c['device_us']:.2f} us in {c['device_kernels']} "
                      f"kernels + {c['memsets']} memsets"
                      for r, c in d4.items())
          + f", bound {d4_bound[0]:.5f} ms ({d4_bound[1]})")
    # -- the mean model's pools under model=2: [E, 64] chunks of the
    # 128-wide messages, on the same sorted targets
    v64 = normal(e, d // 2)
    d64_err = _close_sum(torch, "segment_pool_runs[D 64, sum]",
                         segment_pool_runs(v64, tgt, n_segments=n_tgt),
                         segment_pool_ref(v64, tgt, n_segments=n_tgt),
                         segment_pool_ref(v64.abs(), tgt, n_segments=n_tgt),
                         counts, 0.0)
    repeat_check(torch, "segment_pool_runs[D 64, sum]",
                 lambda: segment_pool_runs(v64, tgt, n_segments=n_tgt))
    d64_bound = _bound(n_valid * (d // 2) * isz + e * 4
                       + n_tgt * (d // 2) * isz, n_valid * (d // 2))
    d64 = dict(
        max_abs_err=d64_err,
        ms=time_ms(torch, lambda: segment_pool_runs(v64, tgt,
                                                    n_segments=n_tgt)),
        plain_ms=time_ms(torch, lambda: segment_pool_ref(
            v64, tgt, n_segments=n_tgt)),
        library_ms=index_add_yardsticks(torch, v64, tgt, n_tgt)[0],
        bound_ms=d64_bound[0], bound_by=d64_bound[1])
    records["segment_pool_runs"]["d64_chunk"] = d64
    phase("kernels", f"segment_pool_runs at the model=2 chunk shape [E {e}, "
          f"{d // 2}], sorted: sum max err {d64_err:.2e}, {REPEATS} calls "
          f"bit-identical; {d64['ms']:.4f} ms vs plain "
          f"{d64['plain_ms']:.4f} ms vs index_add_ {d64['library_ms']:.4f} "
          f"ms, bound {d64['bound_ms']:.5f} ms ({d64['bound_by']})")
    syncs = sync_check(torch, batch)
    if syncs.pop(BINCOUNT) is None:
        fail("the sync check saw no host sync in torch.bincount, which "
             "reads its input's max back to the host")
    if any(syncs.values()):
        fail(f"a mean pool or node_degree synchronised the host: {syncs}")
    phase("kernels", f"no host sync under set_sync_debug_mode('error'): "
          f"{', '.join(syncs)}; the control, torch.bincount, raised")

    # -- widths past one tile, on sorted ids ---------------------------------
    n_w, e_w = 300, 1000
    src_w = torch.from_numpy(rng.integers(0, n_w, e_w).astype(np.int32)
                             ).to(dev)
    tgt_w = torch.from_numpy(np.sort(rng.integers(0, n_w + 5, e_w))
                             .astype(np.int32)).to(dev)  # >= n_w: padding
    h_w = normal(n_w, 256)
    w_w, b_w = normal(512, 384, scale=512 ** -0.5), normal(384, scale=0.1)
    mpnn_err = _close(
        torch, "edge_mpnn_runs[fp32, 256+256 -> 384]",
        edge_mpnn_runs(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                       n_tgt=n_w),
        edge_mpnn_ref(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                      n_tgt=n_w), 1e-5, 1e-5)
    v_w = normal(e_w, 640)
    pool_err = _close(torch, "segment_pool_runs[sum, fp32, 640 wide]",
                      segment_pool_runs(v_w, tgt_w, n_segments=n_w),
                      segment_pool_ref(v_w, tgt_w, n_segments=n_w),
                      1e-5, 1e-5)
    phase("kernels", f"wide, sorted: edge_mpnn_runs 512 -> 384 (six column "
          f"tiles) max err {mpnn_err:.2e}, segment_pool_runs 640 wide (five "
          f"128-column slices) max err {pool_err:.2e}")


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

def mag_edges() -> dict:
    from repro_torch.core.schema import mag_schema
    schema = mag_schema()
    return {k: (v.source, v.target) for k, v in schema.edge_sets.items()}


def init_states(torch):
    """The §8 init states: paper features -> hidden states, fp32
    id-embedding tables for the featureless node sets (ids % 4096), all
    128 wide."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE
    from repro_torch.nn.layers import Embedding, Linear

    class InitStates(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.paper = Linear(FEAT_DIM, DIM)
            self.tables = torch.nn.ModuleDict({
                n: Embedding(VOCAB, DIM)
                for n in ("author", "institution", "field_of_study")})

        def forward(self, graph):
            ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
                graph.node_sets["paper"]["feat"]))}}
            for n, table in self.tables.items():
                ids = graph.node_sets[n]["id"] % VOCAB
                ns[n] = {HIDDEN_STATE: table(ids, dtype=torch.float32)}
            return graph.replace_features(node_sets=ns)

    return InitStates()


def model_parts(torch, reduce_type: str):
    """(init states, gnn) of the §8 model: `init_states`, then
    vanilla_mpnn (5 edge sets, 4 rounds, 128/128, LayerNorm)."""
    from repro_torch.core.models import vanilla_mpnn
    edges = mag_edges()
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    return init_states(torch), vanilla_mpnn(
        edges, dims, message_dim=DIM, hidden_dim=DIM, num_rounds=ROUNDS,
        use_layer_norm=True, reduce_type=reduce_type)


def root_task(hidden: int = DIM):
    from repro_torch.orchestration.tasks import (
        RootNodeMulticlassClassification)
    return RootNodeMulticlassClassification("paper", N_CLASSES, hidden)


def build_model(torch, reduce_type: str):
    """The served model: init states -> gnn -> RootNodeMulticlass head,
    with parameters drawn from a seeded generator."""
    from repro_torch.nn.layers import init_params

    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.task = root_task()
            self.init, self.gnn = model_parts(torch, reduce_type)
            self.head = self.task.head()

        def forward(self, graph):
            return self.task.predict(self.head, self.gnn(self.init(graph)))

    return init_params(Served(), SEED).to(DEVICE).eval()


def section8_spec(schema):
    """The §8 sampling spec of examples/ogbn_mag_train.py."""
    from repro_torch.data.sampling import SamplingSpecBuilder
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    authors = cited.join([seed_op]).sample(4, "written")
    author_papers = authors.sample(4, "writes")
    authors.sample(4, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(4, "has_topic")
    return seed_op.build()


def plain_logits(torch, server, store, spec, roots):
    """The same forward on the card through the plain versions, on the
    batch the server pads these roots to."""
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    from repro_torch.kernels import registry
    graphs = [sample_subgraph(store, spec, int(r), seed_rng(0, int(r)))
              for r in roots]
    sizes = server.ladder.sizes[server.ladder.bucket_for(len(roots))]
    with registry.plain_versions():
        return server.run_eager(merge_and_pad(graphs, sizes))[:len(roots)]


def check_logits(name, got, want, n):
    if got.shape != (n, N_CLASSES) or not np.isfinite(got).all():
        fail(f"{name}: logits {got.shape}, finite={np.isfinite(got).all()}")
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"{name}: served logits differ from the plain forward by "
             f"{np.abs(got - want).max():.3e} (rtol 1e-4, atol 1e-4)")
    return float(np.abs(got - want).max())


def fresh_roots(rng, used: set, n: int, n_papers: int) -> list:
    """`n` roots never requested before (no embedding-cache hits)."""
    out = []
    while len(out) < n:
        r = int(rng.integers(n_papers))
        if r not in used:
            used.add(r)
            out.append(r)
    return out


def device_profile(torch, prof) -> tuple:
    """(device busy ms, device kernel count, top kernels by device time)
    of a torch.profiler run; device-side events only (CPU ops would count
    twice)."""
    by_kernel = {}
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if getattr(ev, "device_type", None) == cuda and us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            total, count = by_kernel.get(name, (0, 0))
            by_kernel[name] = (total + us, count + ev.count)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    n_kernels = sum(n for _, n in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    profile = (", ".join(f"{k[:48]} {us / 1e3:.3f} ms x{n}"
                         for k, (us, n) in top)
               if by_kernel else "profiler saw no device time")
    return busy_ms, n_kernels, profile


def breakdown(torch, server, model, store, spec, roots) -> str:
    """Where one rung-8 request batch spends its time: host stages on the
    host clock (each ending in a synchronize), the forward's device time
    from CUDA events, and device time by kernel from torch.profiler.
    Eagerly the copy in is `to_device` and the forward the model's
    launches plus the copy out; with graphs the copy in is the rung's
    pinned stage and the forward its replay plus the copy out."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    t0 = time.perf_counter()
    graphs = [sample_subgraph(store, spec, r, seed_rng(0, r)) for r in roots]
    t1 = time.perf_counter()
    merged = merge_and_pad(graphs, server.ladder.sizes[len(roots)])
    t2 = time.perf_counter()
    if server.capture_graphs:
        rung_graph = server._graphs[len(roots)]
        rung_graph.stage(merged)
        torch.cuda.synchronize()
        t3 = time.perf_counter()

        def forward():
            return rung_graph.replay(server.device)
    else:
        g = to_device(merged, server.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()

        def forward():
            return model(g).cpu()
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t4 = time.perf_counter()
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            forward()
            torch.cuda.synchronize()
    busy_ms, n_kernels, profile = device_profile(torch, prof)
    fwd_ms = (t5 - t4) * 1e3
    mode = "graph replay" if server.capture_graphs else "eager"
    copy_in = "stage" if server.capture_graphs else "to_device"
    return (f"rung {len(roots)} {mode}: sample {(t1 - t0) * 1e3:.2f} ms, "
            f"merge+pad {(t2 - t1) * 1e3:.2f} ms, {copy_in} "
            f"{(t3 - t2) * 1e3:.2f} ms, forward wall {fwd_ms:.2f} ms "
            f"(CUDA events {start.elapsed_time(end):.2f} ms), profiler "
            f"device busy {busy_ms:.3f} ms = "
            f"{100 * busy_ms / fwd_ms:.1f}% of the forward wall, "
            f"{n_kernels} device kernels; top: {profile}")


def kernel_wrappers() -> tuple:
    """The five kernel wrappers, each with its own launch count."""
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_pool import kernel as seg
    return (mpnn.edge_mpnn, mpnn.edge_mpnn_runs, seg.segment_pool,
            seg.segment_pool_runs, flash.flash_attention)


def zero_launches() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def closed_loop(server, roots_per_client, timeout=120.0):
    """One thread per client, one outstanding request each; returns
    (latencies_ms, errors, duration_s)."""
    latencies, errors, lock = [], [0], threading.Lock()

    def client(roots):
        for r in roots:
            req = server.submit(r)
            try:
                req.result(timeout)
            except Exception:  # noqa: BLE001 — counted, reported and failed on below
                with lock:
                    errors[0] += 1
                continue
            with lock:
                latencies.append(req.latency_s * 1e3)

    threads = [threading.Thread(target=client, args=(roots,), daemon=True,
                                name=f"client-{i}")
               for i, roots in enumerate(roots_per_client)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    duration = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("closed-loop clients did not finish")
    return latencies, errors[0], duration


# ---------------------------------------------------------------------------
# phase 4: serve the §8 model through GNNServer on the card
# ---------------------------------------------------------------------------

# device kernels a served graph must not hold: the run variants (served
# batches are unsorted) and copies (inputs are staged before the replay)
RUN_KERNELS = ("edge_mpnn_runs_kernel", "seg_runs_tile_kernel",
               "seg_runs_rows_kernel", "carry_fold_kernel")


def graph_server(torch, store, spec, model):
    """A GNNServer capturing one CUDA graph per rung, with each rung's
    kernel launches during its capture: (server, {rung: {kernel:
    launches}}, warmup seconds).  The capture is spied on so that the
    launch count reads the capture alone (warmup first runs each rung
    eagerly, outside capture)."""
    from repro_torch.serve.gnn import GNNServer
    t0 = time.perf_counter()
    server = GNNServer(store, spec, model, device=DEVICE,
                       max_batch=MAX_BATCH, batch_window_ms=5.0,
                       warmup=False)
    captured, capture = {}, server._capture

    def counted(rung, merged):
        before = read_launches()
        out = capture(rung, merged)
        captured[rung] = {k: v - before[k]
                          for k, v in read_launches().items()}
        return out

    server._capture = counted
    try:
        server.warmup()
    except Exception:
        server.close()
        raise
    return server, captured, time.perf_counter() - t0


def replay_kernels(torch, server) -> dict:
    """{rung: device kernels by name in one replay of its graph} from
    torch.profiler (`device_per_call` over 5 replays of the static
    inputs as they stand)."""
    return {rung: device_per_call(torch, rung_graph.graph.replay, calls=5)
            for rung, rung_graph in sorted(server._graphs.items())}


def check_graphs(name, server, captured, replays, kernel, device_kernel,
                 per_forward, forbidden=()):
    """Every rung captured at warmup, `per_forward` launches of wrapper
    `kernel` (and no other wrapper's) in each capture and as many
    `device_kernel`s in one replay, none of `forbidden` or a copy."""
    rungs = tuple(server.ladder.rungs)
    if tuple(sorted(server._graphs)) != rungs or \
            server.steady_state_recompiles != 0:
        fail(f"{name}: captured rungs {sorted(server._graphs)} for ladder "
             f"{rungs}, {server.steady_state_recompiles} captures after "
             "warmup")
    for rung in rungs:
        want = {k: per_forward if k == kernel else 0
                for k in captured.get(rung, {})}
        if captured.get(rung) != want or not want:
            fail(f"{name}: rung {rung} capture launched "
                 f"{captured.get(rung)} ({per_forward} {kernel} expected)")
        seen = replays[rung]["launches_by_name"]
        bad = [k for k in seen if k in forbidden or "memcpy" in k.lower()]
        if seen.get(device_kernel) != per_forward or bad:
            fail(f"{name}: one replay of rung {rung} ran {seen} "
                 f"({per_forward} {kernel} device kernels expected, none "
                 f"of {list(forbidden)} or copies)")


def convs_per_forward(torch, server, model) -> int:
    """Convolutions a forward runs, each checked to be on the edge kernel
    (`describe_dispatch` at every rung)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    graph = server._subgraphs.get(0)
    n_convs = 0
    for rung in server.ladder.rungs:
        g = to_device(merge_and_pad([graph], server.ladder.sizes[rung]),
                      server.device)
        with torch.inference_mode():
            rounds = model.gnn.describe_dispatch(model.init(g))
        for rnd, per_set in enumerate(rounds):
            for ns, convs in per_set.items():
                for es, dec in convs.items():
                    if dec is None or not dec.use_kernel:
                        fail(f"rung {rung} round {rnd} {ns}<-{es} is "
                             f"not on the kernel: {dec}")
                    n_convs += 1
    per_forward = n_convs // len(server.ladder.rungs)
    if per_forward != 5 * ROUNDS:
        fail(f"{per_forward} convs per forward, expected {5 * ROUNDS}")
    return per_forward


def serve_mode(torch, store, spec, model, capture: bool) -> dict:
    """Serve the fresh-root checks and the closed loop through one
    server, eager or from one CUDA graph per rung; the same seeded roots
    in both modes.  Fails on any error, recompile, run kernel or wrong
    launch count; returns the numbers the phase prints."""
    from repro_torch.serve.gnn import GNNServer
    zero_launches()
    if capture:
        server, captured, warm_s = graph_server(torch, store, spec, model)
    else:
        t0 = time.perf_counter()
        server = GNNServer(store, spec, model, device=DEVICE,
                           max_batch=MAX_BATCH, batch_window_ms=5.0,
                           capture_graphs=False)
        warm_s = time.perf_counter() - t0
    warm_launches = read_launches()
    mode = "graphs" if capture else "eager"
    try:
        if server.ladder.rungs != (1, 2, 4, 8):
            fail(f"bucket ladder {server.ladder.rungs}, expected (1, 2, 4, 8)")
        per_forward = convs_per_forward(torch, server, model)
        rng = np.random.default_rng(SEED + 1)
        used = {0}
        n_papers = store.num_nodes["paper"]
        zero_launches()
        batches0 = server.stats.batches
        checks = []
        for n in (1, 2, 4, 8, 3, 8):
            roots = fresh_roots(rng, used, n, n_papers)
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        clients = [fresh_roots(rng, used, LOOP_REQUESTS, n_papers)
                   for _ in range(LOOP_CLIENTS)]
        latencies, errors, duration = closed_loop(server, clients)
        stats = server.stats
        counts = read_launches()
        batches = stats.batches - batches0
        if counts["edge_mpnn_runs"] or counts["segment_pool_runs"]:
            fail(f"serving ({mode}) launched a run kernel: {counts} (its "
                 "batches are not sorted by target)")
        if errors or stats.failed:
            fail(f"{mode}: {errors} client errors, {stats.failed} failed "
                 "requests")
        if stats.steady_state_recompiles != 0:
            fail(f"{mode}: {stats.steady_state_recompiles} steady-state "
                 "recompiles")
        if set(stats.batch_sizes) != set(server.ladder.rungs):
            fail(f"{mode}: served buckets {sorted(stats.batch_sizes)} do "
                 f"not cover the ladder {server.ladder.rungs}")
        replays = None
        if capture:
            replays = replay_kernels(torch, server)
            rungs = len(server.ladder.rungs)
            check_graphs("serve", server, captured, replays, "edge_mpnn",
                         "edge_mpnn_kernel", per_forward, RUN_KERNELS)
            # warmup: one eager forward and one capture per rung; replays
            # launch nothing through the wrappers
            if warm_launches["edge_mpnn"] != 2 * per_forward * rungs or any(
                    counts.values()):
                fail(f"serve graphs: warmup launches {warm_launches}, "
                     f"serving launches {counts} ({2 * per_forward * rungs}"
                     " edge_mpnn at warmup, none in replays expected)")
            launches = warm_launches["edge_mpnn"]
        else:
            launches = counts["edge_mpnn"]
            if launches != per_forward * batches:
                fail(f"edge_mpnn launched {launches} times for {batches} "
                     f"batches ({per_forward} per forward expected)")
        max_err = max(check_logits(f"serve {mode}", got, plain_logits(
            torch, server, store, spec, roots), len(roots))
            for roots, got in checks)
        profile = breakdown(torch, server, model, store, spec,
                            fresh_roots(rng, used, MAX_BATCH, n_papers))
    finally:
        server.close()
    return dict(mode=mode, warm_s=warm_s, server=server, stats=stats,
                batches=batches, launches=launches, per_forward=per_forward,
                pool_launches=counts["segment_pool"], max_err=max_err,
                profile=profile, replays=replays,
                p50=np.percentile(latencies, 50),
                p99=np.percentile(latencies, 99),
                qps=len(latencies) / duration, n=len(latencies))


def serve_phase(torch, store, spec, card) -> tuple:
    """The §8 model served twice in one call, the same requests each
    time: eagerly (each batch's forward launched op by op) and from one
    CUDA graph per rung captured at warmup.  Returns edge_mpnn's launches
    (eager serving, and the graph server's warmup)."""
    model = build_model(torch, "sum")
    runs = [serve_mode(torch, store, spec, model, capture)
            for capture in (False, True)]
    for r in runs:
        phase("profile", r["profile"])
    for r in runs:
        stats = r["stats"]
        if r["replays"] is None:
            launch_text = (f"edge_mpnn launches {r['launches']}, "
                           f"segment_pool launches {r['pool_launches']}")
        else:
            per_replay = {rung: rec["launches_by_name"].get(
                "edge_mpnn_kernel") for rung, rec in r["replays"].items()}
            us = {rung: round(rec["device_us"], 1)
                  for rung, rec in r["replays"].items()}
            launch_text = (f"{len(r['replays'])} rungs captured at warmup "
                           f"({r['per_forward']} edge_mpnn launches a "
                           f"capture, {r['launches']} with the eager warm "
                           f"runs), none in replays; one replay's "
                           f"edge_mpnn_kernel by rung {per_replay}, device "
                           f"us {us}")
        phase("serve", f"{card} {r['mode']}: warmup {r['warm_s']:.1f}s, "
              f"ladder {list(r['server'].ladder.rungs)}, "
              f"{r['per_forward']} convs/forward all on edge_mpnn, "
              f"{r['batches']} batches "
              f"{dict(sorted(stats.batch_sizes.items()))}, {launch_text}, "
              f"logits vs plain max err {r['max_err']:.2e}, closed loop "
              f"{LOOP_CLIENTS} clients x {LOOP_REQUESTS} = {r['n']} "
              f"requests: p50 {r['p50']:.2f} ms p99 {r['p99']:.2f} ms "
              f"{r['qps']:.1f} QPS, 0 recompiles, 0 failed")
    return runs[0]["launches"], runs[1]["launches"]


# ---------------------------------------------------------------------------
# phase 5: the mean-pooling variant (generic conv path -> segment_pool)
# ---------------------------------------------------------------------------

def mean_phase(torch, store, spec):
    """The mean-pooling model served from one CUDA graph per rung: each
    capture holds 5 x ROUNDS segment_pool launches and each replay as
    many `scatter_kernel`s, no edge or run kernel.  Returns segment_pool's
    launches (the warmup's eager runs and captures)."""
    model = build_model(torch, "mean")
    zero_launches()
    server, captured, _ = graph_server(torch, store, spec, model)
    warm = read_launches()
    rng = np.random.default_rng(SEED + 2)
    used = set()
    try:
        zero_launches()
        batches0 = server.stats.batches
        checks = []
        for n in (8, 5):
            roots = fresh_roots(rng, used, n, store.num_nodes["paper"])
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        stats = server.stats
        counts = read_launches()
        batches = stats.batches - batches0
        replays = replay_kernels(torch, server)
        max_err = max(check_logits("mean", got, plain_logits(
            torch, server, store, spec, roots), len(roots))
            for roots, got in checks)
    finally:
        server.close()
    per_forward = 5 * ROUNDS
    rungs = len(server.ladder.rungs)
    if stats.failed or stats.steady_state_recompiles:
        fail(f"mean serve: {stats.failed} failed, "
             f"{stats.steady_state_recompiles} recompiles")
    check_graphs("mean", server, captured, replays, "segment_pool",
                 "scatter_kernel", per_forward,
                 RUN_KERNELS + ("edge_mpnn_kernel",))
    if warm["segment_pool"] != 2 * per_forward * rungs or any(
            v for k, v in warm.items() if k != "segment_pool") or any(
            counts.values()):
        fail(f"mean path: warmup launches {warm}, serving launches "
             f"{counts} ({2 * per_forward * rungs} segment_pool at warmup, "
             "none in replays expected)")
    us = {rung: round(rec["device_us"], 1) for rung, rec in replays.items()}
    phase("mean", f"mean-pooling model served from {rungs} CUDA graphs: "
          f"{batches} batches, {per_forward} segment_pool launches a "
          f"capture ({warm['segment_pool']} with the eager warm runs), "
          f"none in replays, {per_forward} scatter_kernel in one replay "
          f"of each rung (device us {us}), logits vs plain max err "
          f"{max_err:.2e}")
    return warm["segment_pool"]


# ---------------------------------------------------------------------------
# phase 5b: load generation through the port's loadgen, freshness, the twin
# ---------------------------------------------------------------------------

SERVELOOP_OPEN_S = 5.0


def serveloop_phase(torch, store, spec, smi) -> tuple:
    """The §8 model at full width from one CUDA graph per rung, driven by
    `repro_torch.serve.loadgen` over every paper: a closed loop (4
    clients x 125, seed 0), an open loop at half its QPS for 5 s (seed
    1), then freshness (`add_edges` on `cites` bumps the version, stale
    entries are evicted, the resampled root's logits match the plain
    forward within 1e-4); then the twin `gnn_serve.main([])` at the
    example's defaults must exit 0.  Mutates `store` (a cites edge), so
    later phases take the unwrapped store.  Returns edge_mpnn's launches
    here and in the twin."""
    from repro_torch.orchestration import gnn_serve
    from repro_torch.serve import closed_loop as loadgen_closed
    from repro_torch.serve import open_loop as loadgen_open
    model = build_model(torch, "sum")
    zero_launches()
    server, captured, warm_s = graph_server(torch, store, spec, model)
    n_papers = store.num_nodes["paper"]
    root = 5
    try:
        closed = loadgen_closed(server, range(n_papers),
                                clients=LOOP_CLIENTS,
                                requests_per_client=LOOP_REQUESTS,
                                seed=0, timeout=120)
        opened = loadgen_open(server, range(n_papers), qps=0.5 * closed.qps,
                              duration_s=SERVELOOP_OPEN_S, seed=1,
                              timeout=120)
        v0 = store.version
        store.add_edges("cites", [root], [n_papers - 1])
        after = server.submit(root).result(60)
        stats = server.stats
        err = check_logits("serveloop freshness", np.asarray(after)[None],
                           plain_logits(torch, server, store, spec, [root]),
                           1)
    finally:
        server.close()
    launches = read_launches()
    rungs = len(server.ladder.rungs)
    if closed.errors or opened.errors or stats.failed:
        fail(f"serveloop: errors closed {closed.errors}, open "
             f"{opened.errors}, failed {stats.failed}")
    if stats.steady_state_recompiles or server._captures != rungs:
        fail(f"serveloop: {stats.steady_state_recompiles} recompiles, "
             f"{server._captures} captures")
    if store.version != v0 + 1 or stats.invalidations <= 0:
        fail(f"serveloop freshness: version {v0} -> {store.version}, "
             f"{stats.invalidations} invalidations")
    if launches != {k: (2 * 5 * ROUNDS * rungs if k == "edge_mpnn" else 0)
                    for k in launches}:
        fail(f"serveloop: launches {launches} ({2 * 5 * ROUNDS * rungs} "
             "edge_mpnn at warmup, none in replays expected)")
    phase("serveloop", f"{smi}: warmup {warm_s:.1f}s, closed loop over "
          f"{n_papers} papers {closed.summary()}, open loop at "
          f"{0.5 * closed.qps:.1f} QPS for {SERVELOOP_OPEN_S:g} s "
          f"{opened.summary()}; freshness: version {v0} -> "
          f"{store.version}, {stats.invalidations} invalidations, root "
          f"{root} resampled, logits vs plain max err {err:.2e}; "
          f"embedding hits/misses {stats.embedding_hits}/"
          f"{stats.embedding_misses}, {stats.batches} batches "
          f"{dict(sorted(stats.batch_sizes.items()))}, 0 errors, 0 "
          f"recompiles, launches {launches['edge_mpnn']} edge_mpnn (warmup)")
    zero_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = gnn_serve.main([])
        except SystemExit as exc:
            rc = exc.code
    twin = read_launches()
    for line in out.getvalue().splitlines():
        phase("serveloop", f"twin: {line}")
    per_forward = 2  # two rounds over one edge set
    if rc != 0 or twin != {k: (2 * per_forward * rungs
                               if k == "edge_mpnn" else 0) for k in twin}:
        fail(f"serveloop: gnn_serve.main([]) returned {rc!r}, launches "
             f"{twin} ({2 * per_forward * rungs} edge_mpnn expected)")
    return launches["edge_mpnn"], twin["edge_mpnn"]


# ---------------------------------------------------------------------------
# phase 6: train the §8 model through the port's Trainer on the card
# ---------------------------------------------------------------------------

def train_setup(raw, spec):
    """Seeded train and held-out roots, and the batch size constraints
    profiled over their subgraphs (find_size_constraints, as the §8
    example sizes its batches)."""
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    rng = np.random.default_rng(SEED + 3)
    n_train = TRAIN_STEPS * TRAIN_BATCH
    roots = rng.choice(raw.num_nodes["paper"], n_train + EVAL_ROOTS,
                       replace=False)
    graphs = [sample_subgraph(raw, spec, int(r), seed_rng(0, int(r)))
              for r in roots]
    return (roots[:n_train], roots[n_train:],
            find_size_constraints(graphs, TRAIN_BATCH))


def provider(raw, spec, roots, sizes):
    from repro_torch.orchestration.providers import StoreProvider
    return StoreProvider(raw, spec, roots, batch_size=TRAIN_BATCH,
                         sizes=sizes)


def fresh_model(torch, reduce_type: str = "sum", parts=None,
                hidden: int = DIM, task=None):
    """The Trainer's model at step 0: TrainModel(init, gnn, head) drawn
    with init_params(model, SEED), on the card; (init, gnn) are `parts`,
    or the §8 model with `reduce_type` pooling; the head is `task`'s (the
    root-node task's by default)."""
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    init, gnn = parts if parts is not None else model_parts(torch,
                                                            reduce_type)
    task = task if task is not None else root_task(hidden)
    model = TrainModel(init, gnn, task.head())
    return init_params(model, SEED).to(DEVICE)


def grad_check(torch, reduce_type: str, batch, labels, parts=None,
               hidden: int = DIM, task=None) -> tuple:
    """Step 1's gradients, kernel path vs plain path, on one batch and one
    set of parameters.  A parameter the loss reaches on one path must be
    reached on the other (slice 1's kernels returned tensors with no
    grad_fn, which would cut every conv off).  The loss reads only the
    root papers, so the institution and field_of_study states, and every
    node set's update in the last round but the papers', reach it on
    neither path: they get the zero gradient `jax.grad` gives them, as in
    the Trainer's step.  Every gradient must be finite and within
    GRAD_RTOL of its largest plain entry.  `parts` (init, gnn) with a
    `hidden`-wide output replace the §8 model (`reduce_type` then only
    names the model in messages), and `task` the root-node task.  Returns
    (worst relative error, parameters, parameters the loss reaches,
    kernel loss, plain loss).  A stacked `batch` ([R, ...] component
    groups, `labels` [R, C]) is held by the mean of its groups' losses."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.core.graph_tensor import stack_size, unstack_graph
    task = task if task is not None else root_task(hidden)
    model = fresh_model(torch, reduce_type, parts, hidden, task)
    params = dict(model.named_parameters())
    g = to_device(batch, DEVICE)
    lab = torch.as_tensor(labels).to(DEVICE)
    # a stacked [R, ...] super-batch: the mean of its groups' losses, as
    # the mesh's step takes it
    groups, labs = ((unstack_graph(g), lab) if stack_size(g) is not None
                    else ([g], [lab]))

    def grads():
        loss = sum(task.loss_from_graph(model.head, model(x), y)
                   for x, y in zip(groups, labs)) / len(groups)
        return loss.item(), torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)

    with registry.layout(sorted_by_target=True):
        loss_k, g_k = grads()
        with registry.plain_versions():
            loss_p, g_p = grads()
    worst, reached = 0.0, 0
    for (name, p), a, b in zip(params.items(), g_k, g_p):
        if (a is None) != (b is None):
            fail(f"[{reduce_type}] {name}: the loss reaches it on the "
                 f"{'plain' if a is None else 'kernel'} path only")
        reached += a is not None
        a = torch.zeros_like(p) if a is None else a
        b = torch.zeros_like(p) if b is None else b
        if not bool(torch.isfinite(a).all()):
            fail(f"[{reduce_type}] {name}: non-finite gradient")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if err > GRAD_RTOL * scale + 1e-7:
            fail(f"[{reduce_type}] {name}: kernel gradient differs from the "
                 f"plain one by {err:.3e} (largest plain entry "
                 f"{scale:.3e}, rtol {GRAD_RTOL})")
        if scale > 0:
            worst = max(worst, err / scale)
    return worst, len(params), reached, loss_k, loss_p


def fit(torch, reduce_type, train, evaluation, steps, plain=False,
        model_fn=None):
    """One Trainer.fit from seed 0: AdamW + warmup-cosine, the §8
    example's lr and schedule, on the card; the §8 model with
    `reduce_type` pooling unless `model_fn` gives another (init, gnn)."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration.trainer import Trainer
    trainer = Trainer(learning_rate=TRAIN_LR, total_steps=TRAIN_TOTAL,
                      max_steps=steps, seed=SEED, log_every=10 ** 6,
                      device=DEVICE,
                      eval_at="end" if evaluation is not None else "never")
    if model_fn is None:
        def model_fn():
            return model_parts(torch, reduce_type)
    with registry.plain_versions() if plain else contextlib.nullcontext():
        return trainer.fit(model_fn, root_task(), train,
                           eval_provider=evaluation)


def step_loop(torch, train) -> tuple:
    """The Trainer's step written out, over the same stream from the same
    draw, on the kernel path: each stage timed on the host clock, ending
    in a synchronize (medians over the steps after the first), then one
    more step under torch.profiler for the device's busy share.  After
    each step's gradients, the same batch's loss is computed again through
    the plain versions on the same parameters (outside the timed stages
    and the profiled step), so the two paths are compared at every step
    with no drift between them.  Returns (summary, largest per-step
    |kernel - plain| loss gap)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.train_loop import apply_updates, loss_and_grads
    task = root_task()
    model = fresh_model(torch, "sum")
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 50, TRAIN_TOTAL),
                weight_decay=1e-5)
    state = opt.init(params)

    def loss_fn(graph, labels):
        return task.loss_from_graph(model.head, model(graph), labels)

    stream = itertools.chain.from_iterable(
        train.epoch(e) for e in itertools.count())
    gaps = []

    def step(check_plain=True):
        nonlocal state
        t0 = time.perf_counter()
        host = next(stream)
        labels = task.labels(host)
        t1 = time.perf_counter()
        g = to_device(host, DEVICE)
        lab = torch.as_tensor(labels).to(DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss, grads = loss_and_grads(loss_fn, params, g, lab)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if check_plain:  # not timed
            with registry.plain_versions(), torch.no_grad():
                gaps.append(abs(loss.item() - loss_fn(g, lab).item()))
        t3_plain = time.perf_counter()
        state = apply_updates(opt, params, state, grads)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        return [1e3 * x for x in (t1 - t0, t2 - t1, t3 - t2, t4 - t3_plain)]

    with registry.layout(sorted_by_target=True):
        rows = [step() for _ in range(TRAIN_STEPS)][1:]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(check_plain=False)
    med = [statistics.median(col) for col in zip(*rows)]
    wall = sum(med)
    busy_ms, n_kernels, profile = device_profile(torch, prof)
    return (f"step {wall:.2f} ms = sample+batch {med[0]:.2f} + host->card "
            f"{med[1]:.2f} + forward+backward {med[2]:.2f} + optimizer "
            f"{med[3]:.2f} (medians of {len(rows)} steps); profiled step: "
            f"device busy {busy_ms:.3f} ms = {100 * busy_ms / wall:.1f}% of "
            f"the step, {n_kernels} device kernels; top: {profile}"), \
        max(gaps)


def cpu_loss(torch, batch, labels) -> float:
    """Step 1's loss through the plain versions on the CPU: the same
    parameters (drawn on the host) and the same batch as the card's."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    task = root_task()
    init, gnn = model_parts(torch, "sum")
    model = init_params(TrainModel(init, gnn, task.head()), SEED)
    with torch.no_grad():
        return task.loss_from_graph(model.head, model(to_device(batch,
                                                               "cpu")),
                                    torch.as_tensor(labels)).item()


def eval_plain(torch, params, evaluation) -> dict:
    """`evaluate` over `evaluation` through the plain versions, with the
    model's parameters set to `params` ({name: tensor})."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.orchestration.evaluation import evaluate
    from repro_torch.train.train_loop import make_graph_eval_step
    task = root_task()
    model = fresh_model(torch, "sum")
    model.load_state_dict(params)
    keys = task.metric_names()

    def metric_fn(graph, labels):
        pairs = task.metrics(model.head, model(graph), labels)
        return tuple(x for k in keys for x in pairs[k])

    with registry.plain_versions():
        return evaluate(evaluation, task, make_graph_eval_step(metric_fn),
                        lambda g, lab: (to_device(g, DEVICE),
                                        torch.as_tensor(lab).to(DEVICE)),
                        metric_keys=keys)


def train_phase(torch, raw, spec, card, setup) -> dict:
    """Train the sum model: step-1 gradient check, the counted Trainer
    run with its eval pass, the same run twice through the plain
    versions, the eval pass on the trained parameters through the plain
    versions, and the step loop (time split, same-parameter loss
    parity).  Returns edge_mpnn_runs' launches ("launches"), the counted
    run's per-step losses ("losses"), and its median step and batch-wait
    times ("step_ms", "wait_ms") over the steps after the first."""
    train_roots, eval_roots, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    evaluation = provider(raw, spec, eval_roots, sizes)
    task = root_task()
    first = next(iter(train.epoch(0)))
    worst, n_params, reached, loss_k, _ = grad_check(torch, "sum", first,
                                                     task.labels(first))
    loss_cpu = cpu_loss(torch, first, task.labels(first))
    if abs(loss_k - loss_cpu) > STEP_LOSS_ATOL:
        fail(f"train: step-1 loss on the card {loss_k:.6f} vs the plain "
             f"versions on the CPU {loss_cpu:.6f}")

    zero_launches()
    run = fit(torch, "sum", train, evaluation, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    eval_steps = evaluation.num_steps
    forwards = run.step + eval_steps
    if run.step != TRAIN_STEPS:
        fail(f"train: {run.step} steps, expected {TRAIN_STEPS}")
    if launches["edge_mpnn_runs"] != 5 * ROUNDS * forwards or any(
            launches[k] for k in ("edge_mpnn", "segment_pool",
                                  "segment_pool_runs")):
        fail(f"train: launches {launches} for {forwards} forwards "
             f"({5 * ROUNDS} edge_mpnn_runs per forward expected, no other "
             "kernel)")
    # the kernel path folds every sum in a fixed order on the sorted
    # batches, so a second kernel run from the same draw and stream must
    # repeat every loss and parameter bit for bit
    again = fit(torch, "sum", train, None, TRAIN_STEPS)
    if again.metrics["train_losses"] != run.metrics["train_losses"]:
        fail(f"train: two kernel runs from the same draw and stream differ: "
             f"{run.metrics['train_losses']} vs "
             f"{again.metrics['train_losses']}")
    for name, p in run.metrics["params"].items():
        if not torch.equal(p, again.metrics["params"][name]):
            fail(f"train: two kernel runs end with different {name}")
    # kernel vs plain: independent runs part once a ReLU input within
    # rounding of 0 flips sign on one path (the plain path's index_add_
    # sums in another order, and in none fixed): its gradient jumps, and
    # Adam scales the jump to a full lr-sized step.  So those trajectories
    # are held together over the first PARITY_STEPS steps (warmup keeps
    # lr small there), each step is held on shared parameters in
    # step_loop, and the plain path's own run-to-run spread is measured
    # beside them.
    plain = fit(torch, "sum", train, None, TRAIN_STEPS, plain=True)
    plain2 = fit(torch, "sum", train, None, TRAIN_STEPS, plain=True)
    losses = np.asarray(run.metrics["train_losses"])
    plain_losses = np.asarray(plain.metrics["train_losses"])
    gaps = np.abs(losses - plain_losses)
    spread = float(np.abs(plain_losses - np.asarray(
        plain2.metrics["train_losses"])).max())
    head_gap = float(gaps[:PARITY_STEPS].max())
    if not np.isfinite(losses).all() or head_gap > LOSS_ATOL:
        fail(f"train: the first {PARITY_STEPS} per-step losses differ from "
             f"the plain run by {head_gap:.3e} (atol {LOSS_ATOL}): "
             f"{losses.tolist()} vs {plain_losses.tolist()}")
    acc, eval_loss = run.metrics["eval"]["accuracy"], run.metrics["eval"][
        "loss"]
    plain_eval = eval_plain(torch, run.metrics["params"], evaluation)
    if not np.isfinite(eval_loss) or abs(eval_loss - plain_eval["loss"]) \
            > STEP_LOSS_ATOL:
        fail(f"train: eval {run.metrics['eval']} vs the plain versions on "
             f"the same parameters {plain_eval}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    wait_ms = 1e3 * statistics.median(run.metrics["batch_wait_seconds"][1:])
    phase("train", f"{card}: {TRAIN_STEPS} steps x {TRAIN_BATCH} roots + "
          f"eval {eval_steps} x {TRAIN_BATCH}; step-1 gradients of "
          f"{n_params} parameters ({reached} reached by the loss on both "
          f"paths) all finite, max rel err vs plain "
          f"{worst:.2e} (rtol {GRAD_RTOL}); step-1 loss {loss_k:.6f} (CPU "
          f"{loss_cpu:.6f}); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; a second kernel run bit-identical over all "
          f"{TRAIN_STEPS} steps (losses and parameters); independent "
          f"runs, max |kernel - plain| over "
          f"the first {PARITY_STEPS} steps {head_gap:.2e} (atol "
          f"{LOSS_ATOL}), over all {TRAIN_STEPS} {gaps.max():.2e} (plain "
          f"vs plain {spread:.2e}); eval accuracy {acc:.4f} loss "
          f"{eval_loss:.4f} (plain on the same parameters "
          f"{plain_eval['accuracy']:.4f} / {plain_eval['loss']:.4f}); "
          f"launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"{step_ms:.2f} ms median = {1e3 * TRAIN_BATCH / step_ms:.1f} "
          f"roots/s, of it waiting for the batch {wait_ms:.2f} ms median "
          f"(sampling and the copy, on the loop's thread)")
    profile, step_gap = step_loop(torch, train)
    if step_gap > STEP_LOSS_ATOL:
        fail(f"train: on the same parameters, a step's kernel loss differs "
             f"from the plain one by {step_gap:.3e} (atol {STEP_LOSS_ATOL})")
    phase("train-profile", f"{profile}; same-parameter loss gap kernel vs "
          f"plain over {TRAIN_STEPS} steps {step_gap:.2e} (atol "
          f"{STEP_LOSS_ATOL})")
    return {"launches": launches["edge_mpnn_runs"],
            "losses": run.metrics["train_losses"], "step_ms": step_ms,
            "wait_ms": wait_ms}


def train_mean_phase(torch, raw, spec, setup) -> int:
    """A few steps of the mean-pooling model (the generic conv path,
    pooled by segment_pool_runs on target-sorted ids), its step-1
    gradients held to the plain path.  Returns segment_pool_runs'
    launches."""
    train_roots, _, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    first = next(iter(train.epoch(0)))
    worst, n_params, reached, _, _ = grad_check(torch, "mean", first,
                                                root_task().labels(first))
    zero_launches()
    run = fit(torch, "mean", train, None, MEAN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["segment_pool_runs"] != 5 * ROUNDS * run.step or any(
            launches[k] for k in ("edge_mpnn", "edge_mpnn_runs",
                                  "segment_pool")):
        fail(f"train-mean: launches {launches} for {run.step} steps "
             f"({5 * ROUNDS} segment_pool_runs per forward expected)")
    losses = run.metrics["train_losses"]
    if not np.isfinite(losses).all():
        fail(f"train-mean: losses {losses}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("train-mean", f"{run.step} steps of the mean model: step-1 "
          f"gradients of {n_params} parameters ({reached} reached) max rel "
          f"err vs plain "
          f"{worst:.2e}; losses {[round(x, 4) for x in losses]}; launches "
          f"{launches} = {launches['segment_pool_runs'] // run.step}/forward; "
          f"Trainer step {step_ms:.2f} ms median")
    return launches["segment_pool_runs"]


# ---------------------------------------------------------------------------
# flash_attention against its plain version at three shapes
# ---------------------------------------------------------------------------

def flash_shapes(torch, batch) -> dict:
    """{label: (q, k, v, segments or None, causal)} in fp32, unit-scale
    normal inputs from a seeded generator:
    (a) GraphSelfAttention at the §8 width: the paper node set of the
        first training batch as one sequence, its component ids as
        segments (16 roots + the padding id), 4 heads x 32;
    (b) the reference envelope's corner (kernels/dispatch.py:242-243):
        4096 rows, 8 heads x 128, 16 components of 240 rows + 256 padding
        rows on id 16;
    (c) the causal GQA prefill of PREFILL (no segments)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)

    def qkv(b, s, h, kh, d):
        return tuple(torch.randn(b, s, n, d, generator=g, device=DEVICE)
                     for n in (h, kh, kh))

    paper = batch.node_sets["paper"]
    seg_a = paper.component_ids().to(torch.int32)[None]
    seg_b = torch.clamp(torch.arange(4096, device=DEVICE) // 240,
                        max=16).to(torch.int32)[None]
    pre = PREFILL
    return {
        "a": (*qkv(1, paper.capacity, ATTN_HEADS, ATTN_HEADS, ATTN_PER_HEAD),
              seg_a, False),
        "b": (*qkv(1, 4096, 8, 8, 128), seg_b, False),
        "c": (*qkv(pre["b"], pre["s"], pre["h"], pre["kh"], pre["d"]), None,
              True),
    }


def flash_bounds(torch, q, k, seg) -> tuple:
    """(allowed pairs per head, {kind: (bound_ms, bound_by)}): 4 D flops
    per (query, key) pair the mask allows, per head (sum of n_c^2 over the
    segments of the one batch row, or S (S + 1) / 2 per batch row for the
    causal shape), against q, k, v and out read or written once plus the
    segment ids; at fp32 on the CUDA cores ("fp32"), 3xTF32 on the
    tensor cores (a third of the TF32 rate, fp32 bytes; "tf32x3") and
    bf16 on the tensor cores (2-byte elements; "bf16")."""
    b, s, h, d = q.shape
    if seg is not None:
        pairs = int((torch.bincount(seg.flatten().long()) ** 2).sum())
    else:
        pairs = b * s * (s + 1) // 2

    def bound(itemsize, flops_per_s):
        nbytes = itemsize * (2 * q.numel() + 2 * k.numel())
        if seg is not None:
            nbytes += 2 * seg.numel() * 4
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 4 * d * h * pairs / flops_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    return pairs, {"fp32": bound(4, PEAK_FP32_FLOPS),
                   "tf32x3": bound(4, PEAK_TF32_FLOPS / 3),
                   "bf16": bound(2, PEAK_BF16_FLOPS)}


def flash_tiles(q, k, seg, causal, rows) -> dict:
    """The kv tiles the kernel visits at these inputs for q tiles of
    `rows` row groups, by its skip rule as `kernel.tile_plan` mirrors it:
    visited and total over the q tiles of every batch row, and the
    (query, key) pairs the visited tiles compute, per head."""
    from repro_torch.kernels.flash_attention.kernel import (BLOCK_K,
                                                            WARP_ROWS,
                                                            tile_plan)
    b, sq = q.shape[:2]
    skv = k.shape[1]
    ids = None if seg is None else seg.cpu().tolist()
    visited = total = 0
    for bi in range(b):
        row_ids = None if ids is None else ids[bi]
        plan = tile_plan(row_ids, row_ids, sq, skv, causal,
                         WARP_ROWS * rows)
        visited += sum(len(tiles) for tiles in plan)
        total += len(plan) * -(-skv // BLOCK_K)
    return dict(visited=visited, total=total,
                pairs=visited * WARP_ROWS * rows * BLOCK_K)


def sdpa_call(torch, q, k, v, seg, causal):
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same inputs ([B, H, S, D] layout, a boolean segment mask), timed as a
    yardstick only: the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is not None:
        mask = seg[0][:, None] == seg[0][None, :]
        return lambda: sdpa(qt, kt, vt, attn_mask=mask)
    return lambda: sdpa(qt, kt, vt, is_causal=causal,
                        enable_gqa=k.shape[2] != q.shape[2])


def flash_kernels_phase(torch, batch, records, build_report):
    """flash_attention at flash_shapes' three shapes: fp32 (rtol/atol
    1e-5) and bf16 (2e-2) against attention_ref, repeats bit-identical,
    (b)'s unmatched queries exact zeros; then per shape the fp32 and bf16
    times, the plain version's and SDPA's (a yardstick only), device us
    and device kernels per call (at most 2, else FAIL), and the bounds:
    3xTF32 (the product the kernel runs for fp32, the record's
    `bound_ms`), fp32 on the CUDA cores, and bf16.  The text lines add
    the CTA the C entry chose and, from `kernel.tile_plan`, the kv tiles
    and pairs its skip rule visits."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            last_cta)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lines, shapes = [], {}
    for label, (q, k, v, seg, causal) in flash_shapes(torch, batch).items():
        errs, ctas = {}, {}
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = [x.to(dtype) for x in (q, k, v)]
            got = flash_attention(*args, seg, causal=causal)
            ctas[dtype] = last_cta()
            want = attention_ref(*args, seg, causal=causal)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"flash_attention ({label}): got {got.dtype} "
                     f"{tuple(got.shape)}")
            errs[dtype] = _close(torch, f"flash_attention[({label}), "
                                 f"{dtype}]", got, want, tol, tol)
            for _ in range(2):
                if not torch.equal(flash_attention(*args, seg,
                                                   causal=causal), got):
                    fail(f"flash_attention ({label}, {dtype}): repeat "
                         "launches are not bit-identical")
        if label == "b":
            # queries whose id no key has: the padding rows moved to 17
            pad = seg == 16
            q_seg = torch.where(pad, 17, seg).to(torch.int32)
            got = flash_attention(q, k, v, q_seg, seg, causal=False)
            if got[pad].abs().max().item() != 0:
                fail("flash_attention (b): queries no key may reach must "
                     "emit exact zeros")
            _close(torch, "flash_attention[(b), unmatched queries]", got,
                   attention_ref(q, k, v, q_seg, seg, causal=False),
                   1e-5, 1e-5)
        bf = [x.to(torch.bfloat16) for x in (q, k, v)]
        library = sdpa_call(torch, q, k, v, seg, causal)
        lib_err = (library().transpose(1, 2) - attention_ref(
            q, k, v, seg, causal=causal)).abs().max().item()
        ms = time_ms(torch, lambda: flash_attention(q, k, v, seg,
                                                    causal=causal))
        bf16_ms = time_ms(torch, lambda: flash_attention(*bf, seg,
                                                         causal=causal))
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, seg,
                                                        causal=causal))
        library_ms = time_ms(torch, library)
        dev = {name: device_per_call(torch, lambda x=x: flash_attention(
            *x, seg, causal=causal)) for name, x in (("fp32", (q, k, v)),
                                                     ("bf16", bf))}
        for name, d in dev.items():
            if not 1 <= d["kernels"] <= 2:
                fail(f"flash_attention ({label}, {name}): a call ran "
                     f"{d['kernels']} device kernels ({d['names']}, "
                     f"{d['missed']} profiler events missed); 1 expected, "
                     "at most 2")
        pairs, bounds = flash_bounds(torch, q, k, seg)
        (bound_ms, bound_by), cc32, tc16 = (bounds["tf32x3"],
                                            bounds["fp32"], bounds["bf16"])
        cta = ctas[torch.float32]  # bf16 may take fewer kv splits
        tiles = flash_tiles(q, k, seg, causal, cta[0])
        b, s, h, d = q.shape
        shapes[label] = dict(
            ms=ms, bf16_ms=bf16_ms, plain_ms=plain_ms, library_ms=library_ms,
            fp32_err=errs[torch.float32], bf16_err=errs[torch.bfloat16],
            device_us=dev["fp32"]["device_us"],
            device_kernels=dev["fp32"]["kernels"],
            bf16_device_us=dev["bf16"]["device_us"],
            bf16_device_kernels=dev["bf16"]["kernels"],
            bound_ms=bound_ms, bound_by=bound_by,
            cuda_core_bound_ms=cc32[0], cuda_core_bound_by=cc32[1],
            bf16_bound_ms=tc16[0], bf16_bound_by=tc16[1])
        lines.append(
            f"({label}) B {b} S {s} H {h} K {k.shape[2]} D {d}"
            f"{' causal' if causal else ''}"
            f"{f' {seg.unique().numel()} segments' if seg is not None else ''}"
            f": CTAs of {cta[0]} x {cta[1]} warps, bf16 "
            f"{ctas[torch.bfloat16][0]} x {ctas[torch.bfloat16][1]} (row "
            f"groups x kv splits, as the C entry chose); by kernel.tile_plan "
            f"they visit "
            f"{tiles['visited']}/{tiles['total']} kv tiles, pairs per head "
            f"computed {tiles['pairs']} / allowed {pairs}; max err fp32 "
            f"{errs[torch.float32]:.2e} bf16 {errs[torch.bfloat16]:.2e}; "
            f"fp32 {ms:.4f} ms (device {dev['fp32']['device_us']:.2f} us, "
            f"{dev['fp32']['kernels']:g} kernel) bf16 {bf16_ms:.4f} ms "
            f"(device {dev['bf16']['device_us']:.2f} us, "
            f"{dev['bf16']['kernels']:g} kernel) vs plain {plain_ms:.4f} ms "
            f"vs SDPA fp32 {library_ms:.4f} ms (max err {lib_err:.2e}); "
            f"bounds 3xTF32 {bound_ms:.4f} ms ({bound_by}), fp32 CUDA cores "
            f"{cc32[0]:.4f} ms ({cc32[1]}), bf16 {tc16[0]:.4f} ms "
            f"({tc16[1]})")
    ptxas = ptxas_summary(ptxas_entries(build_report["flash_attention"]
                                        ["log"]), "flash_kernel")
    a = shapes["a"]  # the shape of the [attention] path
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:79",
        max_abs_err=a["fp32_err"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=a["library_ms"], ptxas=ptxas, shapes=shapes)
    for line in lines:
        phase("kernels", f"flash_attention fp32/bf16 match the plain "
              f"version, repeats bit-identical: {line}")
    regs = ("-".join(map(str, ptxas["registers"])) if ptxas["registers"]
            else "not reported")
    phase("kernels", f"flash_attention build: {ptxas['instantiations']} "
          f"instantiations, {regs} registers, at most "
          f"{ptxas['spill_stores']}/{ptxas['spill_loads']} B spill "
          "stores/loads")


# ---------------------------------------------------------------------------
# graph attention: GraphSelfAttention on the flash kernel
# ---------------------------------------------------------------------------

def attention_phase(torch, states, card) -> int:
    """`gat_flash_parity.run` on the card at the example's size (its
    tolerances) and over the paper states of the first training batch at
    full width (gradients by the [train] rule), one flash launch per
    forward and none in the backward; then forward and forward+backward
    times on each path.  Returns the flash launches of the two runs."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.nn.graph_attention import GraphSelfAttention
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration import gat_flash_parity

    zero_launches()
    small = gat_flash_parity.run(device=DEVICE)
    full = gat_flash_parity.run(
        device=DEVICE, graph=states, node_set="paper", in_dim=DIM,
        num_heads=ATTN_HEADS, per_head_channels=ATTN_PER_HEAD, seed=SEED)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["flash_attention"] != 2 or any(
            n for k, n in launches.items() if k != "flash_attention"):
        fail(f"attention: launches {launches} for two forwards (1 "
             "flash_attention each expected, no other kernel)")
    for name, run in (("example", small), ("full width", full)):
        if (run.forward_launches, run.backward_launches) != (1, 0):
            fail(f"attention ({name}): {run.forward_launches} flash "
                 f"launches in the forward, {run.backward_launches} in the "
                 "backward (1 and 0 expected)")
    try:
        small.check()
    except AssertionError as err:
        fail(f"attention (example): kernel path vs plain path: {err}")
    if abs(full.loss - full.plain_loss) > 1e-5 * abs(full.plain_loss) + 1e-6:
        fail(f"attention (full width): loss {full.loss} vs plain "
             f"{full.plain_loss}")
    worst = 0.0
    for name, g in full.grads.items():
        want = full.plain_grads[name]
        scale = want.abs().max().item()
        err = (g - want).abs().max().item()
        if not bool(torch.isfinite(g).all()) or \
                err > GRAD_RTOL * scale + 1e-7:
            fail(f"attention (full width): {name} gradient differs from the "
                 f"plain one by {err:.3e} (largest plain entry {scale:.3e})")
        worst = max(worst, err / scale if scale > 0 else 0.0)

    module = init_params(GraphSelfAttention(ATTN_HEADS, ATTN_PER_HEAD, DIM),
                         SEED).to(DEVICE)
    params = list(module.parameters())

    def forward():
        with torch.no_grad():
            module(states, "paper")

    def forward_backward():
        torch.autograd.grad(module(states, "paper").square().mean(), params)

    times = {}
    for path in ("kernel", "plain"):
        with (registry.plain_versions() if path == "plain"
              else contextlib.nullcontext()):
            times[path] = (time_ms(torch, forward),
                           time_ms(torch, forward_backward))
    paper = states.node_sets["paper"]
    phase("attention", f"{card}: gat_flash_parity at the example's size "
          f"(96 rows, 4 x 8): loss {small.loss:.6f} vs plain "
          f"{small.plain_loss:.6f}, gradients within rtol 1e-4 / atol 1e-5; "
          f"full width ({paper.capacity} paper rows, "
          f"{int(paper.component_ids().max()) + 1} segments, 4 x 32 over 128-wide "
          f"states): loss {full.loss:.6f} vs plain {full.plain_loss:.6f}, "
          f"gradients max rel err {worst:.2e} (rtol {GRAD_RTOL}); "
          f"launches {launches['flash_attention']} (1 per forward, 0 per "
          f"backward); full width forward {times['kernel'][0]:.4f} ms "
          f"kernel vs {times['plain'][0]:.4f} ms plain, forward+backward "
          f"{times['kernel'][1]:.4f} ms vs {times['plain'][1]:.4f} ms")
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# the model zoo on a training batch
# ---------------------------------------------------------------------------

def zoo_models(torch) -> dict:
    """{name: (model_fn, output width, segment_pool_runs per forward)} at
    the reference's defaults over the §8 init states.  Per forward: a
    mean or sum pool is one launch per conv, an attention conv three (the
    segment softmax's max and sum over [E, H] scores, then the [E, H, C]
    message sum); 5 convs a round over 2 rounds, gcn 1."""
    from repro_torch.core import models
    edges = mag_edges()
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    return {
        "rgcn": (lambda: (init_states(torch), models.rgcn(edges, dims)),
                 128, 10),
        "gcn": (lambda: (init_states(torch), models.gcn("cites", "paper",
                                                        DIM)), 64, 2),
        "graph_sage": (lambda: (init_states(torch),
                                models.graph_sage(edges, dims)), 128, 10),
        "gatv2": (lambda: (init_states(torch), models.gatv2(edges, dims)),
                  128, 30),
        "hgt_like": (lambda: (init_states(torch),
                              models.hgt_like(edges, dims)), 128, 30),
    }


def zoo_phase(torch, raw, spec, setup) -> int:
    """Each zoo model on the first 16-root training batch: its exact
    segment_pool_runs launches per forward (no other kernel) and its
    step-1 gradients against the plain path by the [train] rule; then
    gatv2 and hgt_like trained ZOO_STEPS steps through the Trainer on
    both paths, losses within LOSS_ATOL.  Returns segment_pool_runs'
    launches over the phase's kernel-path runs."""
    train_roots, _, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    first = next(iter(train.epoch(0)))
    labels = root_task().labels(first)
    parts, total = [], 0
    for name, (model_fn, hidden, per_forward) in zoo_models(torch).items():
        zero_launches()
        worst, n_params, reached, _, _ = grad_check(
            torch, name, first, labels, model_fn(), hidden)
        launches = read_launches()
        if launches["segment_pool_runs"] != per_forward or any(
                n for k, n in launches.items() if k != "segment_pool_runs"):
            fail(f"zoo {name}: launches {launches} for one forward "
                 f"({per_forward} segment_pool_runs expected)")
        total += launches["segment_pool_runs"]
        parts.append(f"{name} {per_forward} launches/forward, {n_params} "
                     f"parameters ({reached} reached), max rel err "
                     f"{worst:.2e}")
    trained = []
    for name in ("hgt_like", "gatv2"):
        model_fn, _, per_forward = zoo_models(torch)[name]
        zero_launches()
        run = fit(torch, name, train, None, ZOO_STEPS, model_fn=model_fn)
        torch.cuda.synchronize()
        launches = read_launches()
        plain = fit(torch, name, train, None, ZOO_STEPS, plain=True,
                    model_fn=model_fn)
        if launches["segment_pool_runs"] != per_forward * ZOO_STEPS:
            fail(f"zoo {name}: {launches} over {ZOO_STEPS} Trainer steps "
                 f"({per_forward} segment_pool_runs per forward expected)")
        total += launches["segment_pool_runs"]
        losses = np.asarray(run.metrics["train_losses"])
        plain_losses = np.asarray(plain.metrics["train_losses"])
        gap = float(np.abs(losses - plain_losses).max())
        if run.step != ZOO_STEPS or not np.isfinite(losses).all() \
                or gap > LOSS_ATOL:
            fail(f"zoo {name}: Trainer losses {losses.tolist()} vs plain "
                 f"{plain_losses.tolist()}")
        step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
        trained.append(f"{name} {ZOO_STEPS} steps, losses "
                       f"{[round(float(x), 4) for x in losses]}, max |kernel - "
                       f"plain| {gap:.2e}, step {step_ms:.2f} ms")
    phase("zoo", "; ".join(parts + trained)
          + f"; segment_pool_runs launches {total}")
    return total


# ---------------------------------------------------------------------------
# the example twins: quickstart, link prediction, graph classification
# ---------------------------------------------------------------------------

def quickstart_phase(torch) -> dict:
    """`repro_torch.orchestration.quickstart.run` on the card against the
    same run through the plain versions on the card: the paper's spending
    numbers and the round's user states within rtol/atol 1e-5, and the
    exact launches of its one run: 2 edge_mpnn (the two SimpleConvs, rows
    of 3 and 4 floats, 8 messages wide), 1 segment_pool (the purchases,
    unsorted), 1 segment_pool_runs (the context max).  Returns them."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration import quickstart
    zero_launches()
    got = quickstart.run(device=DEVICE)
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = {"edge_mpnn": 2, "edge_mpnn_runs": 0, "segment_pool": 1,
                     "segment_pool_runs": 1, "flash_attention": 0}
    if launches != want_launches:
        fail(f"quickstart: launches {launches}, expected {want_launches}")
    with registry.plain_versions():
        want = quickstart.run(device=DEVICE)
    errs = []
    for name in ("total_spend", "max_spend_fraction", "user_states"):
        a, b = getattr(got, name), getattr(want, name)
        if a.shape != b.shape or not np.isfinite(a).all() \
                or not np.allclose(a, b, rtol=1e-5, atol=1e-5):
            fail(f"quickstart: {name} {a.tolist()} vs plain {b.tolist()}")
        errs.append(float(np.abs(a - b).max()))
    if not np.allclose(got.total_spend, [160.11, 50.33, 350.0, 45.13],
                       rtol=1e-6):
        fail(f"quickstart: total spend {got.total_spend.tolist()}")
    phase("quickstart", f"total spend "
          f"{[round(float(x), 2) for x in got.total_spend]}, fraction of "
          f"max {[round(float(x), 3) for x in got.max_spend_fraction]}, "
          f"user states {got.user_states.shape}; max |kernel - plain| "
          f"{max(errs):.2e} (rtol/atol 1e-5); launches {launches}")
    return launches


def twin_grad_check(torch, name, task, model_fn, hidden, provider_) -> str:
    """Step 1's gradients of a twin's model on its first batch, kernel
    path vs plain path, by the [train] rule; the phase-line text."""
    first = next(iter(provider_.epoch(0)))
    worst, n_params, reached, _, _ = grad_check(
        torch, name, first, task.labels(first, epoch=0, step=0), model_fn(),
        hidden, task)
    return (f"step-1 gradients of {n_params} parameters ({reached} "
            f"reached) max rel err vs plain {worst:.2e} (rtol {GRAD_RTOL})")


def linkpred_phase(torch) -> int:
    """`link_prediction.run` at the example's defaults on the card (480
    papers, hidden 32, 2 rounds, 4 negatives, 3 epochs of 16-root
    StoreProvider batches, eval at the end): exactly 6 edge_mpnn_runs a
    forward (3 convs x 2 rounds) and no other kernel; a second kernel
    run from the same draw and stream repeats every loss and parameter
    bit for bit; step-1 gradients by the [train] rule.  Returns
    edge_mpnn_runs' launches."""
    from repro_torch.orchestration import link_prediction as lp
    from repro_torch.orchestration.tasks import LinkPrediction
    data = lp.providers()
    train, val = data
    zero_launches()
    run = lp.run(device=DEVICE, data=data)
    torch.cuda.synchronize()
    launches = read_launches()
    forwards = run.step + val.num_steps
    per_forward = 3 * lp.ROUNDS
    if launches["edge_mpnn_runs"] != per_forward * forwards or any(
            n for k, n in launches.items() if k != "edge_mpnn_runs"):
        fail(f"linkpred: launches {launches} for {forwards} forwards "
             f"({per_forward} edge_mpnn_runs per forward expected)")
    again = lp.run(device=DEVICE, data=data)
    if again.metrics["train_losses"] != run.metrics["train_losses"] or any(
            not torch.equal(p, again.metrics["params"][k])
            for k, p in run.metrics["params"].items()):
        fail("linkpred: two kernel runs from the same draw and stream "
             "differ")
    losses = run.metrics["train_losses"]
    if run.step != lp.EPOCHS * train.num_steps \
            or not np.isfinite(losses).all():
        fail(f"linkpred: {run.step} steps, losses {losses}")
    task = LinkPrediction("writes", lp.HIDDEN, num_negatives=lp.NEGATIVES)
    grads = twin_grad_check(torch, "linkpred", task, lp.model_fn, lp.HIDDEN,
                            train)
    em = run.metrics["eval"]
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("linkpred", f"{run.step} steps ({lp.EPOCHS} epochs x "
          f"{train.num_steps}) of 16 roots + eval {val.num_steps}; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; eval accuracy "
          f"{em['accuracy']:.4f} loss {em['loss']:.4f}; a second kernel "
          f"run bit-identical over all {run.step} steps (losses and "
          f"parameters); {grads}; launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"{step_ms:.2f} ms median")
    return launches["edge_mpnn_runs"]


def gn_round_check(torch, first) -> str:
    """One full Graph Networks round (EdgeSetUpdate on bonds, then the
    atoms' NodeSetUpdate, a fused SimpleConv, then a mean ContextUpdate
    over the atoms) on the first graph-classification batch, from the
    twin's initial states drawn from SEED: kernel path vs plain path,
    forward within rtol 1e-4 / atol 1e-5 and the gradients of a fixed
    random projection by the [train] rule; exactly 1 edge_mpnn_runs and 1
    segment_pool_runs.  The phase-line text."""
    from repro_torch.core.convolutions import SimpleConv
    from repro_torch.core.graph_tensor import HIDDEN_STATE, to_device
    from repro_torch.core.graph_update import (ContextUpdate,
                                               EdgeSetUpdate, GraphUpdate,
                                               NextStateFromConcat,
                                               NodeSetUpdate)
    from repro_torch.kernels import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration import graph_classification as gcls
    h = gcls.HIDDEN
    rnd = init_params(GraphUpdate(
        edge_sets={"bonds": EdgeSetUpdate(2 * h, h)},
        node_sets={"atoms": NodeSetUpdate({"bonds": SimpleConv(h, 2 * h)},
                                          NextStateFromConcat(2 * h, h))},
        context=ContextUpdate(["atoms"], h, h)), SEED).to(DEVICE)
    init = init_params(gcls.InitStates(h), SEED).to(DEVICE)
    with torch.no_grad():
        g = init(to_device(first, DEVICE))
    params = list(rnd.parameters())

    def outputs():
        out = rnd(g)
        return (out.edge_sets["bonds"][HIDDEN_STATE],
                out.node_sets["atoms"][HIDDEN_STATE],
                out.context[HIDDEN_STATE])

    gen = torch.Generator().manual_seed(SEED)
    with registry.layout(sorted_by_target=True):
        zero_launches()
        got = outputs()
        launches = read_launches()
        cots = [torch.randn(o.shape, generator=gen).to(DEVICE) for o in got]
        g_k = torch.autograd.grad(sum((o * c).sum() for o, c in
                                      zip(got, cots)), params)
        with registry.plain_versions():
            want = outputs()
            g_p = torch.autograd.grad(sum((o * c).sum() for o, c in
                                          zip(want, cots)), params)
    if launches["edge_mpnn_runs"] != 1 or launches["segment_pool_runs"] != 1:
        fail(f"graphcls: the GN round launched {launches} (1 edge_mpnn_runs "
             "and 1 segment_pool_runs expected)")
    err = max(_close(torch, f"graphcls GN round output {i}", a, b, 1e-4,
                     1e-5) for i, (a, b) in enumerate(zip(got, want)))
    worst = 0.0
    for (name, _), a, b in zip(rnd.named_parameters(), g_k, g_p):
        scale = b.abs().max().item()
        gap = (a - b).abs().max().item()
        if not bool(torch.isfinite(a).all()) \
                or gap > GRAD_RTOL * scale + 1e-7:
            fail(f"graphcls GN round: {name} gradient differs from the "
                 f"plain one by {gap:.3e} (largest {scale:.3e})")
        worst = max(worst, gap / scale if scale else 0.0)
    return (f"a full GN round (edges {tuple(got[0].shape)}, atoms "
            f"{tuple(got[1].shape)}, context {tuple(got[2].shape)}) max "
            f"|kernel - plain| {err:.2e}, gradients max rel err "
            f"{worst:.2e}")


def graphcls_phase(torch) -> tuple:
    """`graph_classification.run` at the example's defaults on the card
    (480 graphs, 3 classes, hidden 32, 3 rounds, 16-graph batches, 6
    epochs with an eval after each, early stopping at patience 3),
    checkpointing to a temporary directory: exactly 3 edge_mpnn_runs and
    1 segment_pool_runs a forward; `best_checkpoint` names a directory
    that exists; a second run into its own directory, stopped at its
    first save (max_steps), then resumed with `Trainer(resume=True)`,
    repeats the uninterrupted run's losses exactly; step-1 gradients by
    the [train] rule; one full Graph Networks round (`gn_round_check`).
    Returns (edge_mpnn_runs, segment_pool_runs) launches of the counted
    run."""
    import tempfile
    from repro_torch.orchestration import graph_classification as gcls
    from repro_torch.orchestration.tasks import GraphMulticlassClassification
    data = gcls.providers()
    train, val = data
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        run = gcls.run(device=DEVICE, data=data,
                       ckpt_dir=os.path.join(tmp, "full"))
        torch.cuda.synchronize()
        launches = read_launches()
        evals = len(run.metrics["eval_history"])
        forwards = run.step + evals * val.num_steps
        want = {"edge_mpnn_runs": gcls.ROUNDS * forwards,
                "segment_pool_runs": forwards}
        if any(launches[k] != want.get(k, 0) for k in launches):
            fail(f"graphcls: launches {launches} for {forwards} forwards "
                 f"({gcls.ROUNDS} edge_mpnn_runs and 1 segment_pool_runs "
                 "per forward expected)")
        best = run.metrics["best_checkpoint"]
        cut = gcls.SAVE_INTERVAL
        part = gcls.run(device=DEVICE, data=data, steps=cut,
                        ckpt_dir=os.path.join(tmp, "resumed"))
        rest = gcls.run(device=DEVICE, data=data, resume=True,
                        ckpt_dir=os.path.join(tmp, "resumed"))
        losses = run.metrics["train_losses"]
        resumed = part.metrics["train_losses"] + rest.metrics["train_losses"]
        if part.step != cut or resumed != losses or rest.step != run.step:
            fail(f"graphcls: stopped at {part.step} and resumed to "
                 f"{rest.step}, losses {resumed} vs uninterrupted "
                 f"{run.step}: {losses}")
        best_name = os.path.basename(best)
    task = GraphMulticlassClassification("atoms", gcls.CLASSES, gcls.HIDDEN)
    grads = twin_grad_check(torch, "graphcls", task, gcls.model_fn,
                            gcls.HIDDEN, train)
    from repro_torch.core.graph_tensor import unstack_graph
    # the twin's batches are stacked [1, ...] super-batches
    gn = gn_round_check(torch, unstack_graph(next(iter(train.epoch(0))))[0])
    em = run.metrics["eval"]
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("graphcls", f"{run.step} steps ({train.num_steps} an epoch, "
          f"{evals} evals of {val.num_steps} batches"
          f"{', stopped early' if run.metrics.get('stopped_early') else ''}"
          f"); loss {losses[0]:.4f} -> {losses[-1]:.4f}; eval accuracy "
          f"{em['accuracy']:.4f} loss {em['loss']:.4f}; best checkpoint "
          f"{best_name} (step {run.metrics['best_step']}); stopped at step "
          f"{cut} and resumed: all {len(losses)} losses exactly equal; "
          f"{grads}; {gn}; launches {launches}; Trainer step "
          f"{step_ms:.2f} ms median")
    return launches["edge_mpnn_runs"], launches["segment_pool_runs"]


def service_phase(torch, raw, spec, setup, trained, smi) -> int:
    """[train]'s run again, its batches from a sampler fleet: the §8 model
    at full width from the same draw, the same roots, sizes and plan, 24
    steps of 16 roots through `runner.run(sampler="service")` over a
    "process" fleet of 2 workers, double-buffered (pinned copies a step
    ahead on a side stream).  The fleet forks this CUDA-initialized
    process; its workers run numpy only.  Every loss must equal [train]'s
    kernel run bit for bit (the fleet's stream is the StoreProvider's,
    and the run kernels fold in a fixed order on sorted ids), with
    exactly 5 x ROUNDS edge_mpnn_runs a forward and no other kernel.
    Returns edge_mpnn_runs' launches."""
    from repro_torch.orchestration import runner
    from repro_torch.sampling_service import SamplingService
    train_roots, _, sizes = setup
    task = root_task()
    svc = SamplingService(raw, spec, train_roots, batch_size=TRAIN_BATCH,
                          sizes=sizes, num_workers=2, seed=0, base_seed=0,
                          backend="process")
    try:
        procs = [w.process for w in svc.coordinator.workers.values()]
        if svc.backend != "process" or not all(
                hasattr(p_, "pid") for p_ in procs):
            fail(f"service: the fleet runs backend {svc.backend!r}, not "
                 "forked processes")
        zero_launches()
        run = runner.run(model_fn=lambda: model_parts(torch, "sum"),
                         task=task, epochs=1, learning_rate=TRAIN_LR,
                         total_steps=TRAIN_TOTAL, log_every=10 ** 6,
                         seed=SEED, max_steps=TRAIN_STEPS,
                         sampler="service", service=svc,
                         label_fn=task.labels, device=DEVICE)
        torch.cuda.synchronize()
        launches = read_launches()
        marks = svc.watermarks()
    finally:
        svc.close(timeout=10.0)
    if any(p_.is_alive() for p_ in procs):
        fail("service: a fleet process outlived close()")
    if run.step != TRAIN_STEPS:
        fail(f"service: {run.step} steps, expected {TRAIN_STEPS}")
    want = {"edge_mpnn_runs": 5 * ROUNDS * run.step}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"service: launches {launches} for {run.step} forwards "
             f"({5 * ROUNDS} edge_mpnn_runs per forward expected, no other "
             "kernel)")
    losses = run.metrics["train_losses"]
    if losses != trained["losses"]:
        fail(f"service: the fleet-fed losses {losses} differ from [train]'s "
             f"kernel run {trained['losses']}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    wait_ms = 1e3 * statistics.median(run.metrics["batch_wait_seconds"][1:])
    phase("service", f"{smi}: {run.step} steps x {TRAIN_BATCH} roots from "
          f"a process fleet of 2 workers (watermarks {marks}), "
          f"double-buffered; all {run.step} losses bit-identical to "
          f"[train]'s kernel run ({losses[0]:.6f} -> {losses[-1]:.6f}); "
          f"launches {launches} = {launches['edge_mpnn_runs'] // run.step}"
          f"/forward; Trainer step {step_ms:.2f} ms median = "
          f"{1e3 * TRAIN_BATCH / step_ms:.1f} roots/s, waiting for the "
          f"batch {wait_ms:.2f} ms median; [train] (sampling on the loop's "
          f"thread): step {trained['step_ms']:.2f} ms, waiting "
          f"{trained['wait_ms']:.2f} ms")
    return launches["edge_mpnn_runs"]


def outofcore_phase(torch, smi) -> int:
    """`out_of_core.run` at the example's defaults on the card (24000
    papers x 1024 fp32 features, 64 roots, 6 steps of 8, hidden 32, 2
    rounds over cites and written): a thread fleet's run, then a dial
    fleet of 2 subprocess workers (`python -m
    repro_torch.storage.dial_worker`, one shard each) over a
    GraphDirectory in a temporary directory.  The two runs' losses must
    be exactly equal over as many steps, each worker's peak RSS below the
    directory's bytes, and each forward exactly 2 rounds x 2 edge sets =
    4 edge_mpnn_runs, no other kernel.  Returns edge_mpnn_runs'
    launches."""
    from repro_torch.orchestration import out_of_core
    per_forward = 2 * len(out_of_core.EDGES)
    t0 = time.perf_counter()
    data = out_of_core.problem()
    t_data = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    try:
        result = out_of_core.run(device=DEVICE, data=data)
    except RuntimeError as exc:
        fail(f"outofcore: {exc}")
    torch.cuda.synchronize()
    t_runs = time.perf_counter() - t0
    launches = read_launches()
    forwards = result.thread.step + result.dial.step
    want = {"edge_mpnn_runs": per_forward * forwards}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"outofcore: launches {launches} for {forwards} forwards "
             f"({per_forward} edge_mpnn_runs per forward expected, no "
             "other kernel)")
    losses = result.dial.metrics["train_losses"]
    if result.dial.step != out_of_core.STEPS or \
            losses != result.thread.metrics["train_losses"] or \
            not np.isfinite(losses).all():
        fail(f"outofcore: dial {result.dial.step} steps {losses} vs thread "
             f"{result.thread.step} steps "
             f"{result.thread.metrics['train_losses']}")
    total = result.graph_bytes
    rss = ", ".join(f"worker {w} {peak / 2 ** 20:.1f} MiB (ratio "
                    f"{peak / total:.3f})"
                    for w, peak in enumerate(result.peak_rss))
    step_ms = [1e3 * statistics.median(r.metrics["step_seconds"][1:])
               for r in (result.thread, result.dial)]
    phase("outofcore", f"{smi}: {out_of_core.PAPERS} papers x "
          f"{out_of_core.FEAT_DIM} features, GraphDirectory {total} bytes "
          f"({total / 2 ** 20:.1f} MiB); thread and dial fleets "
          f"{result.dial.step} steps each, losses exactly equal "
          f"({losses[0]:.6f} -> {losses[-1]:.6f}); peak RSS {rss}, all "
          f"below graph bytes; launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"thread {step_ms[0]:.2f} ms, dial {step_ms[1]:.2f} ms median; "
          f"data {t_data:.1f} s, both runs {t_runs:.1f} s (host clock)")
    return launches["edge_mpnn_runs"]

# ---------------------------------------------------------------------------
# the mesh: data- and feature-parallel training over torch.distributed
# ---------------------------------------------------------------------------

def mesh_batches(raw, spec, roots, path) -> list:
    """The first MESH_STEPS super-batches of MESH_GROUPS groups x
    MESH_ROOTS roots over `roots` (target-sorted, sizes profiled per
    group, as the §8 example sizes a super-batch's groups) with their
    per-group labels, as (graph, labels) pairs, also pickled to `path`
    for the spawned ranks."""
    import pickle
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    from repro_torch.orchestration.providers import StoreProvider
    per_step = MESH_GROUPS * MESH_ROOTS
    roots = roots[:MESH_STEPS * per_step]
    sizes = find_size_constraints(
        [sample_subgraph(raw, spec, int(r), seed_rng(0, int(r)))
         for r in roots], MESH_ROOTS)
    task = root_task()
    pairs = [(g, task.labels(g)) for g in StoreProvider(
        raw, spec, roots, batch_size=per_step, sizes=sizes,
        num_replicas=MESH_GROUPS).epoch(0)]
    with open(path, "wb") as f:
        pickle.dump(pairs, f)
    return pairs


MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "broadcast", "barrier")


@contextlib.contextmanager
def collective_clock():
    """Count the `torch.distributed` calls made inside the block and the
    host time spent inside them (a gloo call returns once its exchange
    is done, the copies of CUDA tensors to and from the host included):
    {"calls": n, "ms": t}."""
    import torch.distributed as dist
    seen = {"calls": 0, "ms": 0.0}
    real = {name: getattr(dist, name) for name in MESH_COLLECTIVES}

    def timed(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["ms"] += 1e3 * (time.perf_counter() - t0)
                seen["calls"] += 1
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def mesh_fit(torch, pairs, reduce_type: str, num_devices: int,
             model_parallel: int, steps: int, plain: bool = False) -> dict:
    """One `Trainer(num_devices=, model_parallel=)` fit over the
    super-batches `pairs` from seed 0 on the card (the [train] recipe);
    what the phase prints and compares, launches and collectives
    counted around the fit on this rank."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration.providers import IteratorProvider
    from repro_torch.orchestration.trainer import Trainer
    trainer = Trainer(learning_rate=TRAIN_LR, total_steps=TRAIN_TOTAL,
                      max_steps=steps, seed=SEED, log_every=10 ** 6,
                      device=DEVICE, num_devices=num_devices,
                      model_parallel=model_parallel, eval_at="never")
    zero_launches()
    with registry.plain_versions() if plain else contextlib.nullcontext(), \
            collective_clock() as coll:
        run = trainer.fit(lambda: model_parts(torch, reduce_type),
                          root_task(), IteratorProvider(lambda e: iter(pairs)))
    torch.cuda.synchronize()
    return {"losses": run.metrics["train_losses"], "step": run.step,
            "collectives": coll,
            "launches": read_launches(), "plan": run.metrics["plan"],
            "opt_bytes": run.metrics["opt_state_bytes"],
            "step_ms": 1e3 * statistics.median(
                run.metrics["step_seconds"][1:])}


def mesh_grads(torch, pair, reduce_type: str, num_devices: int,
               model_parallel: int) -> dict:
    """Step 1's gradients of the §8 model (drawn as `fresh_model` draws
    it) on one super-batch through a `num_devices` x `model_parallel`
    plan: this rank's groups' mean loss under the plan's model context,
    each gradient then averaged over every rank as the train step
    averages it, {name: numpy}."""
    from repro_torch.core.graph_tensor import unstack_graph
    from repro_torch.distributed import collectives, partition
    from repro_torch.kernels import registry
    plan = partition.make_plan(num_devices, model_parallel=model_parallel,
                               device=DEVICE)
    task = root_task()
    model = fresh_model(torch, reduce_type)
    params = dict(model.named_parameters())
    graph, labels = plan.put_super_batch(*pair)
    groups = unstack_graph(graph)
    with registry.layout(sorted_by_target=True), plan.model_context():
        loss = sum(task.loss_from_graph(model.head, model(g), labels[i])
                   for i, g in enumerate(groups)) / len(groups)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    world = plan.mesh.world
    return {k: (collectives.all_reduce(g, world) / world.size).cpu().numpy()
            for k, g in zip(params, grads)}


def mesh_grad_gap(name: str, got: dict, want: dict) -> float:
    """The worst gradient error of `got` against `want` relative to each
    leaf's largest `want` entry; fails beyond the [train] rule
    (GRAD_RTOL of that entry)."""
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        if not np.isfinite(a).all() or err > GRAD_RTOL * scale + 1e-7:
            fail(f"mesh {name} {k}: step-1 gradient differs from one rank's "
                 f"by {err:.3e} (largest entry {scale:.3e}, rtol "
                 f"{GRAD_RTOL})")
        if scale > 0:
            worst = max(worst, err / scale)
    return worst


def mesh_rank(path: str, reduce_type: str, model_parallel: int,
              steps: int) -> dict:
    """What each spawned rank of `[mesh]` (b) and (c) runs; a rank of a
    model-split plan also returns step 1's gradients (`mesh_grads`) on
    the first super-batch."""
    import pickle
    import torch
    full_fp32(torch)
    with open(path, "rb") as f:
        pairs = pickle.load(f)
    grads = (mesh_grads(torch, pairs[0], reduce_type, MESH_RANKS,
                        model_parallel) if model_parallel > 1 else None)
    # start the counted fit together: a rank still loading would show
    # up as the other's time inside its first collective
    torch.distributed.barrier()
    run = mesh_fit(torch, pairs, reduce_type, MESH_RANKS, model_parallel,
                   steps)
    run["grads"] = grads
    return run


def mesh_line(name, run, kernel, groups, per_step, smi) -> str:
    """The phase's text for one run; fails unless every forward on this
    rank launched exactly 5 x ROUNDS of `kernel` and no other kernel."""
    forwards = run["step"] * groups
    launches = run["launches"]
    if launches[kernel] != 5 * ROUNDS * forwards or any(
            n for k, n in launches.items() if k != kernel):
        fail(f"mesh {name}: launches {launches} for {forwards} group "
             f"forwards ({5 * ROUNDS} {kernel} per group expected)")
    coll = run["collectives"]
    return (f"{name} plan {run['plan']}: step {run['step_ms']:.2f} ms median "
            f"= {1e3 * per_step / run['step_ms']:.1f} roots/s ({smi}); "
            f"collectives {coll['calls'] / run['step']:.1f} calls and "
            f"{coll['ms'] / run['step']:.2f} ms a step (host clock inside "
            f"the calls, step 1's setup included); "
            f"{launches[kernel] // forwards} {kernel} per group forward, "
            f"{groups} groups a step on this rank; opt-state "
            f"{run['opt_bytes']} bytes on this rank; losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}")


def mesh_phase(torch, raw, spec, setup, smi) -> dict:
    """The port's mesh on the card at full width (the §8 model, 20000
    papers), every plan over the same MESH_STEPS super-batches of
    MESH_GROUPS x MESH_ROOTS target-sorted roots:
    (a) `Trainer(num_devices=1)`, sum model: one rank, no process group;
    step-1 gradients and the first PARITY_STEPS losses vs the same run
    through the plain versions by the [train] rule;
    (b) 2 ranks sharing the card, (data=2), sum model, on gloo: losses
    within MESH_LOSS_ATOL of (a), ZeRO-1 optimizer state at most (a)'s /
    MESH_ZERO_SHRINK a rank;
    (c) 2 ranks, (data=1, model=2), the mean model (its pools run
    `segment_pool_runs` on 64-wide chunks): step-1 gradients on the first
    super-batch by the [train] rule and losses within MESH_LOSS_ATOL of
    (d), one rank of the mean model;
    then the twin `ogbn_mag_train.main(["--steps", "3"])`, which must exit
    0.  Every forward launches exactly 20 `edge_mpnn_runs` (sum) or
    `segment_pool_runs` (mean) per group on each rank.  A rank that
    fails or outlives MESH_TIMEOUT_S fails the phase.  Returns the
    launches of (a) + (b)'s rank 0 and of (c)'s rank 0 + (d)."""
    import tempfile
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.orchestration import ogbn_mag_train
    train_roots = setup[0]
    per_step = MESH_GROUPS * MESH_ROOTS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        path = os.path.join(tmp, "batches.pkl")
        pairs = mesh_batches(raw, spec, train_roots, path)
        first, first_labels = pairs[0]
        worst, n_params, reached, _, _ = grad_check(torch, "sum", first,
                                                    first_labels)
        a = mesh_fit(torch, pairs, "sum", 1, 1, MESH_STEPS)
        plain = mesh_fit(torch, pairs, "sum", 1, 1, PARITY_STEPS,
                         plain=True)
        head_gap = float(np.abs(np.asarray(a["losses"][:PARITY_STEPS])
                                - np.asarray(plain["losses"])).max())
        if head_gap > LOSS_ATOL:
            fail(f"mesh (a): the first {PARITY_STEPS} losses differ from the "
                 f"plain run by {head_gap:.3e} (atol {LOSS_ATOL})")
        b = run_ranks(mesh_rank, MESH_RANKS,
                      args=(path, "sum", 1, MESH_STEPS), backend="gloo",
                      device=DEVICE + ":0", timeout_s=MESH_TIMEOUT_S)
        c = run_ranks(mesh_rank, MESH_RANKS,
                      args=(path, "mean", MESH_RANKS, MESH_STEPS),
                      backend="gloo", device=DEVICE + ":0",
                      timeout_s=MESH_TIMEOUT_S)
        d = mesh_fit(torch, pairs, "mean", 1, 1, MESH_STEPS)
        d_grads = mesh_grads(torch, pairs[0], "mean", 1, 1)
    c_grad_gap = max(mesh_grad_gap(f"(c) rank {rank}", run["grads"], d_grads)
                     for rank, run in enumerate(c))
    checks = []
    for name, runs, ref in (("(b)", b, a), ("(c)", c, d)):
        for rank, run in enumerate(runs):
            gap = float(np.abs(np.asarray(run["losses"])
                               - np.asarray(ref["losses"])).max())
            if run["step"] != MESH_STEPS or gap > MESH_LOSS_ATOL:
                fail(f"mesh {name} rank {rank}: {run['step']} steps, losses "
                     f"{run['losses']} vs one rank's {ref['losses']} (max "
                     f"gap {gap:.3e}, atol {MESH_LOSS_ATOL})")
            checks.append(gap)
    if b[0]["opt_bytes"] * MESH_ZERO_SHRINK > a["opt_bytes"]:
        fail(f"mesh (b): ZeRO-1 left {b[0]['opt_bytes']} bytes of optimizer "
             f"state a rank against one rank's {a['opt_bytes']}")
    phase("mesh", mesh_line("(a)", a, "edge_mpnn_runs", MESH_GROUPS,
                            per_step, smi)
          + f"; one rank, no process group; step-1 gradients "
          f"of {n_params} parameters ({reached} reached) max rel err vs "
          f"plain {worst:.2e} (rtol {GRAD_RTOL}); first {PARITY_STEPS} "
          f"losses vs plain {head_gap:.2e} (atol {LOSS_ATOL})")
    for name, runs, kernel, groups in (
            ("(b)", b, "edge_mpnn_runs", MESH_GROUPS // MESH_RANKS),
            ("(c)", c, "segment_pool_runs", MESH_GROUPS)):
        for rank, run in enumerate(runs):
            phase("mesh", f"rank {rank} " + mesh_line(
                name, run, kernel, groups, per_step, smi))
    phase("mesh", mesh_line("(d)", d, "segment_pool_runs", MESH_GROUPS,
                            per_step, smi))
    phase("mesh", f"(b) vs (a) and (c) vs (d): per-step losses within "
          f"{max(checks):.2e} over {MESH_STEPS} steps (atol "
          f"{MESH_LOSS_ATOL}); ZeRO-1 (b) {b[0]['opt_bytes']} vs (a) "
          f"{a['opt_bytes']} optimizer bytes a rank "
          f"({a['opt_bytes'] / b[0]['opt_bytes']:.3f}x); (c) vs (d) step-1 "
          f"gradients of {len(d_grads)} parameters on the first "
          f"super-batch, max rel err {c_grad_gap:.2e} (rtol {GRAD_RTOL})")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = ogbn_mag_train.main(["--steps", "3"])
    tail = [line for line in out.getvalue().splitlines()
            if line.startswith(("final loss", "ogbn_mag_train"))]
    if code != 0 or "ogbn_mag_train OK" not in tail:
        fail(f"mesh: the ogbn_mag_train twin exited {code}: "
             f"{out.getvalue()[-2000:]}")
    for line in tail:
        phase("mesh", f"twin: {line}")
    phase("mesh", f"phase {time.perf_counter() - t0:.1f}s")
    return {"edge_mpnn_runs": a["launches"]["edge_mpnn_runs"]
            + b[0]["launches"]["edge_mpnn_runs"],
            "segment_pool_runs": c[0]["launches"]["segment_pool_runs"]
            + d["launches"]["segment_pool_runs"]}


def twin_summary(argv: list, label: str) -> tuple:
    """The ogbn_mag_train twin's `run_twin(argv)` (its ranks are
    subprocesses), with what it printed; fails the phase when a rank
    fails."""
    from repro_torch.distributed.launch import RankFailure
    from repro_torch.orchestration import ogbn_mag_train
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            summary = ogbn_mag_train.run_twin(argv)
    except (SystemExit, RankFailure) as exc:
        fail(f"multihost: the {label} run failed ({exc!r}): "
             f"{out.getvalue()[-3000:]}")
    if len(summary["ranks"]) != MULTIHOST_RANKS:
        fail(f"multihost: the {label} run reported {len(summary['ranks'])} "
             f"ranks, not {MULTIHOST_RANKS}")
    return summary, out.getvalue()


def multihost_rank_line(label: str, rank: dict, forwards: int) -> tuple:
    """One rank's text and its median step and batch wait (ms, after the
    first step); fails unless every group forward on the rank launched
    exactly 5 x ROUNDS `edge_mpnn_runs` and no other kernel."""
    launches = rank["launches"]
    if launches["edge_mpnn_runs"] != 5 * ROUNDS * forwards or any(
            n for k, n in launches.items() if k != "edge_mpnn_runs"):
        fail(f"multihost {label} rank {rank['rank']}: launches {launches} "
             f"for {forwards} group forwards ({5 * ROUNDS} edge_mpnn_runs "
             "per group expected)")
    step = 1e3 * statistics.median(rank["step_seconds"][1:])
    wait = 1e3 * statistics.median(rank["batch_wait_seconds"][1:])
    first_step = 1e3 * rank["step_seconds"][0]
    first_wait = 1e3 * rank["batch_wait_seconds"][0]
    return (f"{label} rank {rank['rank']}: step {step:.2f} ms median, batch "
            f"wait {wait:.3f} ms median (first step {first_step:.1f} ms, "
            f"wait {first_wait:.1f}); {launches['edge_mpnn_runs'] // forwards}"
            f" edge_mpnn_runs per group forward over {forwards} (1 group a "
            "step)", step, wait)


def multihost_phase(torch, smi) -> int:
    """Multi-host sampling on the card: the ogbn_mag_train twin (the §8
    model at the twin's width, hidden 64) at ``--multihost 2
    --num-devices 2``, two processes of one gloo world sharing the card,
    every rank reading its row's batches over loopback TCP from rank 0's
    `SamplerEndpoint`; then the same argv in-process (two spawned ranks,
    each placing its block of the global super-batch).  Fails unless
    every per-step loss of each rank is within MESH_LOSS_ATOL of the
    in-process run's (the batches are bit-identical, the collectives the
    same) and every group forward on each rank launched exactly 20
    `edge_mpnn_runs`; prints both runs' median step time, batch wait and
    roots/s and their ratio (not gated: no benchmark file).  Returns the
    launches of both runs' rank 0."""
    argv = ["--num-devices", str(MULTIHOST_RANKS), "--steps",
            str(MULTIHOST_STEPS), "--papers", str(MULTIHOST_PAPERS)]
    from repro_torch.orchestration import ogbn_mag_train
    t0 = time.perf_counter()
    remote, text = twin_summary(argv + ["--multihost", str(MULTIHOST_RANKS)],
                                "--multihost")
    if "multihost: OK" not in text or "service over TCP" not in text:
        fail(f"multihost: the launcher did not report OK over TCP: "
             f"{text[-3000:]}")
    t1 = time.perf_counter()
    local, _ = twin_summary(argv, "in-process")
    t2 = time.perf_counter()
    n_test = MULTIHOST_PAPERS - int(MULTIHOST_PAPERS * 0.75)
    forwards = MULTIHOST_STEPS + n_test // ogbn_mag_train.BATCH
    gaps, steps = [], {}
    for label, run in (("--multihost", remote), ("in-process", local)):
        for rank, ref in zip(run["ranks"], local["ranks"]):
            gap = float(np.abs(np.asarray(rank["losses"])
                               - np.asarray(ref["losses"])).max())
            if rank["steps"] != MULTIHOST_STEPS or gap > MESH_LOSS_ATOL \
                    or not np.isfinite(rank["losses"]).all():
                fail(f"multihost {label} rank {rank['rank']}: "
                     f"{rank['steps']} steps, losses {rank['losses']} vs the "
                     f"in-process run's {ref['losses']} (max gap {gap:.3e}, "
                     f"atol {MESH_LOSS_ATOL})")
            gaps.append(gap)
            line, step, wait = multihost_rank_line(label, rank, forwards)
            steps.setdefault(label, []).append(step)
            phase("multihost", line)
    per_step = ogbn_mag_train.BATCH
    rates = {label: 1e3 * per_step / max(v) for label, v in steps.items()}
    phase("multihost", f"roots/s (16 roots a step over the slower rank's "
          f"median step): --multihost {rates['--multihost']:.1f}, "
          f"in-process {rates['in-process']:.1f}, ratio "
          f"{rates['--multihost'] / rates['in-process']:.3f} ({smi}); "
          f"per-step losses within {max(gaps):.2e} over {MULTIHOST_STEPS} "
          f"steps (atol {MESH_LOSS_ATOL}), final loss "
          f"{remote['final_loss']:.4f} / {local['final_loss']:.4f}, test "
          f"accuracy {remote['test_accuracy']:.4f} / "
          f"{local['test_accuracy']:.4f}; runs {t1 - t0:.1f}s / "
          f"{t2 - t1:.1f}s")
    return (remote["ranks"][0]["launches"]["edge_mpnn_runs"]
            + local["ranks"][0]["launches"]["edge_mpnn_runs"])


def load_data():
    """The synthetic MAG store, the §8 spec, the training setup and the
    first training batch on the card."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.serve.cache import VersionedGraphStore
    t0 = time.perf_counter()
    raw, _ = synthetic_mag(n_papers=20000, n_authors=10000,
                           n_institutions=40, n_fields=80,
                           n_classes=N_CLASSES, feat_dim=FEAT_DIM)
    store = VersionedGraphStore.wrap(raw)
    spec = section8_spec(store.schema)
    setup = train_setup(raw, spec)
    phase("data", f"synthetic MAG, 20000 papers; {len(setup[0])} train and "
          f"{len(setup[1])} eval roots profiled in "
          f"{time.perf_counter() - t0:.1f}s")
    first = to_device(next(iter(provider(raw, spec, setup[0],
                                         setup[2]).epoch(0))), DEVICE)
    return raw, store, spec, setup, first


def main() -> int:
    import torch
    card, smi = device_phase(torch)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package is missing: no {src}/repro_torch")
    sys.path.insert(0, src)

    build_report = build_phase()
    records = kernels_phase(torch, build_report)
    raw, store, spec, setup, first = load_data()
    runs_kernels_phase(torch, first, records, build_report)
    flash_kernels_phase(torch, first, records, build_report)

    (records["edge_mpnn"]["launches"],
     records["edge_mpnn"]["graph_launches"]) = serve_phase(torch, store, spec,
                                                           card)
    records["segment_pool"]["launches"] = mean_phase(torch, store, spec)
    (records["edge_mpnn"]["serveloop_launches"],
     records["edge_mpnn"]["twin_launches"]) = serveloop_phase(
        torch, store, spec, smi)
    trained = train_phase(torch, raw, spec, card, setup)
    records["edge_mpnn_runs"]["launches"] = trained["launches"]
    records["segment_pool_runs"]["launches"] = train_mean_phase(
        torch, raw, spec, setup)
    from repro_torch.nn.layers import init_params
    with torch.no_grad():
        states = init_params(init_states(torch), SEED).to(DEVICE)(first)
    records["flash_attention"]["launches"] = attention_phase(torch, states,
                                                             card)
    records["segment_pool_runs"]["zoo_launches"] = zoo_phase(torch, raw,
                                                             spec, setup)
    quick = quickstart_phase(torch)
    for name in ("edge_mpnn", "segment_pool", "segment_pool_runs"):
        records[name]["quickstart_launches"] = quick[name]
    records["edge_mpnn_runs"]["linkpred_launches"] = linkpred_phase(torch)
    (records["edge_mpnn_runs"]["graphcls_launches"],
     records["segment_pool_runs"]["graphcls_launches"]) = graphcls_phase(
        torch)
    records["edge_mpnn_runs"]["service_launches"] = service_phase(
        torch, raw, spec, setup, trained, smi)
    records["edge_mpnn_runs"]["outofcore_launches"] = outofcore_phase(
        torch, smi)
    mesh = mesh_phase(torch, raw, spec, setup, smi)
    for name, n in mesh.items():
        records[name]["mesh_launches"] = n
    records["edge_mpnn_runs"]["multihost_launches"] = multihost_phase(
        torch, smi)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {**{k: rec[k] for k in keys},
         **{k: v for k, v in rec.items() if k not in keys}}
        for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
