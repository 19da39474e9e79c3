#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the five hand-written CUDA kernels from the sources in the
checkout (one `nvcc` per source, all in parallel) and holds each against
its plain PyTorch version: `edge_mpnn` and `segment_pool` at the served
shapes, `edge_mpnn_runs` and `segment_pool_runs` at the trained shapes,
on sorted and unsorted ids, and `flash_attention` at the graph-attention
shape of a training batch, the reference envelope's corner and an LM
causal GQA prefill.  Then it drives the port's paths at the full width
of the §8 OGBN-MAG model (init states -> 4-round vanilla_mpnn over all
five edge sets, 128 wide, LayerNorm -> root-node head, 8 classes):

* serving: `repro_torch.serve.gnn.GNNServer` on the card, and the
  mean-pooling variant of the same model (`[serve]`, `[mean]`);
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
  `hgt_like` trained a few steps through the Trainer (`[zoo]`).

Each path is run with every kernel's launch count set to 0 just before
it and read just after.  Each phase prints one line; any failure prints
``FAIL:`` and exits non-zero.  The line before the last is a JSON record
of every kernel (launches on its path, error against the plain version,
times on the card, bound; for the two pooling kernels also host and
device µs per call, device kernels per call, a second `index_add_`
yardstick and the zoo's score shape); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or without the `src/repro_torch` package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
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


def device_per_call(torch, fn, calls: int = 20) -> dict:
    """The device work of one call of `fn`, from torch.profiler over
    `calls` calls: device µs (kernels and memsets), and the kernels and
    memsets it ran, per call, with the kernels' names."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us, kernels, memsets, names = 0.0, 0, 0, set()
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != cuda:
            continue
        us += getattr(ev, "self_device_time_total", 0) or 0
        if "memset" in ev.key.lower():
            memsets += ev.count
        else:
            kernels += ev.count
            name = ev.key.replace("(anonymous namespace)::", "")
            names.add(name.split("(")[0].split("<")[0].split("::")[-1]
                      .removeprefix("void "))
    return dict(device_us=us / calls, kernels=kernels / calls,
                memsets=memsets / calls, names=sorted(names))


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
        usage = [ln.split(":", 1)[1].strip()
                 for ln in rep["log"].splitlines() if "registers" in ln]
        phase("build", f"{name}: {rep['seconds']:.1f}s; "
              + " | ".join(usage))
    phase("build", f"{len(report)} kernels built in parallel in "
          f"{seconds:.1f}s")


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


def _bound(nbytes: int, flops: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and fp32 operations over its fp32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def pool_launch_costs(torch, kernel, vals, ids, n, check=True) -> dict:
    """One pooling kernel's launch costs at (vals, ids): host µs to
    enqueue an fp32 sum, its device µs, kernels and memsets per call
    (torch.profiler), and the device kernels per call of max, min and a
    bf16 sum.  With `check`, fails unless an fp32 sum runs exactly one
    kernel and at most one memset, and every other case one or two
    kernels (the redesign's launch budget)."""
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
    if check:
        if by_case["sum fp32"] != 1 or dev["memsets"] > 1:
            fail(f"{name}: an fp32 sum ran {by_case['sum fp32']} device "
                 f"kernels ({dev['names']}) and {dev['memsets']} memsets per "
                 "call (1 kernel and at most 1 memset expected)")
        for label, k in by_case.items():
            if not 1 <= k <= 2:
                fail(f"{name}: {label} ran {k} device kernels per call "
                     "(1 or 2 expected)")
    return dict(host_us=host_us(torch, fn), device_us=dev["device_us"],
                device_kernels=dev["kernels"], memsets=dev["memsets"],
                kernels_by_case=by_case)


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


def kernels_phase(torch):
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
    errs = []
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
    ms = time_ms(torch, lambda: edge_mpnn(h_src, h_tgt, src, tgt, w, b,
                                          n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    isz = 4
    bound_ms, bound_by = _bound(
        (n_src * d + n_tgt * d + 2 * d * d + d + n_tgt * d) * isz + 2 * e * 4,
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn"] = dict(
        name="edge_mpnn", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:182",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    phase("kernels", f"edge_mpnn fp32/bf16 x relu/gelu/identity match the "
          f"plain version (fp32 max err {max(errs):.2e}); fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{records['edge_mpnn']['bound_ms']:.4f} ms "
          f"({records['edge_mpnn']['bound_by']}); {n_valid} valid edges")

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

    # -- widths past one tile: edge_mpnn walks M in 256-column tiles, and
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
    phase("kernels", f"wide: edge_mpnn 512 -> 384 (two column tiles) max "
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


def runs_kernels_phase(torch, batch, records):
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

    def message_sums(act, dtype=torch.float32, absolute=True):
        """Per target row, the sum of (|)message(|) over its edges."""
        x = torch.cat([h_src[src.long()], h_tgt[tgt.clamp(max=n_tgt - 1)
                                                .long()]], dim=-1).to(dtype)
        msg = activate(x @ w.to(dtype) + b.to(dtype), act)
        msg = torch.where((tgt < n_tgt)[:, None], msg.abs() if absolute
                          else msg, 0.0)
        return torch.zeros(n_tgt + 1, d, dtype=dtype, device=dev).index_add_(
            0, tgt.long(), msg)[:n_tgt]

    # -- edge_mpnn_runs ------------------------------------------------------
    errs = []
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
                else:  # the cast back to bf16 dominates
                    _close(torch, name, got, want, 2e-2, 2e-2)
    # which order sums closer to the exact value: both against fp64
    exact = message_sums("relu", torch.float64, absolute=False)
    kernel_err = (edge_mpnn_runs(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                                 n_tgt=n_tgt).double() - exact).abs().max()
    plain_err = (edge_mpnn_ref(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                               n_tgt=n_tgt).double() - exact).abs().max()
    ms = time_ms(torch, lambda: edge_mpnn_runs(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    any_order_ms = time_ms(torch, lambda: edge_mpnn(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    isz = 4
    bound_ms, bound_by = _bound(
        (n_src * d + n_tgt * d + 2 * d * d + d + n_tgt * d) * isz + 2 * e * 4,
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn_runs"] = dict(
        name="edge_mpnn_runs", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn_runs.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:129",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    phase("kernels", f"edge_mpnn_runs sorted+unsorted x fp32/bf16 x "
          f"relu/gelu/identity match the plain version (fp32 max err "
          f"{max(errs):.2e}, the padding node's {int(counts.max())}-edge "
          f"run; vs fp64, relu: kernel {kernel_err.item():.2e}, plain "
          f"{plain_err.item():.2e}); trained shape n_src {n_src} n_tgt {n_tgt} "
          f"E {e} ({n_valid} valid, {n_runs} target runs): sorted fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs edge_mpnn "
          f"{any_order_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

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
          f"bit-exact, max/min exact, sum fp32 max err {err:.2e} (vs "
          f"fp64: kernel {kernel_err.item():.2e}, plain "
          f"{plain_err.item():.2e}), bf16 cast back; sorted sum {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs segment_pool {any_order_ms:.4f} ms "
          f"vs index_add_ {library_ms:.4f} ms (zeros + index_add_ "
          f"{zeroed_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by}); per "
          f"call: host {costs['host_us']:.2f} us, device "
          f"{costs['device_us']:.2f} us, device kernels "
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
    d4_bound = _bound(n_valid * ATTN_HEADS * isz + e * 4
                      + n_tgt * ATTN_HEADS * isz, n_valid * ATTN_HEADS)
    d4 = {}
    for reduce, x in (("max", scores), ("sum", ex)):
        kernel_fn = functools.partial(segment_pool_runs, x, tgt,
                                      n_segments=n_tgt, reduce=reduce)
        dev_cost = device_per_call(torch, kernel_fn)
        if not 1 <= dev_cost["kernels"] <= (1 if reduce == "sum" else 2):
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
          f"{ATTN_HEADS}]: max exact, exp-sum max err {d4_err:.2e}; "
          + "; ".join(f"{r} {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} "
                      f"ms, host {c['host_us']:.2f} us, device "
                      f"{c['device_us']:.2f} us in {c['device_kernels']} "
                      f"kernels + {c['memsets']} memsets"
                      for r, c in d4.items())
          + f", bound {d4_bound[0]:.5f} ms ({d4_bound[1]})")
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
    phase("kernels", f"wide, sorted: edge_mpnn_runs 512 -> 384 (two column "
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

    return init_params(Served(), SEED).to("cuda").eval()


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
        return server.run_batch(merge_and_pad(graphs, sizes))[:len(roots)]


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
    from CUDA events, and device time by kernel from torch.profiler."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    t0 = time.perf_counter()
    graphs = [sample_subgraph(store, spec, r, seed_rng(0, r)) for r in roots]
    t1 = time.perf_counter()
    merged = merge_and_pad(graphs, server.ladder.sizes[len(roots)])
    t2 = time.perf_counter()
    g = to_device(merged, server.device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with torch.inference_mode():
        model(g)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t4 = time.perf_counter()
        start.record()
        model(g).cpu()
        end.record()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(g).cpu()
            torch.cuda.synchronize()
    busy_ms, n_kernels, profile = device_profile(torch, prof)
    fwd_ms = (t5 - t4) * 1e3
    return (f"rung {len(roots)}: sample {(t1 - t0) * 1e3:.2f} ms, "
            f"merge+pad {(t2 - t1) * 1e3:.2f} ms, to_device "
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

def serve_phase(torch, store, spec, card):
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.serve.gnn import GNNServer

    model = build_model(torch, "sum")
    t0 = time.perf_counter()
    server = GNNServer(store, spec, model, device="cuda",
                       max_batch=MAX_BATCH, batch_window_ms=5.0)
    warm_s = time.perf_counter() - t0
    try:
        if server.ladder.rungs != (1, 2, 4, 8):
            fail(f"bucket ladder {server.ladder.rungs}, expected (1, 2, 4, 8)")
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
        launches = edge_mpnn.launches
        pool_launches = segment_pool.launches
        batches = stats.batches - batches0
    finally:
        server.close()
    if counts["edge_mpnn_runs"] or counts["segment_pool_runs"]:
        fail(f"serving launched a run kernel: {counts} (its batches are "
             "not sorted by target)")
    if errors or stats.failed:
        fail(f"{errors} client errors, {stats.failed} failed requests")
    if stats.steady_state_recompiles != 0:
        fail(f"{stats.steady_state_recompiles} steady-state recompiles")
    if set(stats.batch_sizes) != set(server.ladder.rungs):
        fail(f"served buckets {sorted(stats.batch_sizes)} do not cover "
             f"the ladder {server.ladder.rungs}")
    if launches != per_forward * batches:
        fail(f"edge_mpnn launched {launches} times for {batches} batches "
             f"({per_forward} per forward expected)")
    max_err = max(check_logits("serve", got, plain_logits(
        torch, server, store, spec, roots), len(roots))
        for roots, got in checks)
    phase("profile", breakdown(torch, server, model, store, spec,
                               fresh_roots(rng, used, MAX_BATCH, n_papers)))
    p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
    qps = len(latencies) / duration
    phase("serve", f"{card}: warmup {warm_s:.1f}s, ladder "
          f"{list(server.ladder.rungs)}, {n_convs // len(server.ladder.rungs)}"
          f" convs/forward all on edge_mpnn, {batches} batches "
          f"{dict(sorted(stats.batch_sizes.items()))}, edge_mpnn "
          f"launches {launches}, segment_pool launches {pool_launches}, "
          f"logits vs plain max err {max_err:.2e}, closed loop "
          f"{LOOP_CLIENTS} clients x {LOOP_REQUESTS} = {len(latencies)} "
          f"requests: p50 {p50:.2f} ms p99 {p99:.2f} ms {qps:.1f} QPS, "
          f"0 recompiles, 0 failed")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the mean-pooling variant (generic conv path -> segment_pool)
# ---------------------------------------------------------------------------

def mean_phase(torch, store, spec):
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.serve.gnn import GNNServer

    model = build_model(torch, "mean")
    server = GNNServer(store, spec, model, device="cuda",
                       max_batch=MAX_BATCH, batch_window_ms=5.0)
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
        launches = segment_pool.launches
        batches = stats.batches - batches0
    finally:
        server.close()
    if stats.failed or stats.steady_state_recompiles:
        fail(f"mean serve: {stats.failed} failed, "
             f"{stats.steady_state_recompiles} recompiles")
    if launches != 5 * ROUNDS * batches or any(
            counts[k] for k in ("edge_mpnn", "edge_mpnn_runs",
                                "segment_pool_runs")):
        fail(f"mean path: launches {counts} for {batches} batches "
             f"({5 * ROUNDS} segment_pool per forward expected)")
    max_err = max(check_logits("mean", got, plain_logits(
        torch, server, store, spec, roots), len(roots))
        for roots, got in checks)
    phase("mean", f"mean-pooling model served: {batches} batches, "
          f"segment_pool launches {launches} ({5 * ROUNDS}/forward), "
          f"logits vs plain max err {max_err:.2e}")
    return launches


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
                hidden: int = DIM):
    """The Trainer's model at step 0: TrainModel(init, gnn, head) drawn
    with init_params(model, SEED), on the card; (init, gnn) are `parts`,
    or the §8 model with `reduce_type` pooling."""
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    init, gnn = parts if parts is not None else model_parts(torch,
                                                            reduce_type)
    model = TrainModel(init, gnn, root_task(hidden).head())
    return init_params(model, SEED).to(DEVICE)


def grad_check(torch, reduce_type: str, batch, labels, parts=None,
               hidden: int = DIM) -> tuple:
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
    names the model in messages).  Returns (worst relative error,
    parameters, parameters the loss reaches, kernel loss, plain loss)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    task = root_task(hidden)
    model = fresh_model(torch, reduce_type, parts, hidden)
    params = dict(model.named_parameters())
    g = to_device(batch, DEVICE)
    lab = torch.as_tensor(labels).to(DEVICE)

    def grads():
        loss = task.loss_from_graph(model.head, model(g), lab)
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


def train_phase(torch, raw, spec, card, setup) -> int:
    """Train the sum model: step-1 gradient check, the counted Trainer
    run with its eval pass, the same run twice through the plain
    versions, the eval pass on the trained parameters through the plain
    versions, and the step loop (time split, same-parameter loss
    parity).  Returns edge_mpnn_runs' launches."""
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
    # independent runs part once a ReLU input within rounding of 0 flips
    # sign on one path: its gradient jumps, and Adam scales the jump to a
    # full lr-sized step.  So the trajectories are held together over the
    # first PARITY_STEPS steps (warmup keeps lr small there), each step is
    # held on shared parameters in step_loop, and the plain path's own
    # run-to-run spread is measured beside them.
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
    phase("train", f"{card}: {TRAIN_STEPS} steps x {TRAIN_BATCH} roots + "
          f"eval {eval_steps} x {TRAIN_BATCH}; step-1 gradients of "
          f"{n_params} parameters ({reached} reached by the loss on both "
          f"paths) all finite, max rel err vs plain "
          f"{worst:.2e} (rtol {GRAD_RTOL}); step-1 loss {loss_k:.6f} (CPU "
          f"{loss_cpu:.6f}); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; independent runs, max |kernel - plain| over "
          f"the first {PARITY_STEPS} steps {head_gap:.2e} (atol "
          f"{LOSS_ATOL}), over all {TRAIN_STEPS} {gaps.max():.2e} (plain "
          f"vs plain {spread:.2e}); eval accuracy {acc:.4f} loss "
          f"{eval_loss:.4f} (plain on the same parameters "
          f"{plain_eval['accuracy']:.4f} / {plain_eval['loss']:.4f}); "
          f"launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"{step_ms:.2f} ms median = {1e3 * TRAIN_BATCH / step_ms:.1f} "
          f"roots/s")
    profile, step_gap = step_loop(torch, train)
    if step_gap > STEP_LOSS_ATOL:
        fail(f"train: on the same parameters, a step's kernel loss differs "
             f"from the plain one by {step_gap:.3e} (atol {STEP_LOSS_ATOL})")
    phase("train-profile", f"{profile}; same-parameter loss gap kernel vs "
          f"plain over {TRAIN_STEPS} steps {step_gap:.2e} (atol "
          f"{STEP_LOSS_ATOL})")
    return launches["edge_mpnn_runs"]


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


def flash_bound(torch, q, k, seg) -> tuple:
    """(bound_ms, bound_by, allowed pairs) for fp32 inputs: 4 D flops per
    (query, key) pair the mask allows, per head (sum of n_c^2 over the
    segments of the one batch row, or S (S + 1) / 2 per batch row for the
    causal shape); q, k, v and out read or written once, plus the
    segment ids."""
    b, s, h, d = q.shape
    if seg is not None:
        pairs = int((torch.bincount(seg.flatten().long()) ** 2).sum())
    else:
        pairs = b * s * (s + 1) // 2
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    if seg is not None:
        nbytes += 2 * seg.numel() * 4
    bound_ms, bound_by = _bound(nbytes, 4 * d * h * pairs)
    return bound_ms, bound_by, pairs


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


def flash_kernels_phase(torch, batch, records):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lines = []
    for label, (q, k, v, seg, causal) in flash_shapes(torch, batch).items():
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = [x.to(dtype) for x in (q, k, v)]
            got = flash_attention(*args, seg, causal=causal)
            want = attention_ref(*args, seg, causal=causal)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"flash_attention ({label}): got {got.dtype} "
                     f"{tuple(got.shape)}")
            err = _close(torch, f"flash_attention[({label}), {dtype}]", got,
                         want, tol, tol)
            if dtype == torch.float32:
                fp32_err = err
                for _ in range(2):
                    if not torch.equal(flash_attention(*args, seg,
                                                       causal=causal), got):
                        fail(f"flash_attention ({label}): repeat launches "
                             "are not bit-identical")
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
        library = sdpa_call(torch, q, k, v, seg, causal)
        lib_err = (library().transpose(1, 2) - attention_ref(
            q, k, v, seg, causal=causal)).abs().max().item()
        ms = time_ms(torch, lambda: flash_attention(q, k, v, seg,
                                                    causal=causal))
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, seg,
                                                        causal=causal))
        library_ms = time_ms(torch, library)
        bound_ms, bound_by, pairs = flash_bound(torch, q, k, seg)
        b, s, h, d = q.shape
        lines.append(
            f"({label}) B {b} S {s} H {h} K {k.shape[2]} D {d}"
            f"{' causal' if causal else ''}"
            f"{f' {seg.unique().numel()} segments' if seg is not None else ''}"
            f": {pairs} pairs, fp32 max err {fp32_err:.2e}; fp32 {ms:.4f} ms "
            f"vs plain {plain_ms:.4f} ms vs SDPA {library_ms:.4f} ms (max "
            f"err {lib_err:.2e}), bound {bound_ms:.4f} ms ({bound_by})")
        if label == "a":  # the shape of the [attention] path
            records["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:79",
                max_abs_err=fp32_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    for line in lines:
        phase("kernels", f"flash_attention fp32/bf16 match the plain "
              f"version, repeats bit-identical: {line}")


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

    build_phase()
    records = kernels_phase(torch)
    raw, store, spec, setup, first = load_data()
    runs_kernels_phase(torch, first, records)
    flash_kernels_phase(torch, first, records)

    records["edge_mpnn"]["launches"] = serve_phase(torch, store, spec, card)
    records["segment_pool"]["launches"] = mean_phase(torch, store, spec)
    records["edge_mpnn_runs"]["launches"] = train_phase(torch, raw, spec,
                                                        card, setup)
    records["segment_pool_runs"]["launches"] = train_mean_phase(
        torch, raw, spec, setup)
    from repro_torch.nn.layers import init_params
    with torch.no_grad():
        states = init_params(init_states(torch), SEED).to(DEVICE)(first)
    records["flash_attention"]["launches"] = attention_phase(torch, states,
                                                             card)
    records["segment_pool_runs"]["zoo_launches"] = zoo_phase(torch, raw,
                                                             spec, setup)

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
