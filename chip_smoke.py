#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the served shapes, then
serves the full-width §8 OGBN-MAG model (init states -> 4-round
vanilla_mpnn over all five edge sets, 128 wide -> root-node head)
through `repro_torch.serve.gnn.GNNServer` on the card, and runs the
mean-pooling variant of the same model, whose pooling is the
`segment_pool` kernel.  Each phase prints one line; any failure exits
non-zero.  The line before the last is a JSON record of every kernel
(launches on the served path, error against the plain version, times on
the card, bound); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or without the `src/repro_torch` package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

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

# closed loop: one outstanding request per client, every root fresh; 500
# requests, so p99 is a tail and not the single slowest request
LOOP_CLIENTS = 4
LOOP_REQUESTS = 125


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


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    phase("build", f"both kernels built in parallel in {seconds:.1f}s")


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


def kernels_phase(torch):
    """The has_topic conv at rung 8: n_src = 1224 papers, n_tgt = 4896
    fields, E = 4896 edges, 128 wide; ~5% padding edges (tgt >= n_tgt),
    and ~37% of the targets receive no edge."""
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref

    dev = torch.device("cuda")
    n_src, n_tgt, e, d = 1224, 4896, 4896, DIM
    rng = np.random.default_rng(SEED)
    src = torch.from_numpy(rng.integers(0, n_src, e).astype(np.int32)).to(dev)
    tgt_np = rng.integers(0, n_tgt, e).astype(np.int32)
    tgt_np[rng.random(e) < 0.05] = n_tgt + 7  # padding edges
    tgt = torch.from_numpy(tgt_np).to(dev)
    n_valid = int((tgt_np < n_tgt).sum())
    n_empty = n_tgt - len(np.unique(tgt_np[tgt_np < n_tgt]))

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    h_src, h_tgt = normal(n_src, d), normal(n_tgt, d)
    w, b = normal(2 * d, d, scale=(2 * d) ** -0.5), normal(d, scale=0.1)
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
    nbytes = ((n_src * d + n_tgt * d + 2 * d * d + d + n_tgt * d) * isz
              + 2 * e * 4)
    flops = 2 * n_valid * (2 * d) * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    records["edge_mpnn"] = dict(
        name="edge_mpnn", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:182",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    phase("kernels", f"edge_mpnn fp32/bf16 x relu/gelu/identity match the "
          f"plain version (fp32 max err {max(errs):.2e}); fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{records['edge_mpnn']['bound_ms']:.4f} ms "
          f"({records['edge_mpnn']['bound_by']}); {n_valid} valid edges")

    # -- segment_pool --------------------------------------------------------
    vals = normal(e, d)
    ints = torch.from_numpy(rng.integers(-8, 8, (e, d)).astype(np.float32)
                            ).to(dev)
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
    safe = torch.where(tgt < n_tgt, tgt, n_tgt).long()
    acc = torch.zeros(n_tgt + 1, d, device=dev)
    library_ms = time_ms(torch, lambda: acc.index_add_(0, safe, vals))
    # padding rows' values are never read
    nbytes = n_valid * d * isz + e * 4 + n_tgt * d * isz
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, n_valid * d / PEAK_FP32_FLOPS
    records["segment_pool"] = dict(
        name="segment_pool", route="cuda",
        source="src/repro_torch/kernels/segment_pool/segment_pool.cu",
        replaces="src/repro/kernels/segment_pool/kernel.py:193",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms)
    phase("kernels", f"segment_pool: int sums bit-exact, max/min exact, "
          f"sum fp32 max err {err:.2e}, bf16 cast back; {n_empty} empty "
          f"segments; sum {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"index_add_ {library_ms:.4f} ms, bound "
          f"{records['segment_pool']['bound_ms']:.4f} ms")

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


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

def build_model(torch, reduce_type: str):
    """Init states -> vanilla_mpnn (5 edge sets, 4 rounds, 128/128,
    LayerNorm) -> RootNodeMulticlassClassification head, with parameters
    drawn from a seeded generator."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE
    from repro_torch.core.models import vanilla_mpnn
    from repro_torch.core.schema import mag_schema
    from repro_torch.nn.layers import Embedding, Linear, init_params
    from repro_torch.orchestration.tasks import (
        RootNodeMulticlassClassification)

    class InitStates(torch.nn.Module):
        """Paper features -> hidden states; id-embedding tables (fp32)
        for the featureless node sets (ids % 4096), as §8 does."""

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

    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            schema = mag_schema()
            edges = {k: (v.source, v.target)
                     for k, v in schema.edge_sets.items()}
            self.task = RootNodeMulticlassClassification("paper", N_CLASSES,
                                                         DIM)
            self.init = InitStates()
            self.gnn = vanilla_mpnn(edges, {n: DIM for n in schema.node_sets},
                                    message_dim=DIM, hidden_dim=DIM,
                                    num_rounds=ROUNDS, use_layer_norm=True,
                                    reduce_type=reduce_type)
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
    by_kernel = {}  # device-side events only: CPU ops would count twice
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
    fwd_ms = (t5 - t4) * 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    profile = (", ".join(f"{k[:48]} {us / 1e3:.3f} ms x{n}"
                         for k, (us, n) in top)
               if by_kernel else "profiler saw no device time")
    return (f"rung {len(roots)}: sample {(t1 - t0) * 1e3:.2f} ms, "
            f"merge+pad {(t2 - t1) * 1e3:.2f} ms, to_device "
            f"{(t3 - t2) * 1e3:.2f} ms, forward wall {fwd_ms:.2f} ms "
            f"(CUDA events {start.elapsed_time(end):.2f} ms), profiler "
            f"device busy {busy_ms:.3f} ms = "
            f"{100 * busy_ms / fwd_ms:.1f}% of the forward wall, "
            f"{n_kernels} device kernels; top: {profile}")


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
        edge_mpnn.launches = segment_pool.launches = 0
        batches0 = server.stats.batches
        checks = []
        for n in (1, 2, 4, 8, 3, 8):
            roots = fresh_roots(rng, used, n, n_papers)
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        clients = [fresh_roots(rng, used, LOOP_REQUESTS, n_papers)
                   for _ in range(LOOP_CLIENTS)]
        latencies, errors, duration = closed_loop(server, clients)
        stats = server.stats
        launches = edge_mpnn.launches
        pool_launches = segment_pool.launches
        batches = stats.batches - batches0
    finally:
        server.close()
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
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.serve.gnn import GNNServer

    model = build_model(torch, "mean")
    server = GNNServer(store, spec, model, device="cuda",
                       max_batch=MAX_BATCH, batch_window_ms=5.0)
    rng = np.random.default_rng(SEED + 2)
    used = set()
    try:
        edge_mpnn.launches = segment_pool.launches = 0
        batches0 = server.stats.batches
        checks = []
        for n in (8, 5):
            roots = fresh_roots(rng, used, n, store.num_nodes["paper"])
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        stats = server.stats
        launches = segment_pool.launches
        mpnn_launches = edge_mpnn.launches
        batches = stats.batches - batches0
    finally:
        server.close()
    if stats.failed or stats.steady_state_recompiles:
        fail(f"mean serve: {stats.failed} failed, "
             f"{stats.steady_state_recompiles} recompiles")
    if launches != 5 * ROUNDS * batches or mpnn_launches:
        fail(f"mean path: segment_pool launched {launches} times, edge_mpnn "
             f"{mpnn_launches}, for {batches} batches")
    max_err = max(check_logits("mean", got, plain_logits(
        torch, server, store, spec, roots), len(roots))
        for roots, got in checks)
    phase("mean", f"mean-pooling model served: {batches} batches, "
          f"segment_pool launches {launches} ({5 * ROUNDS}/forward), "
          f"logits vs plain max err {max_err:.2e}")
    return launches


def main() -> int:
    import torch
    card, smi = device_phase(torch)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package is missing: no {src}/repro_torch")
    sys.path.insert(0, src)

    build_phase()
    records = kernels_phase(torch)

    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.serve.cache import VersionedGraphStore
    t0 = time.perf_counter()
    raw, _ = synthetic_mag(n_papers=20000, n_authors=10000,
                           n_institutions=40, n_fields=80,
                           n_classes=N_CLASSES, feat_dim=FEAT_DIM)
    store = VersionedGraphStore.wrap(raw)
    spec = section8_spec(store.schema)
    phase("data", f"synthetic MAG, 20000 papers, in "
          f"{time.perf_counter() - t0:.1f}s")

    records["edge_mpnn"]["launches"] = serve_phase(torch, store, spec, card)
    records["segment_pool"]["launches"] = mean_phase(torch, store, spec)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
