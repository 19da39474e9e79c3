"""Out-of-core training (the port's twin of
`examples/out_of_core_train.py`): the graph lives on DISK, not in any
training or sampling process.

  GraphStore -> write_graph -> GraphDirectory (mmap-able .npy CSR +
  feature files) -> a dial-in sampler fleet (`python -m
  repro_torch.storage.dial_worker`) that knows only (service address,
  directory path) -> SamplingService(backend="dial") -> runner.run.

Two runs, held to each other: the dial fleet (subprocess workers, mmap
+ remote lookups between its shards, bounded-RSS gathers) must train to
EXACTLY the same losses, over as many steps, as an in-memory thread
fleet on the same plan and seeds — the batches are bit-identical, so the
loss trajectory is too (on the card the run kernels fold every sum in a
fixed order on the target-sorted batches).  On top of that the
out-of-core claim itself: every worker's peak RSS (written through
``--rss-file``) stays BELOW the bytes of the GraphDirectory it sampled.

One deviation from the example: it trains on stacked ``[1, ...]``
super-batches (``num_devices=1``, ``num_replicas=1``), which need the
mesh the port does not have yet, so here the fleets build scalar batches
(``num_replicas=None``), the Trainer runs without a mesh
(``num_devices=None``) and the label function returns ``[C]`` root
labels.  The reference's ``runner.run(sampler="service",
num_devices=None)`` over the same fleet and plan trains the same way.

Workers are spawned through a small relay interpreter, so each
worker's ``ru_maxrss`` starts at a bare interpreter and not at this
(torch-sized) process's copy-on-write window.  They import no torch
(the port's host modules are numpy-only), run one BLAS thread, and read
feature rows with positional reads (``--gather-chunk-rows``), so a
worker holds numpy, its shard's edge pages and the rows it sampled.

    from repro_torch.orchestration import out_of_core
    result = out_of_core.run(device="cuda")
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
from torch import nn

import repro_torch
from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.sampling import InMemorySampler, SamplingSpecBuilder
from repro_torch.data.synthetic import synthetic_mag
from repro_torch.nn.layers import Embedding, Linear
from repro_torch.orchestration.runner import run as runner_run
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.orchestration.trainer import RunResult
from repro_torch.sampling_service import SamplingService
from repro_torch.storage import graph_bytes, write_graph

PAPERS, FEAT_DIM, ROOTS, STEPS, HIDDEN, WORKERS = 24_000, 1024, 64, 6, 32, 2
GATHER_CHUNK_ROWS, BATCH, N_CLASSES, VOCAB = 8, 8, 8, 4096
EPOCHS, LEARNING_RATE, TOTAL_STEPS = 2, 3e-3, 100
# only the edge and node sets the sampling spec reaches appear in batches
EDGES = {"cites": ("paper", "paper"), "written": ("paper", "author")}
# fork+exec from a small relay: the worker's ru_maxrss then starts at a
# bare interpreter, not at this process's copy-on-write window
RELAY = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


@dataclasses.dataclass
class OutOfCoreResult:
    thread: RunResult           # the in-memory thread fleet's run
    dial: RunResult             # the dial fleet's run
    graph_bytes: int            # payload bytes of the GraphDirectory
    peak_rss: list              # each dial worker's peak RSS, bytes


def sampling_spec(schema):
    """Seed papers, 6 cited papers, 4 authors of the seed and cited."""
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(6, "cites")
    cited.join([seed_op]).sample(4, "written")
    return seed_op.build()


def problem(papers: int = PAPERS, feat_dim: int = FEAT_DIM,
            roots: int = ROOTS) -> tuple:
    """(store, spec, roots, sizes): the example's synthetic MAG (papers x
    feat_dim fp32 features dominate its bytes) and batch constraints
    profiled over every root's subgraph."""
    store, _ = synthetic_mag(n_papers=papers, n_authors=papers // 4,
                             n_institutions=40, n_fields=80,
                             n_classes=N_CLASSES, feat_dim=feat_dim)
    spec = sampling_spec(mag_schema())
    root_ids = list(range(roots))
    sizes = find_size_constraints(
        InMemorySampler(store, spec, seed=0).sample(root_ids), BATCH)
    return store, spec, root_ids, sizes


class InitStates(nn.Module):
    """Paper features -> hidden states through a Linear + relu; an fp32
    id-embedding table for the authors (the §8.1 MapFeatures analogue)."""

    def __init__(self, feat_dim: int = FEAT_DIM, dim: int = HIDDEN):
        super().__init__()
        self.paper = Linear(feat_dim, dim)
        self.author = Embedding(VOCAB, dim)

    def forward(self, graph):
        ids = graph.node_sets["author"]["id"] % VOCAB
        return graph.replace_features(node_sets={
            "paper": {HIDDEN_STATE: torch.relu(self.paper(
                graph.node_sets["paper"]["feat"]))},
            "author": {HIDDEN_STATE: self.author(ids, dtype=torch.float32)},
        })


def model_fn(feat_dim: int = FEAT_DIM, hidden: int = HIDDEN):
    """(init states, a 2-round MPNN over cites and written), the
    example's model.  Its parameter tree is keyed as the reference's:
    the reference's ``{"paper", "author"}`` init states load into it."""
    return InitStates(feat_dim, hidden), vanilla_mpnn(
        EDGES, {"paper": hidden, "author": hidden}, message_dim=hidden,
        hidden_dim=hidden, num_rounds=2)


def root_labels(graph) -> np.ndarray:
    """[C] root labels of a scalar batch."""
    ns = graph.node_sets["paper"]
    return RootNodeMulticlassClassification.root_labels(
        np.asarray(ns.sizes), np.asarray(ns["labels"])).astype(np.int32)


def train_with(service, device, *, feat_dim: int = FEAT_DIM,
               hidden: int = HIDDEN, steps: int = STEPS,
               params=None) -> RunResult:
    """The example's run over `service`: 2 epochs capped at `steps`, lr
    3e-3 warming up over 50 of 100 steps, labels host-side."""
    return runner_run(
        model_fn=lambda: model_fn(feat_dim, hidden),
        task=RootNodeMulticlassClassification("paper", N_CLASSES, hidden),
        epochs=EPOCHS, learning_rate=LEARNING_RATE, total_steps=TOTAL_STEPS,
        log_every=4, max_steps=steps, sampler="service", service=service,
        label_fn=root_labels, device=device, params=params)


def fleet(store, spec, roots, sizes, *, workers: int, backend: str,
          **kwargs) -> SamplingService:
    """A sampler fleet over the example's plan (batches of 8, scalar,
    seed 0, sorted by target)."""
    return SamplingService(store, spec, roots, batch_size=BATCH,
                           sizes=sizes, num_workers=workers, seed=0,
                           base_seed=0, backend=backend, **kwargs)


def dial_run(store, spec, roots, sizes, train, *, workers: int,
             gather_chunk_rows: int, tmp: str) -> tuple:
    """Write `store` as a GraphDirectory under `tmp`, train through a
    dial fleet of `workers` subprocess workers (one shard each) on it
    with ``train(service)``; returns (result, graph bytes, each worker's
    peak RSS).  Every worker is waited for, and killed if it outlives
    the service by 30 s."""
    gdir = write_graph(store, os.path.join(tmp, "graph"))
    total = graph_bytes(gdir)
    src_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    # the workers do no linear algebra: one BLAS thread keeps numpy's
    # import from setting up a thread pool (and its memory) per core
    env = dict(os.environ, PYTHONPATH=src_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OPENBLAS_NUM_THREADS="1",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, rss_files = [], []

    def spawn_workers(address):
        host, port = address
        for w in range(workers):
            rss = os.path.join(tmp, f"worker{w}.rss")
            rss_files.append(rss)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RELAY,
                 sys.executable, "-m", "repro_torch.storage.dial_worker",
                 "--connect", f"{host}:{port}", "--graph-dir", gdir,
                 "--gather-chunk-rows", str(gather_chunk_rows),
                 "--rss-file", rss], env=env))

    svc = None
    try:
        svc = fleet(None, spec, roots, sizes, workers=workers,
                    backend="dial", num_shards=workers,
                    accept_timeout=120.0, on_listen=spawn_workers)
        result = train(svc)
    finally:
        if svc is not None:
            svc.close()
        for p in procs:
            try:
                p.wait(30.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10.0)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dial workers exited with "
                           f"{[p.returncode for p in procs]}")
    peaks = []
    for rss_file in rss_files:
        with open(rss_file) as f:
            peaks.append(int(f.read()))
    return result, total, peaks


def run(device=None, papers: int = PAPERS, feat_dim: int = FEAT_DIM,
        roots: int = ROOTS, steps: int = STEPS, hidden: int = HIDDEN,
        workers: int = WORKERS, gather_chunk_rows: int = GATHER_CHUNK_ROWS,
        *, params=None, data: Optional[tuple] = None) -> OutOfCoreResult:
    """The example end to end on `device` (CUDA by default; raises
    without a card): a thread-fleet run, then a dial-fleet run over a
    GraphDirectory in a temporary directory.  Raises unless the two
    runs take as many steps with exactly equal losses and every dial
    worker's peak RSS is below the directory's bytes.  `params`: a tree
    ``{"init", "gnn", "head"}`` in the reference's layout in place of
    the seeded draw; `data`: `problem(...)`'s tuple, to reuse."""
    store, spec, root_ids, sizes = data if data is not None else problem(
        papers, feat_dim, roots)

    def train(svc):
        return train_with(svc, device, feat_dim=feat_dim, hidden=hidden,
                          steps=steps, params=params)

    with fleet(store, spec, root_ids, sizes, workers=workers,
               backend="thread") as svc:
        ref = train(svc)
    print(f"in-memory fleet: loss {ref.train_loss:.6f} ({ref.step} steps)",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="out_of_core_") as tmp:
        got, total, peaks = dial_run(store, spec, root_ids, sizes, train,
                                     workers=workers,
                                     gather_chunk_rows=gather_chunk_rows,
                                     tmp=tmp)
    print(f"dial fleet:      loss {got.train_loss:.6f} ({got.step} steps)",
          flush=True)
    if got.step != ref.step or \
            got.metrics["train_losses"] != ref.metrics["train_losses"]:
        raise RuntimeError(
            f"out-of-core losses {got.metrics['train_losses']} != "
            f"in-memory losses {ref.metrics['train_losses']}")
    for w, peak in enumerate(peaks):
        print(f"worker {w}: peak RSS {peak / 2**20:.1f} MB / graph "
              f"{total / 2**20:.1f} MB (ratio {peak / total:.3f})",
              flush=True)
        if peak >= total:
            raise RuntimeError(f"worker {w} peak RSS {peak} >= graph "
                               f"bytes {total}: not out-of-core")
    return OutOfCoreResult(ref, got, total, peaks)
