"""The port's twin of `examples/ogbn_mag_train.py`: the paper's §8
OGBN-MAG case study, soup to nuts, on the port's mesh.

  schema -> SamplingSpecBuilder (Fig. 6) -> distributed sampler (Alg. 1,
  persisted shards) -> GraphBatcher (merge + pad, R component groups) ->
  4-round MPNN (Fig. 7/8) -> RootNodeMulticlassClassification ->
  runner.run over a ("data", "model") mesh of torch.distributed ranks.

At the example's defaults (1200 papers, hidden 64, 4 epochs, 16 roots a
step) and with its flags.  ``--num-devices N --model-parallel M`` folds
N ranks (one device each) into N/M data rows x M model columns; the
batch becomes a super-batch of N/M padded component groups whose size
constraints are profiled per group (``find_size_constraints(graphs, 16
// (N/M))``), so every mesh trains to the same loss.  Outside a world,
``--num-devices N > 1`` spawns its N ranks itself (the spawn start
method; a `FileStore` in a temporary directory, so no port is raced
for) and prints rank 0's result; ``--backend`` picks gloo or NCCL (NCCL
by default when the card count covers the ranks, gloo otherwise: two
ranks can share one card only on gloo).  With the in-process sampler
every rank is handed the same global super-batches and places its own
block of the groups, as the example's single-process run does.

    python -m repro_torch.orchestration.ogbn_mag_train --device cpu \\
        --num-devices 4 --model-parallel 2 --steps 3 --papers 240

``--sampler service`` streams the training batches from the port's
sampler fleet instead (same plan, same per-root seeds, bit-identical
batches).  On one rank the fleet is the Trainer's own.  Over several
ranks each rank reads its own stream: a process of the port is one rank
on one device, so the reference's host holding a data row is a rank
here, and rank ``r`` of a (data=R, model=M) mesh reads the stream of its
row, ``SamplingService(rank=r // M, world=R, num_replicas=1)``, which is
group ``r // M`` of the global super-batch bit for bit.  Rank 0 hosts a
`SamplerEndpoint` whose factory builds that fleet for each client rank
and publishes its address to a file (atomically, by `os.replace`); every
rank, rank 0 included, reads through its own `RemoteStreamClient` over
TCP.  The M model columns of a row each get their own fleet, so a row's
stream is sampled M times.  Eval batches are the same per-row shards,
and the metrics are summed over the data axis.

``--multihost N`` is the reference's launcher: the module re-runs itself
as N processes with the same argv, exporting ``REPRO_COORDINATOR`` (a
`FileStore` in the launcher's temporary directory, so no port is raced
for), ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID`` and
``REPRO_ENDPOINT_FILE``; each joins the world and takes the endpoint
path above.  One process is one rank, so N must equal
``--num-devices``; the global mesh is the one the reference builds from
N processes of ``D / N`` devices, and the loss is the same.  Each rank
logs to ``--multihost-log-dir`` (a temporary directory by default,
printed at launch); the launcher prints each rank's exit code and log
tail and ``multihost: OK`` or ``multihost: FAILED``, and fails if any
rank failed or outlived ``RANKS_TIMEOUT_S``:

    python -m repro_torch.orchestration.ogbn_mag_train --device cpu \\
        --num-devices 4 --model-parallel 2 --steps 3 --papers 240 \\
        --multihost 4
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.pipeline import GraphBatcher
from repro_torch.data.sampling import (SamplingSpecBuilder,
                                       distributed_sample, shard_partition)
from repro_torch.data.serialization import load_graphs
from repro_torch.data.synthetic import synthetic_mag
from repro_torch.distributed import partition
from repro_torch.distributed.launch import run_ranks
from repro_torch.nn.layers import Embedding, Linear
from repro_torch.orchestration.runner import run
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification

BATCH, N_CLASSES, FEAT_DIM, VOCAB, NUM_SHARDS = 16, 8, 32, 4096, 4
RANKS_TIMEOUT_S = 900.0   # ranks (spawned or launched) still running: killed
ENDPOINT_WAIT_S = 120.0   # a rank waits this long for rank 0's endpoint
SUMMARY = "rank summary: "   # a --multihost rank's result line in its log
LOG_TAIL_BYTES = 2000
MODULE = "repro_torch.orchestration.ogbn_mag_train"   # what --multihost runs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--papers", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps", type=int, default=None,
                    help="cap total train steps (smoke runs use --steps 3)")
    ap.add_argument("--num-devices", type=int, default=1,
                    help="ranks of the mesh, one device each; outside a "
                         "torch.distributed world >1 spawns them")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model columns of the 2-D mesh (must divide "
                         "--num-devices)")
    ap.add_argument("--sampler", choices=["inprocess", "service"],
                    default="inprocess")
    ap.add_argument("--sampler-workers", type=int, default=2)
    ap.add_argument("--multihost", type=int, default=0, metavar="N",
                    help="launch N processes of one world (N must equal "
                         "--num-devices); rank 0 hosts the sampler "
                         "endpoint every rank streams from over TCP")
    ap.add_argument("--multihost-log-dir", default="",
                    help="directory of the per-rank logs (default: a "
                         "temporary directory, printed at launch)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="torch.distributed backend of spawned ranks "
                         "(default: nccl when each rank has its own card, "
                         "else gloo)")
    ap.add_argument("--init-params", default="",
                    help="an .npz of the initial parameters by dotted name "
                         "(the reference Trainer's `_init_params` tree, "
                         "flattened), in place of the seeded draw")
    return ap.parse_args(argv)


def section8_spec(schema):
    """The §8 sampling spec (paper Fig. 6)."""
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    authors = cited.join([seed_op]).sample(4, "written")
    author_papers = authors.sample(4, "writes")
    authors.sample(4, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(4, "has_topic")
    return seed_op.build()


class InitStates(nn.Module):
    """MapFeatures analogue: paper features -> uniform hidden states;
    id-embedding tables for authors, institutions and fields (§8.1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.paper = Linear(FEAT_DIM, dim)
        self.author = Embedding(VOCAB, dim)
        self.field_of_study = Embedding(VOCAB, dim)
        self.institution = Embedding(VOCAB, dim)

    def forward(self, graph):
        ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
            graph.node_sets["paper"]["feat"]))}}
        for n in ("author", "institution", "field_of_study"):
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {HIDDEN_STATE: getattr(self, n)(ids,
                                                    dtype=torch.float32)}
        return graph.replace_features(node_sets=ns)


def super_batch_labels(graph) -> np.ndarray:
    """Per-group root labels [R, C] from a stacked super-batch."""
    root_labels = RootNodeMulticlassClassification.root_labels
    arr = np.asarray(graph.node_sets["paper"].sizes)
    lab = np.asarray(graph.node_sets["paper"]["labels"])
    return np.stack([root_labels(arr[r], lab[r])
                     for r in range(arr.shape[0])]).astype(np.int32)


def _launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process."""
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    from repro_torch.kernels.segment_pool import kernel as seg
    return {fn.__name__: fn.launches
            for fn in (mpnn.edge_mpnn, mpnn.edge_mpnn_runs,
                       seg.segment_pool, seg.segment_pool_runs)}


def _publish_endpoint(path: str, address) -> None:
    """Write the endpoint's (host, port) for the other ranks, atomically
    (the port is OS-assigned: nothing is known before the bind)."""
    tmp_path = path + ".tmp"
    with open(tmp_path, "w") as f:
        f.write(f"{address[0]}:{address[1]}")
    os.replace(tmp_path, path)


def _read_endpoint(path: str, rank: int) -> tuple:
    deadline = time.monotonic() + ENDPOINT_WAIT_S
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                host, port = f.read().strip().rsplit(":", 1)
                return host, int(port)
        except (FileNotFoundError, ValueError):
            time.sleep(0.05)
    raise SystemExit(f"rank {rank}: no endpoint address in {path} after "
                     f"{ENDPOINT_WAIT_S:.0f}s")


def train(args: argparse.Namespace,
          endpoint_file: Optional[str] = None) -> dict:
    """One rank's run (or the whole run at one rank); returns this
    rank's view: the final loss, the test accuracy, the per-step losses,
    step and batch-wait seconds and the kernels' launch counts.  With
    ``endpoint_file`` (several ranks, ``--sampler service`` or
    ``--multihost``) every rank reads its row's stream from rank 0's
    `SamplerEndpoint`, whose address goes through that file."""
    schema = mag_schema()
    store, _ = synthetic_mag(n_papers=args.papers,
                             n_authors=args.papers // 2, n_institutions=40,
                             n_fields=80, n_classes=N_CLASSES,
                             feat_dim=FEAT_DIM)
    spec = section8_spec(schema)
    rank = partition.world_rank()
    is_main = rank == 0
    if is_main:
        print("sampling ops:", [op.op_name for op in spec.sampling_ops])
    with tempfile.TemporaryDirectory() as tmp:
        n_train = int(args.papers * 0.75)
        shards = distributed_sample(store, spec, range(args.papers), tmp,
                                    num_shards=NUM_SHARDS)
        graphs = [g for p in shards for g in load_graphs(p)]
    root_order = np.concatenate(shard_partition(range(args.papers),
                                                NUM_SHARDS))
    train_graphs, test_graphs = graphs[:n_train], graphs[n_train:]
    train_roots = root_order[:n_train]

    dim = args.hidden
    edges = {name: (es.source, es.target)
             for name, es in schema.edge_sets.items()}
    gnn_dims = {n: dim for n in schema.node_sets}

    def model_fn():
        return InitStates(dim), vanilla_mpnn(
            edges, gnn_dims, message_dim=dim, hidden_dim=dim,
            num_rounds=4, use_layer_norm=True)

    ndev, mp = args.num_devices, args.model_parallel
    if ndev % mp:
        raise SystemExit(f"--model-parallel {mp} must divide "
                         f"--num-devices {ndev}")
    rep = ndev // mp  # data shards = component groups per super-batch
    if BATCH % rep:
        raise SystemExit(f"data shards {rep} must divide batch size "
                         f"{BATCH}")
    sizes = find_size_constraints(graphs, BATCH // rep)
    task = RootNodeMulticlassClassification("paper", N_CLASSES, dim)

    per_rank = endpoint_file is not None
    # per-rank streams: this rank's row is one group of a `rep`-way
    # split; otherwise one host: rank 0 of world 1, all `rep` groups
    row, rows, groups = (rank // mp, rep, 1) if per_rank else (0, 1, rep)

    def batches_for(gs):
        batcher = GraphBatcher(gs, BATCH, sizes, seed=0, rank=row,
                               world=rows, num_replicas=groups)

        def gen(epoch):
            for graph in batcher.epoch(epoch):
                yield graph, super_batch_labels(graph)

        return gen

    params = None
    if args.init_params:
        with np.load(args.init_params) as data:
            params = {k: data[k] for k in data.files}
    run_kwargs = dict(model_fn=model_fn, task=task, epochs=args.epochs,
                      learning_rate=3e-3, total_steps=600,
                      eval_batches=lambda: batches_for(test_graphs)(0),
                      ckpt_dir="", log_every=20, num_devices=ndev,
                      model_parallel=mp, max_steps=args.steps,
                      device=args.device, params=params)
    if per_rank:
        from repro_torch.sampling_service import (RemoteStreamClient,
                                                  SamplerEndpoint,
                                                  SamplingService)
        endpoint = None
        if is_main:
            def row_fleet(client_rank):
                return SamplingService(
                    store, spec, train_roots, batch_size=BATCH, sizes=sizes,
                    num_workers=args.sampler_workers, num_replicas=1,
                    seed=0, rank=client_rank // mp, world=rep, base_seed=0)
            endpoint = SamplerEndpoint(row_fleet)
            _publish_endpoint(endpoint_file, endpoint.address)
        client = RemoteStreamClient(_read_endpoint(endpoint_file, rank),
                                    rank)
        try:
            result = run(sampler="service", service=client,
                         label_fn=super_batch_labels, **run_kwargs)
            # every rank is done reading before rank 0 closes the endpoint
            torch.distributed.barrier()
        finally:
            client.close()
            if endpoint is not None:
                endpoint.close()
        sampler = "service over TCP"
    elif args.sampler == "service":
        from repro_torch.sampling_service import SamplingService
        with SamplingService(store, spec, train_roots, batch_size=BATCH,
                             sizes=sizes, num_workers=args.sampler_workers,
                             num_replicas=rep, seed=0, base_seed=0) as svc:
            result = run(sampler="service", service=svc,
                         label_fn=super_batch_labels, **run_kwargs)
        sampler = "service"
    else:
        result = run(train_batches=batches_for(train_graphs), **run_kwargs)
        sampler = "inprocess"
    summary = {"rank": rank,
               "final_loss": result.train_loss,
               "test_accuracy": result.metrics["eval_accuracy"],
               "steps": result.step,
               "losses": result.metrics["train_losses"],
               "step_seconds": result.metrics["step_seconds"],
               "batch_wait_seconds": result.metrics["batch_wait_seconds"],
               "launches": _launch_counts(),
               "backend": partition.backend_name()}
    if is_main:
        print(f"final loss {result.train_loss:.4f}  test accuracy "
              f"{summary['test_accuracy']:.4f}  ({ndev} device(s) = {rep} "
              f"data x {mp} model over {partition.world_size()} rank(s), "
              f"backend {summary['backend']}, {result.step} steps, "
              f"{sampler} sampler)", flush=True)
    if args.steps is None and summary["test_accuracy"] <= 0.5:
        # full runs keep the example's accuracy gate
        raise SystemExit(f"test accuracy {summary['test_accuracy']:.4f} "
                         "<= 0.5 after a full run")
    return summary


def _rank_entry(argv: list, endpoint_file: Optional[str]) -> dict:
    return train(parse_args(argv), endpoint_file)


def _default_backend(args) -> str:
    if args.backend is not None:
        return args.backend
    on_card = args.device is None or str(args.device).startswith("cuda")
    if on_card and torch.cuda.device_count() >= args.num_devices:
        return "nccl"
    return "gloo"


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL a launched rank's process group: the rank and the sampler
    workers it forked."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass  # the group is gone already
    proc.wait()


def launch_multihost(args, argv: list) -> dict:
    """The ``--multihost N`` launcher (the reference example's
    `_launch_multihost`): re-run this module with `argv` as N processes
    of one world, each in its own session and logging to
    ``--multihost-log-dir``; kill every rank (with the sampler workers it
    forked) once one fails or `RANKS_TIMEOUT_S` passes; print each
    rank's exit code and log tail, then ``multihost: OK`` or ``multihost:
    FAILED``.  Returns rank 0's summary with every rank's under "ranks";
    raises SystemExit(1) when a rank failed."""
    import repro_torch
    n = args.multihost
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    log_dir = args.multihost_log_dir or tempfile.mkdtemp(
        prefix="ogbn_multihost_logs_")
    os.makedirs(log_dir, exist_ok=True)
    backend = _default_backend(args)
    with tempfile.TemporaryDirectory(prefix="ogbn_multihost_") as tmp:
        coordinator = f"file://{os.path.join(tmp, 'store')}"
        print(f"multihost: {n} processes x 1 device, backend {backend}, "
              f"coordinator {coordinator}, logs in {log_dir}", flush=True)
        procs = []
        try:
            for r in range(n):
                env = dict(os.environ,
                           PYTHONPATH=os.pathsep.join(
                               [src] + [p for p in os.environ.get(
                                   "PYTHONPATH", "").split(os.pathsep)
                                        if p]),
                           REPRO_COORDINATOR=coordinator,
                           REPRO_NUM_PROCESSES=str(n),
                           REPRO_PROCESS_ID=str(r),
                           REPRO_ENDPOINT_FILE=os.path.join(
                               tmp, "endpoint_addr"))
                with open(os.path.join(log_dir, f"rank{r}.log"),
                          "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", MODULE, *argv],
                        env=env, stdout=log, stderr=subprocess.STDOUT,
                        start_new_session=True))
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            timed_out = False
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break  # a rank failed: its peers would wait for it
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                _kill_group(p)
    codes = [p.returncode for p in procs]
    summaries = []
    for r, code in enumerate(codes):
        with open(os.path.join(log_dir, f"rank{r}.log"), "rb") as f:
            log = f.read().decode(errors="replace")
        note = (f" (killed after {RANKS_TIMEOUT_S:.0f}s)"
                if timed_out and code == -signal.SIGKILL else "")
        print(f"--- rank {r} exit {code}{note}; log tail ---\n"
              f"{log[-LOG_TAIL_BYTES:]}", flush=True)
        lines = [line for line in log.splitlines()
                 if line.startswith(SUMMARY)]
        if lines:
            summaries.append(json.loads(lines[-1][len(SUMMARY):]))
    ok = not timed_out and all(c == 0 for c in codes) \
        and len(summaries) == n
    print("multihost:", "OK" if ok else "FAILED", flush=True)
    if not ok:
        raise SystemExit(1)
    return dict(summaries[0], ranks=summaries)


def run_twin(argv: Optional[list] = None) -> dict:
    """Run the twin as ``main`` does and return rank 0's summary; a run
    that starts ranks (spawned, or launched by ``--multihost``) also
    holds every rank's summary under "ranks"."""
    argv = list(argv or [])
    args = parse_args(argv)
    if args.multihost and args.multihost != args.num_devices:
        raise SystemExit(
            f"--multihost {args.multihost} needs --num-devices "
            f"{args.multihost}, got {args.num_devices}: a process of the "
            "port is one rank on one device, so the processes are the "
            "mesh's devices")
    if args.multihost > 1 and "REPRO_PROCESS_ID" not in os.environ:
        return launch_multihost(args, argv)
    if args.multihost > 1:
        # a launched rank: join the world, train, report to the launcher
        partition.initialize_distributed(backend=_default_backend(args))
        try:
            summary = train(args, os.environ["REPRO_ENDPOINT_FILE"])
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        print(SUMMARY + json.dumps(summary), flush=True)
        return summary
    if args.num_devices > 1 and partition.world_size() == 1:
        backend = _default_backend(args)
        print(f"spawning {args.num_devices} ranks, backend {backend}",
              flush=True)
        with tempfile.TemporaryDirectory(prefix="ogbn_endpoint_") as tmp:
            endpoint_file = (os.path.join(tmp, "endpoint_addr")
                             if args.sampler == "service" else None)
            ranks = run_ranks(_rank_entry, args.num_devices,
                              args=(argv, endpoint_file), backend=backend,
                              timeout_s=RANKS_TIMEOUT_S)
        return dict(ranks[0], ranks=ranks)
    return train(args)


def main(argv: Optional[list] = None) -> int:
    run_twin(argv)
    if partition.world_rank() == 0:
        print("ogbn_mag_train OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
