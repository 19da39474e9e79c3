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
ranks can share one card only on gloo).  Every rank is handed the same
global super-batches and places its own block of the groups, as the
example's single-process run does (its ``rank``/``world`` are hosts,
here one).

    python -m repro_torch.orchestration.ogbn_mag_train --device cpu \\
        --num-devices 4 --model-parallel 2 --steps 3 --papers 240

``--sampler service`` streams the training batches from the port's
sampler fleet instead (same plan, same per-root seeds, bit-identical
batches) — on one rank.  Not ported yet: ``--sampler service`` over
several ranks and ``--multihost``, which need the reference's
`sampling_service/remote.py` (ROADMAP queue 1 item 4); both raise.
"""
from __future__ import annotations

import argparse
import tempfile
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
RANKS_TIMEOUT_S = 900.0   # spawned ranks still running then are killed
NOT_PORTED = ("needs the reference's sampling_service/remote.py "
              "(SamplerEndpoint, RemoteStreamClient), which the port does "
              "not have yet: ROADMAP queue 1 item 4")


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
    ap.add_argument("--multihost", type=int, default=0, metavar="N")
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


def train(args: argparse.Namespace) -> dict:
    """One rank's run (or the whole run at one rank); returns rank 0's
    view: the final loss, the test accuracy and the per-step losses."""
    schema = mag_schema()
    store, _ = synthetic_mag(n_papers=args.papers,
                             n_authors=args.papers // 2, n_institutions=40,
                             n_fields=80, n_classes=N_CLASSES,
                             feat_dim=FEAT_DIM)
    spec = section8_spec(schema)
    is_main = partition.world_rank() == 0
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

    def batches_for(gs):
        # one host: rank 0 of world 1, all `rep` groups of every step
        batcher = GraphBatcher(gs, BATCH, sizes, seed=0, rank=0, world=1,
                               num_replicas=rep)

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
    if args.sampler == "service":
        from repro_torch.sampling_service import SamplingService
        with SamplingService(store, spec, train_roots, batch_size=BATCH,
                             sizes=sizes, num_workers=args.sampler_workers,
                             num_replicas=rep, seed=0, base_seed=0) as svc:
            result = run(sampler="service", service=svc,
                         label_fn=super_batch_labels, **run_kwargs)
    else:
        result = run(train_batches=batches_for(train_graphs), **run_kwargs)
    summary = {"final_loss": result.train_loss,
               "test_accuracy": result.metrics["eval_accuracy"],
               "steps": result.step,
               "losses": result.metrics["train_losses"],
               "backend": partition.backend_name()}
    if is_main:
        print(f"final loss {result.train_loss:.4f}  test accuracy "
              f"{summary['test_accuracy']:.4f}  ({ndev} device(s) = {rep} "
              f"data x {mp} model over {partition.world_size()} rank(s), "
              f"backend {summary['backend']}, {result.step} steps, "
              f"{args.sampler} sampler)", flush=True)
    if args.steps is None and summary["test_accuracy"] <= 0.5:
        # full runs keep the example's accuracy gate
        raise SystemExit(f"test accuracy {summary['test_accuracy']:.4f} "
                         "<= 0.5 after a full run")
    return summary


def _rank_entry(argv: list) -> dict:
    return train(parse_args(argv))


def _default_backend(args) -> str:
    if args.backend is not None:
        return args.backend
    on_card = args.device is None or str(args.device).startswith("cuda")
    if on_card and torch.cuda.device_count() >= args.num_devices:
        return "nccl"
    return "gloo"


def run_twin(argv: Optional[list] = None) -> dict:
    """Run the twin as ``main`` does and return rank 0's summary."""
    argv = list(argv or [])
    args = parse_args(argv)
    if args.multihost:
        raise SystemExit(f"--multihost {NOT_PORTED}")
    if args.sampler == "service" and args.num_devices > 1:
        raise SystemExit(f"--sampler service over {args.num_devices} ranks "
                         f"{NOT_PORTED}")
    if args.num_devices > 1 and partition.world_size() == 1:
        backend = _default_backend(args)
        print(f"spawning {args.num_devices} ranks, backend {backend}",
              flush=True)
        return run_ranks(_rank_entry, args.num_devices, args=(argv,),
                         backend=backend, timeout_s=RANKS_TIMEOUT_S)[0]
    return train(args)


def main(argv: Optional[list] = None) -> int:
    run_twin(argv)
    if partition.world_rank() == 0:
        print("ogbn_mag_train OK", flush=True)
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(main(sys.argv[1:]))
