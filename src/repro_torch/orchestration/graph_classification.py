"""Graph-level classification (the port's twin of
`examples/graph_classification_train.py`), through the orchestration
layer proper:

  synthetic MUTAG-shaped set -> BatcherProvider (merge + pad, edges
  sorted by target) -> stacked multi-round MPNN -> GraphMulticlass-
  Classification (context-pooled readout) -> Trainer with a per-epoch
  eval stream, early stopping and best-checkpoint tracking.

The defaults are the example's: 480 graphs, 3 classes, hidden 32, 3
rounds, batches of 16, 6 epochs, patience 3, a save every 20 steps,
trained as the example trains them: stacked ``[1, ...]`` super-batches
(``num_replicas=1``) on a one-rank mesh (``num_devices=1``).  On
the card the rounds run through `edge_mpnn_runs` and the readout's mean
through `segment_pool_runs`, both folding in a fixed order on the sorted
batches, so a resumed run repeats an uninterrupted one's losses exactly.

    from repro_torch.orchestration import graph_classification
    result = graph_classification.run(device="cuda", ckpt_dir="/tmp/ck")
"""
from __future__ import annotations

import os

import torch
from torch import nn

from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.synthetic import synthetic_graph_classification
from repro_torch.distributed.fault_tolerance import best_checkpoint
from repro_torch.nn.layers import Linear
from repro_torch.orchestration.evaluation import EarlyStopping
from repro_torch.orchestration.providers import BatcherProvider
from repro_torch.orchestration.tasks import GraphMulticlassClassification
from repro_torch.orchestration.trainer import RunResult, Trainer

GRAPHS, CLASSES, EPOCHS, HIDDEN, ROUNDS = 480, 3, 6, 32, 3
BATCH, FEAT_DIM, PATIENCE, SAVE_INTERVAL = 16, 16, 3, 20
LEARNING_RATE, TOTAL_STEPS = 3e-3, 400


def providers(graphs: int = GRAPHS, classes: int = CLASSES) -> tuple:
    """(train, validation) BatcherProviders over the first 75% and the
    rest of the synthetic set, padded to sizes profiled over all of it."""
    data = synthetic_graph_classification(
        num_graphs=graphs, num_classes=classes, feat_dim=FEAT_DIM, seed=0)
    n_train = int(graphs * 0.75)
    sizes = find_size_constraints(data, BATCH)
    return (BatcherProvider(data[:n_train], BATCH, sizes, seed=0,
                            num_replicas=1),
            BatcherProvider(data[n_train:], BATCH, sizes, seed=0,
                            num_replicas=1))


class InitStates(nn.Module):
    """Atom features -> hidden states (Linear + relu)."""

    def __init__(self, dim: int = HIDDEN):
        super().__init__()
        self.atoms = Linear(FEAT_DIM, dim)

    def forward(self, graph):
        h = torch.relu(self.atoms(graph.node_sets["atoms"]["feat"]))
        return graph.replace_features(node_sets={"atoms": {HIDDEN_STATE: h}})


def model_fn(hidden: int = HIDDEN, rounds: int = ROUNDS):
    """(init states, the stacked `rounds`-layer MPNN over the bonds)."""
    return InitStates(hidden), vanilla_mpnn(
        {"bonds": ("atoms", "atoms")}, {"atoms": hidden},
        message_dim=hidden, hidden_dim=hidden, num_rounds=rounds,
        use_layer_norm=True)


def run(device=None, *, graphs: int = GRAPHS, classes: int = CLASSES,
        epochs: int = EPOCHS, hidden: int = HIDDEN, rounds: int = ROUNDS,
        steps: int | None = None, ckpt_dir: str = "", resume: bool = False,
        patience: int = PATIENCE, params=None, data=None) -> RunResult:
    """Train the example on `device` (CUDA by default; raises without a
    card), evaluating after every epoch; `steps` caps the training steps.
    With `ckpt_dir`, checkpoints every 20 steps and pins the best eval
    epoch's step, whose directory the result's metrics name as
    "best_checkpoint" (RuntimeError when it is missing, as the example
    asserts); `resume` continues from the latest checkpoint there.
    `params`: a tree ``{"init", "gnn", "head"}`` in the reference's layout
    in place of the seeded draw; `data`: `providers(graphs, classes)`'s
    pair, to reuse."""
    train, val = data if data is not None else providers(graphs, classes)
    trainer = Trainer(
        epochs=epochs, learning_rate=LEARNING_RATE, total_steps=TOTAL_STEPS,
        num_devices=1, max_steps=steps, log_every=20, ckpt_dir=ckpt_dir,
        save_interval_steps=SAVE_INTERVAL, resume=resume, eval_at="epoch",
        early_stopping=EarlyStopping(monitor="loss", patience=patience,
                                     mode="min"),
        device=device)
    task = GraphMulticlassClassification("atoms", classes, hidden)
    result = trainer.fit(lambda: model_fn(hidden, rounds), task, train,
                         eval_provider=val, params=params)
    if ckpt_dir:
        best = best_checkpoint(ckpt_dir)
        if best is None or not os.path.isdir(best):
            raise RuntimeError(f"no best checkpoint in {ckpt_dir}")
        result.metrics["best_checkpoint"] = best
    return result
