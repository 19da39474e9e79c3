"""Link prediction on a heterogeneous edge set (the port's twin of
`examples/link_prediction_train.py`), through the orchestration layer
and the sample-on-demand `StoreProvider`:

  synthetic MAG store -> SamplingSpec (paper/cites/written/writes) ->
  StoreProvider (Algorithm 1 per step) -> 2-round hetero MPNN ->
  LinkPrediction("writes"): bilinear author->paper pair scores with
  seeded per-component negatives -> Trainer.

Negatives are drawn host-side from `seed_rng(base_seed, (epoch, step))`,
as the reference draws them, so both packages train on the same
negatives.  The defaults are the example's: 480 papers, hidden 32, 2
rounds, 4 negatives, batches of 16, 3 epochs, trained as the example
trains them: stacked ``[1, ...]`` super-batches (``num_replicas=1``) on
a one-rank mesh (``num_devices=1``).  On the card every
training forward runs the rounds through `edge_mpnn_runs` (the batches
sort edges by target).

    from repro_torch.orchestration import link_prediction
    result = link_prediction.run(device="cuda")
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.sampling import (SamplingSpecBuilder, sample_subgraph,
                                       seed_rng)
from repro_torch.data.synthetic import synthetic_mag
from repro_torch.nn.layers import Embedding, Linear
from repro_torch.orchestration.providers import StoreProvider
from repro_torch.orchestration.tasks import LinkPrediction
from repro_torch.orchestration.trainer import RunResult, Trainer

PAPERS, EPOCHS, HIDDEN, ROUNDS, NEGATIVES = 480, 3, 32, 2, 4
BATCH, FEAT_DIM, VOCAB = 16, 32, 4096
LEARNING_RATE, TOTAL_STEPS = 3e-3, 300
EDGES = {"cites": ("paper", "paper"), "written": ("paper", "author"),
         "writes": ("author", "paper")}


def sampling_spec(schema):
    """Seed papers, their citations, the authorship neighborhood: "writes"
    (author -> paper) is the edge set the task scores."""
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    authors = cited.join([seed_op]).sample(4, "written")
    authors.sample(4, "writes")
    return seed_op.build()


def providers(papers: int = PAPERS) -> tuple:
    """(train, validation) StoreProviders over the first 75% and the rest
    of the papers, padded to sizes profiled over every root's subgraph."""
    store, _ = synthetic_mag(n_papers=papers, n_authors=papers // 2,
                             n_institutions=40, n_fields=80, n_classes=8,
                             feat_dim=FEAT_DIM)
    spec = sampling_spec(mag_schema())
    roots = np.arange(papers)
    n_train = int(papers * 0.75)
    profile = [sample_subgraph(store, spec, int(r), seed_rng(0, int(r)))
               for r in roots]
    sizes = find_size_constraints(profile, BATCH)
    return tuple(StoreProvider(store, spec, part, batch_size=BATCH,
                               sizes=sizes, seed=0, num_replicas=1,
                               base_seed=0)
                 for part in (roots[:n_train], roots[n_train:]))


class InitStates(nn.Module):
    """Paper features through a Linear + relu, author id embeddings."""

    def __init__(self, dim: int = HIDDEN):
        super().__init__()
        self.paper = Linear(FEAT_DIM, dim)
        self.author = Embedding(VOCAB, dim)

    def forward(self, graph):
        ids = graph.node_sets["author"]["id"] % VOCAB
        return graph.replace_features(node_sets={
            "paper": {HIDDEN_STATE: torch.relu(self.paper(
                graph.node_sets["paper"]["feat"]))},
            "author": {HIDDEN_STATE: self.author(ids, dtype=torch.float32)},
        })


def model_fn(hidden: int = HIDDEN, rounds: int = ROUNDS):
    """(init states, the rounds-deep MPNN), the example's model."""
    return InitStates(hidden), vanilla_mpnn(
        EDGES, {"paper": hidden, "author": hidden}, message_dim=hidden,
        hidden_dim=hidden, num_rounds=rounds, use_layer_norm=True)


def run(device=None, *, papers: int = PAPERS, epochs: int = EPOCHS,
        hidden: int = HIDDEN, rounds: int = ROUNDS,
        negatives: int = NEGATIVES, steps: int | None = None,
        params=None, data=None) -> RunResult:
    """Train the example on `device` (CUDA by default; raises without a
    card) and evaluate once at the end; `steps` caps the training steps.
    `params`: a tree ``{"init", "gnn", "head"}`` in the reference's layout
    in place of the seeded draw; `data`: `providers(papers)`'s pair, to
    reuse.  The result's metrics hold "train_losses", "eval" (accuracy
    and loss) and "params"."""
    train, val = data if data is not None else providers(papers)
    trainer = Trainer(epochs=epochs, learning_rate=LEARNING_RATE,
                      total_steps=TOTAL_STEPS, num_devices=1,
                      max_steps=steps, log_every=20, eval_at="end",
                      device=device)
    task = LinkPrediction("writes", hidden, num_negatives=negatives,
                          base_seed=0)
    return trainer.fit(lambda: model_fn(hidden, rounds), task, train,
                       eval_provider=val, params=params)
