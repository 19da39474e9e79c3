"""Tasks (counterpart of `repro.orchestration.tasks`): the objective that
reads a model's output graph.

A `Task` adapts a base GNN (GraphTensor -> GraphTensor) to a training
objective (paper §5: the runner's Task protocol).  It owns:

  * the trainable readout **head** (`head() -> nn.Module`);
  * **label extraction** (`labels(graph, epoch=, step=)`, host-side, on
    numpy batches, scalar or stacked);
  * the **loss** (`loss_from_graph(head, graph, labels)`, on the device);
  * **metrics** (`metrics(head, graph, labels)`: a dict of
    ``(numerator, denominator)`` pairs, so streams aggregate exactly —
    the Trainer sums both sides over batches and divides once).

The graph-level methods default through the legacy surface
(`predict(head, graph)` + ``loss(logits, labels, weights)``), as in the
reference.  Device-side methods always see a SCALAR graph.  This slice
ports the §8 root-node classification task; the other tasks come with a
later slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph_tensor import GraphTensor, HIDDEN_STATE
from repro_torch.nn.layers import Linear


def _context_weights(graph: GraphTensor) -> torch.Tensor:
    """Per-component training weight: 1 real, 0 padding."""
    return graph.context.sizes.to(torch.float32)


class Task:
    """Adapts model output (a GraphTensor) to an objective."""

    # -- legacy surface ------------------------------------------------------

    def head(self) -> nn.Module:  # trainable readout head
        raise NotImplementedError

    def predict(self, head: nn.Module, graph: GraphTensor) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, logits, labels, weights) -> torch.Tensor:
        raise NotImplementedError

    # -- the Trainer protocol ------------------------------------------------

    def labels(self, graph: GraphTensor, *, epoch: int = 0,
               step: int = 0) -> np.ndarray:
        """Host-side label extraction from one (possibly stacked) batch:
        a pure function of ``(graph, epoch, step)``."""
        raise NotImplementedError

    def loss_from_graph(self, head: nn.Module, graph: GraphTensor,
                        labels: torch.Tensor) -> torch.Tensor:
        """Device-side scalar loss for one SCALAR graph.  Default:
        legacy predict + per-component context weights."""
        return self.loss(self.predict(head, graph), labels,
                         _context_weights(graph))

    def metrics(self, head: nn.Module, graph: GraphTensor,
                labels: torch.Tensor) -> dict:
        """Device-side metric accumulators for one SCALAR graph:
        ``{name: (numerator, denominator)}``.  Default: the weighted loss
        itself."""
        den = _context_weights(graph).sum()
        return {"loss": (self.loss_from_graph(head, graph, labels) * den,
                         den)}

    def metric_names(self) -> tuple:
        """The SORTED keys `metrics` produces, known up front."""
        return ("loss",)


class RootNodeMulticlassClassification(Task):
    """Paper §8.4: classify the root node (index 0 of each component) of a
    sampled subgraph.  Labels: [C] int per component; padding components
    carry weight 0 via context.sizes."""

    def __init__(self, node_set_name: str, num_classes: int,
                 hidden_dim: int, *, label_feature: str = "labels"):
        self.node_set_name = node_set_name
        self.num_classes = num_classes
        self.hidden_dim = hidden_dim
        self.label_feature = label_feature

    def head(self) -> Linear:
        return Linear(self.hidden_dim, self.num_classes)

    @staticmethod
    def root_labels(sizes_row: np.ndarray, labels_row: np.ndarray
                    ) -> np.ndarray:
        """Host-side per-component root (= first node) labels from one
        padded node set's ``sizes`` row and per-node labels row."""
        starts = np.concatenate([[0], np.cumsum(sizes_row)[:-1]])
        return labels_row[np.minimum(starts, len(labels_row) - 1)]

    def labels(self, graph: GraphTensor, *, epoch: int = 0,
               step: int = 0) -> np.ndarray:
        ns = graph.node_sets[self.node_set_name]
        sizes = np.asarray(ns.sizes)
        lab = np.asarray(ns[self.label_feature])
        if sizes.ndim == 1:  # scalar batch
            return self.root_labels(sizes, lab).astype(np.int32)
        return np.stack([self.root_labels(sizes[r], lab[r])
                         for r in range(sizes.shape[0])]).astype(np.int32)

    def root_states(self, graph: GraphTensor) -> torch.Tensor:
        """Hidden state of each component's root = first node (the sampler
        puts the seed first; see repro_torch.data.sampling)."""
        ns = graph.node_sets[self.node_set_name]
        sizes = ns.sizes
        starts = torch.cumsum(sizes, 0) - sizes
        return ns[HIDDEN_STATE][torch.clamp(starts, max=ns.capacity - 1)]

    def predict(self, head: Linear, graph: GraphTensor) -> torch.Tensor:
        return head(self.root_states(graph))

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[:, None].to(torch.int64),
                                  dim=-1)[:, 0]
        nll = (logz - ll) * weights
        return nll.sum() / torch.clamp(weights.sum(), min=1.0)

    def metrics(self, head: Linear, graph: GraphTensor,
                labels: torch.Tensor) -> dict:
        logits = self.predict(head, graph)
        weights = _context_weights(graph)
        correct = ((torch.argmax(logits, -1) == labels) * weights).sum()
        den = weights.sum()
        return {"accuracy": (correct, den),
                "loss": (self.loss(logits, labels, weights) * den, den)}

    def metric_names(self) -> tuple:
        return ("accuracy", "loss")
