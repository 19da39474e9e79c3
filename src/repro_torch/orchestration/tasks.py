"""Tasks (counterpart of `repro.orchestration.tasks`): the objective
that reads a model's output graph.  This slice ports the §8 root-node
classification task; the Task protocol's training side (labels streams,
metrics) comes with the training slice."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_tensor import GraphTensor, HIDDEN_STATE
from repro_torch.nn.layers import Linear


class RootNodeMulticlassClassification:
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
