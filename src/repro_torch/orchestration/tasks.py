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
reference.  Device-side methods always see a SCALAR graph.  The tasks:
root-node classification (paper §8.4), graph binary and multiclass
classification, link prediction with seeded host-side negatives, and
Deep Graph Infomax.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import ops
from repro_torch.core.graph_tensor import GraphTensor, HIDDEN_STATE
from repro_torch.data.sampling import seed_rng
from repro_torch.nn.layers import Linear


def _context_weights(graph: GraphTensor) -> torch.Tensor:
    """Per-component training weight: 1 real, 0 padding."""
    return graph.context.sizes.to(torch.float32)


def _class_nll(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean softmax cross-entropy over components."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[:, None].to(torch.int64),
                              dim=-1)[:, 0]
    return ((logz - ll) * weights).sum() / torch.clamp(weights.sum(),
                                                       min=1.0)


def _class_metrics(logits, labels, weights, loss) -> dict:
    """Accuracy and loss as (numerator, denominator) pairs."""
    correct = ((torch.argmax(logits, -1) == labels) * weights).sum()
    den = weights.sum()
    return {"accuracy": (correct, den), "loss": (loss * den, den)}


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
        return _class_nll(logits, labels, weights)

    def metrics(self, head: Linear, graph: GraphTensor,
                labels: torch.Tensor) -> dict:
        logits = self.predict(head, graph)
        weights = _context_weights(graph)
        return _class_metrics(logits, labels, weights,
                              self.loss(logits, labels, weights))

    def metric_names(self) -> tuple:
        return ("accuracy", "loss")


class GraphBinaryClassification(Task):
    """Graph-level binary objective via mean-pooled node states."""

    def __init__(self, node_set_name: str, hidden_dim: int, *,
                 label_feature: str = "label"):
        self.node_set_name = node_set_name
        self.hidden_dim = hidden_dim
        self.label_feature = label_feature

    def head(self) -> Linear:
        return Linear(self.hidden_dim, 1)

    def predict(self, head: Linear, graph: GraphTensor) -> torch.Tensor:
        pooled = ops.pool_nodes_to_context(
            graph, self.node_set_name, "mean", feature_name=HIDDEN_STATE)
        return head(pooled)[:, 0]

    def labels(self, graph: GraphTensor, *, epoch: int = 0,
               step: int = 0) -> np.ndarray:
        return np.asarray(graph.context[self.label_feature], np.float32)

    def loss(self, logits, labels, weights):
        nll = (F.softplus(logits) - logits * labels) * weights
        return nll.sum() / torch.clamp(weights.sum(), min=1.0)


class GraphMulticlassClassification(Task):
    """Graph-level classification à la MUTAG (paper §5 Task list): one
    label per component, read out from context-pooled node states.

    Labels come from a per-component context feature (``label_feature``)
    that each input graph carries into `merge_graphs`/`pad_to_sizes`
    (padding components get label 0 at weight 0).  Context pooling runs on
    sorted component ids, so on the card it is `segment_pool_runs`."""

    def __init__(self, node_set_name: str, num_classes: int,
                 hidden_dim: int, *, label_feature: str = "label",
                 reduce_type: str = "mean"):
        self.node_set_name = node_set_name
        self.num_classes = num_classes
        self.hidden_dim = hidden_dim
        self.label_feature = label_feature
        self.reduce_type = reduce_type

    def head(self) -> Linear:
        return Linear(self.hidden_dim, self.num_classes)

    def predict(self, head: Linear, graph: GraphTensor) -> torch.Tensor:
        return head(ops.pool_nodes_to_context(
            graph, self.node_set_name, self.reduce_type,
            feature_name=HIDDEN_STATE))

    def labels(self, graph: GraphTensor, *, epoch: int = 0,
               step: int = 0) -> np.ndarray:
        return np.asarray(graph.context[self.label_feature], np.int32)

    def loss(self, logits, labels, weights):
        return _class_nll(logits, labels, weights)

    def metrics(self, head: Linear, graph: GraphTensor,
                labels: torch.Tensor) -> dict:
        logits = self.predict(head, graph)
        weights = _context_weights(graph)
        return _class_metrics(logits, labels, weights,
                              self.loss(logits, labels, weights))

    def metric_names(self) -> tuple:
        return ("accuracy", "loss")


class LinkPrediction(Task):
    """Self-supervised link prediction on one (heterogeneous) edge set.

    Positives are the valid edges of ``edge_set_name``; each is scored as
    a bilinear source/target pair ``(W h_src) . h_tgt``.  For every
    positive, ``num_negatives`` corrupted targets are drawn host-side from
    the SAME component's valid target nodes and shipped to the device as
    the batch's "labels" (an int32 ``[E, K]`` index array).  All draws for
    the batch at ``(epoch, step)`` come from ``seed_rng(base_seed,
    (epoch << 32) | step)`` (`negative_rng`), the reference's derivation,
    so both packages draw the same negatives array for array."""

    def __init__(self, edge_set_name: str, hidden_dim: int, *,
                 num_negatives: int = 4, base_seed: int = 0):
        if num_negatives < 1:
            raise ValueError(f"num_negatives must be >= 1, "
                             f"got {num_negatives}")
        self.edge_set_name = edge_set_name
        self.hidden_dim = hidden_dim
        self.num_negatives = num_negatives
        self.base_seed = base_seed

    def head(self) -> Linear:
        # the bilinear scorer weight W
        return Linear(self.hidden_dim, self.hidden_dim, use_bias=False)

    # -- negative sampling (host) -------------------------------------------

    def negative_rng(self, epoch: int, step: int) -> np.random.Generator:
        """One generator per (base_seed, epoch, step)."""
        return seed_rng(self.base_seed, (epoch << 32) | step)

    def _negatives_row(self, rng: np.random.Generator, sizes: np.ndarray,
                       tgt_sizes: np.ndarray, tgt_cap: int) -> np.ndarray:
        """[E, K] negative target indices for one scalar graph, each edge
        slot drawn from its own component's valid target-node range."""
        capacity = int(sizes.sum())  # padded edge sizes sum to capacity
        comp = np.repeat(np.arange(len(sizes)), sizes)  # [E] component ids
        node_starts = np.concatenate([[0], np.cumsum(tgt_sizes)[:-1]])
        lo = node_starts[comp]                            # [E]
        span = np.maximum(tgt_sizes[comp], 1)             # [E]
        draws = rng.random((capacity, self.num_negatives))
        idx = lo[:, None] + (draws * span[:, None]).astype(np.int64)
        # a component with 0 target nodes (possible only at weight 0) has
        # no range to draw from: clamp in-bounds, the loss masks it out
        return np.minimum(idx, max(tgt_cap - 1, 0)).astype(np.int32)

    def labels(self, graph: GraphTensor, *, epoch: int = 0,
               step: int = 0) -> np.ndarray:
        es = graph.edge_sets[self.edge_set_name]
        tgt = graph.node_sets[es.adjacency.target_name]
        sizes = np.asarray(es.sizes)
        tgt_sizes = np.asarray(tgt.sizes)
        rng = self.negative_rng(epoch, step)
        if sizes.ndim == 1:  # scalar batch
            return self._negatives_row(rng, sizes, tgt_sizes, tgt.capacity)
        # stacked super-batch: rows drawn in order from the ONE generator
        return np.stack([self._negatives_row(rng, sizes[r], tgt_sizes[r],
                                             tgt.capacity)
                         for r in range(sizes.shape[0])])

    # -- scoring (device) ----------------------------------------------------

    def _pairs(self, head: Linear, graph: GraphTensor):
        """(projected source state per edge [E, D], target states, edge
        set)."""
        es = graph.edge_sets[self.edge_set_name]
        src_states = graph.node_sets[es.adjacency.source_name][HIDDEN_STATE]
        tgt_states = graph.node_sets[es.adjacency.target_name][HIDDEN_STATE]
        return head(src_states)[es.adjacency.source], tgt_states, es

    def _scores(self, head: Linear, graph: GraphTensor,
                negatives: torch.Tensor):
        src, tgt_states, es = self._pairs(head, graph)
        pos = (src * tgt_states[es.adjacency.target]).sum(-1)      # [E]
        # the [E, K] int32 negatives gather as int64, torch's index type
        neg = (src[:, None, :]
               * tgt_states[negatives.to(torch.int64)]).sum(-1)    # [E, K]
        # per-edge weight: the owning component's context weight (0 for
        # every edge of the padding component)
        weights = _context_weights(graph)
        w = weights[torch.clamp(es.component_ids(),
                                max=weights.shape[0] - 1)]
        return pos, neg, w

    def predict(self, head: Linear, graph: GraphTensor) -> torch.Tensor:
        """Legacy surface: positive-pair logits only."""
        src, tgt_states, es = self._pairs(head, graph)
        return (src * tgt_states[es.adjacency.target]).sum(-1)

    def _nll(self, pos, neg, w):
        # BCE: positives at label 1, negatives at label 0; the K negative
        # terms per edge average to one vote, so pos/neg are balanced
        return ((F.softplus(-pos) * w).sum()
                + (F.softplus(neg) * w[:, None]).sum() / self.num_negatives)

    def loss_from_graph(self, head: Linear, graph: GraphTensor,
                        labels: torch.Tensor) -> torch.Tensor:
        pos, neg, w = self._scores(head, graph, labels)
        return self._nll(pos, neg, w) / torch.clamp(2.0 * w.sum(), min=1.0)

    def metrics(self, head: Linear, graph: GraphTensor,
                labels: torch.Tensor) -> dict:
        pos, neg, w = self._scores(head, graph, labels)
        den = 2.0 * w.sum()
        correct = (((pos > 0) * w).sum()
                   + ((neg <= 0) * w[:, None]).sum() / self.num_negatives)
        return {"accuracy": (correct, den),
                "loss": (self._nll(pos, neg, w), den)}

    def metric_names(self) -> tuple:
        return ("accuracy", "loss")


class DeepGraphInfomax(Task):
    """Self-supervised DGI objective (paper §5 Task list): discriminate
    node states of the real graph vs a feature-shuffled corruption against
    a per-component summary vector (Velickovic et al. 2019)."""

    def __init__(self, node_set_name: str, hidden_dim: int):
        self.node_set_name = node_set_name
        self.hidden_dim = hidden_dim

    def head(self) -> Linear:
        # bilinear discriminator weight
        return Linear(self.hidden_dim, self.hidden_dim, use_bias=False)

    def logits_for(self, head: Linear, graph: GraphTensor,
                   states: torch.Tensor) -> torch.Tensor:
        summary = torch.tanh(ops.pool_nodes_to_context(
            graph, self.node_set_name, "mean", feature_value=states))
        per_node_summary = ops.broadcast_context_to_nodes(
            graph, self.node_set_name, feature_value=summary)
        return (head(states) * per_node_summary).sum(-1)

    def predict(self, head: Linear, graph: GraphTensor) -> torch.Tensor:
        ns = graph.node_sets[self.node_set_name]
        return self.logits_for(head, graph, ns[HIDDEN_STATE])

    def corrupt(self, graph: GraphTensor,
                generator: torch.Generator) -> GraphTensor:
        """Corruption: permute node features within the set.  The
        permutation is drawn on the CPU from `generator` (so it does not
        depend on the device) and applied on the features' device."""
        ns = graph.node_sets[self.node_set_name]
        perm = torch.randperm(ns.capacity, generator=generator)
        feats = {k: v[perm.to(v.device)] for k, v in ns.features.items()}
        return graph.replace_features(node_sets={self.node_set_name: feats})

    def loss(self, logits, labels, weights):
        # labels: 1 real / 0 corrupted per node; weights: node validity
        nll = F.softplus(logits) - logits * labels
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
