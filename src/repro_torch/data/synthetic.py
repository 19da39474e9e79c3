"""Synthetic data — `synthetic_mag`, `synthetic_graph_classification` and
`token_batches`, copied from `repro.data.synthetic` and held to the
originals, array for array, by tests/test_torch_host_parity.py.

`synthetic_mag` builds an OGBN-MAG-shaped heterogeneous citation graph
(paper §8) with a *learnable* planted signal: each paper gets a latent
topic; venue labels are a function of the topic mixture of the paper and
its citations, so a GNN that aggregates neighborhood features beats any
node-local classifier.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, NodeSet)
from repro_torch.core.schema import mag_schema
from repro_torch.data.sampling import GraphStore


def synthetic_mag(*, n_papers: int = 2000, n_authors: int = 1200,
                  n_institutions: int = 60, n_fields: int = 120,
                  n_classes: int = 16, feat_dim: int = 64,
                  avg_cites: int = 6, avg_writes: int = 3,
                  avg_topics: int = 4, seed: int = 0,
                  rng: np.random.Generator | None = None
                  ) -> tuple[GraphStore, np.ndarray]:
    """Returns (GraphStore, paper labels).

    All randomness flows through one `np.random.Generator` — pass `rng`
    to splice this generator into a caller-owned seed tree
    (`np.random.SeedSequence.spawn`); by default it derives from `seed`.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    schema = mag_schema()

    # latent topics drive both features and labels
    topic_centers = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    paper_topic = rng.integers(0, n_classes, n_papers)
    feat = (topic_centers[paper_topic]
            + 0.8 * rng.normal(size=(n_papers, feat_dim))).astype(np.float32)

    def edges_pref(n_src, n_tgt, avg, bias=None):
        counts = rng.poisson(avg, n_src) + 1
        src = np.repeat(np.arange(n_src), counts)
        if bias is None:
            tgt = rng.integers(0, n_tgt, len(src))
        else:
            tgt = bias[src, rng.integers(0, bias.shape[1], len(src))]
        return src.astype(np.int64), tgt.astype(np.int64)

    # citations are topic-assortative (papers cite same-topic papers)
    by_topic = [np.where(paper_topic == t)[0] for t in range(n_classes)]
    cite_src, cite_tgt = [], []
    for p in range(n_papers):
        k = rng.poisson(avg_cites) + 1
        same = by_topic[paper_topic[p]]
        pick_same = rng.choice(same, min(k, len(same)))
        pick_rand = rng.integers(0, n_papers, max(0, k - len(pick_same)))
        for q in np.concatenate([pick_same, pick_rand])[:k]:
            if q != p:
                cite_src.append(p)
                cite_tgt.append(int(q))
    cites = (np.asarray(cite_src, np.int64), np.asarray(cite_tgt, np.int64))

    w_src, w_tgt = edges_pref(n_authors, n_papers, avg_writes)
    writes = (w_src, w_tgt)
    written = (w_tgt.copy(), w_src.copy())  # paper -> author (reverse)
    aff = edges_pref(n_authors, n_institutions, 1)
    topics = edges_pref(n_papers, n_fields, avg_topics)

    # label = majority topic among self + cited papers (GNN-friendly signal)
    labels = paper_topic.copy()
    order = np.argsort(cites[0])
    src_sorted, tgt_sorted = cites[0][order], cites[1][order]
    starts = np.searchsorted(src_sorted, np.arange(n_papers))
    ends = np.searchsorted(src_sorted, np.arange(n_papers) + 1)
    for p in range(n_papers):
        nbr = tgt_sorted[starts[p]:ends[p]]
        votes = np.bincount(
            np.concatenate([[paper_topic[p]], paper_topic[nbr]]),
            minlength=n_classes)
        labels[p] = votes.argmax()

    years = rng.integers(2010, 2020, n_papers).astype(np.int32)
    store = GraphStore(
        schema,
        edges={"cites": cites, "writes": writes, "written": written,
               "affiliated_with": aff, "has_topic": topics},
        node_features={
            "paper": {"feat": feat, "labels": labels.astype(np.int32),
                      "year": years},
            "author": {"id": np.arange(n_authors, dtype=np.int32)},
            "institution": {"id": np.arange(n_institutions, dtype=np.int32)},
            "field_of_study": {"id": np.arange(n_fields, dtype=np.int32)},
        },
        num_nodes={"paper": n_papers, "author": n_authors,
                   "institution": n_institutions,
                   "field_of_study": n_fields})
    return store, labels


def synthetic_graph_classification(*, num_graphs: int = 400,
                                   num_classes: int = 2,
                                   min_nodes: int = 8, max_nodes: int = 16,
                                   feat_dim: int = 16, noise: float = 1.5,
                                   seed: int = 0,
                                   rng: np.random.Generator | None = None
                                   ) -> list[GraphTensor]:
    """MUTAG-shaped graph-level classification set: each graph is one
    single-component GraphTensor ("atoms" nodes on a ring, "bonds" edges
    both directions) carrying its class as the context feature "label".

    The class is planted twice — a per-class feature center (noisy enough
    that single-node readout is weak) and class-proportional chord density
    on the ring — so context-pooled readout over message-passed states
    beats any node-local or structure-blind classifier.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    graphs = []
    for _ in range(num_graphs):
        y = int(rng.integers(num_classes))
        n = int(rng.integers(min_nodes, max_nodes + 1))
        feat = (centers[y]
                + noise * rng.normal(size=(n, feat_dim))).astype(np.float32)
        ring = np.arange(n)
        nxt = np.roll(ring, -1)
        src, tgt = [ring, nxt], [nxt, ring]
        n_chords = y * max(n // 4, 1)  # class-proportional density
        if n_chords:
            a = rng.integers(0, n, n_chords)
            b = (a + 2 + rng.integers(0, max(n - 3, 1), n_chords)) % n
            src += [a, b]
            tgt += [b, a]
        src = np.concatenate(src).astype(np.int32)
        tgt = np.concatenate(tgt).astype(np.int32)
        graphs.append(GraphTensor(
            Context(np.asarray([1], np.int32),
                    {"label": np.asarray([y], np.int32)}),
            {"atoms": NodeSet(np.asarray([n], np.int32), {"feat": feat},
                              n)},
            {"bonds": EdgeSet(np.asarray([len(src)], np.int32),
                              Adjacency(src, tgt, "atoms", "atoms"), {},
                              len(src))}))
    return graphs


def token_batches(*, batch: int, seq: int, vocab: int, steps: int,
                  seed: int = 0, rng: np.random.Generator | None = None):
    """Synthetic LM batches: orderly Markov-ish streams (learnable).
    `rng` overrides the `seed`-derived generator (same contract as
    `synthetic_mag`)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, (vocab, 4))
    for _ in range(steps):
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        choices = rng.integers(0, 4, (batch, seq))
        noise = rng.random((batch, seq)) < 0.1
        rand = rng.integers(0, vocab, (batch, seq))
        for t in range(seq):
            nxt = trans[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
