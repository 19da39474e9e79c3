"""The PyTorch port's serving slice against the JAX reference, on the CPU.

The same inputs (numpy, from seeds) and the same parameters (the JAX
model's, carried across with `load_jax_params`) go through both packages:
the exchange ops, the fused and generic SimpleConv paths, the §8 model,
and `GNNServer.serve_sync` end to end.  On the CPU the port runs its
plain PyTorch versions; the JAX side runs its reference path.  fp32
throughout; tolerances are stated per test (sums are taken in different
orders, so equality is not expected).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_graph

import repro.core.ops as jops
from repro.core import convolutions as jconv
from repro.core.graph_tensor import HIDDEN_STATE
from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
from repro.core.schema import mag_schema as j_mag_schema
from repro.data.grouping import merge_and_pad as j_merge_and_pad
from repro.data.sampling import SamplingSpecBuilder as JSpecBuilder
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.nn.layers import Embedding as JEmbedding
from repro.nn.layers import Linear as JLinear
from repro.nn.module import Module as JModule
from repro.nn.module import split_params
from repro.orchestration.tasks import (
    RootNodeMulticlassClassification as JRootTask)
from repro.serve.gnn import GNNServer as JGNNServer

import repro_torch.core.ops as tops
from repro_torch.core import convolutions as tconv
from repro_torch.core.graph_tensor import GraphTensor, to_device
from repro_torch.core.models import vanilla_mpnn as t_vanilla_mpnn
from repro_torch.core.schema import mag_schema as t_mag_schema
from repro_torch.data.grouping import merge_and_pad as t_merge_and_pad
from repro_torch.data.sampling import SamplingSpecBuilder as TSpecBuilder
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.nn.layers import Embedding as TEmbedding
from repro_torch.nn.layers import Linear as TLinear
from repro_torch.nn.layers import init_params, load_jax_params
from repro_torch.orchestration.tasks import (
    RootNodeMulticlassClassification as TRootTask)
from repro_torch.serve.gnn import GNNServer as TGNNServer

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB = 64  # id-embedding rows of the small model twins


def j_graph(g):
    return jax.tree_util.tree_map(jnp.asarray, g)


def to_np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x)


@pytest.fixture(scope="module")
def padded():
    """The recommender example with padding nodes and edges, in both
    forms; "h" features are [n, 8] fp32."""
    g = make_graph(pad_users=3, pad_items=2, pad_edges=4)
    return j_graph(g), to_device(_as_port(g), "cpu")


def _as_port(g) -> GraphTensor:
    """conftest's reference GraphTensor re-built from the port's classes
    (same numpy leaves)."""
    from repro_torch.core import graph_tensor as tg
    return tg.GraphTensor(
        tg.Context(g.context.sizes, dict(g.context.features)),
        {n: tg.NodeSet(ns.sizes, dict(ns.features), ns.capacity)
         for n, ns in g.node_sets.items()},
        {n: tg.EdgeSet(es.sizes, tg.Adjacency(
            es.adjacency.source, es.adjacency.target,
            es.adjacency.source_name, es.adjacency.target_name),
            dict(es.features), es.capacity)
         for n, es in g.edge_sets.items()})


# ---------------------------------------------------------------------------
# exchange ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce_type", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("tag", ["source", "target"])
def test_pool_edges_to_node_matches_reference(padded, reduce_type, tag):
    jg, tg = padded
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(jg.edge_sets["purchased"].capacity, 5)) \
        .astype(np.float32)
    want = jops.pool_edges_to_node(jg, "purchased", tag, reduce_type,
                                   feature_value=jnp.asarray(vals))
    got = tops.pool_edges_to_node(tg, "purchased", tag, reduce_type,
                                  feature_value=torch.from_numpy(vals))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_broadcasts_softmax_degree_and_context_match_reference(padded):
    jg, tg = padded
    for tag in ("source", "target"):
        np.testing.assert_array_equal(
            to_np(tops.broadcast_node_to_edges(tg, "purchased", tag,
                                               feature_name="h")),
            np.asarray(jops.broadcast_node_to_edges(jg, "purchased", tag,
                                                    feature_name="h")))
        d_t = tops.node_degree(tg, "purchased", tag)
        assert d_t.dtype == torch.int32  # exact integer count
        np.testing.assert_array_equal(
            to_np(d_t), np.asarray(jops.node_degree(jg, "purchased", tag)))
    scores = np.random.default_rng(4).normal(
        size=(jg.edge_sets["purchased"].capacity, 2)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tops.segment_softmax(tg, "purchased", "target",
                                   feature_value=torch.from_numpy(scores))),
        np.asarray(jops.segment_softmax(jg, "purchased", "target",
                                        feature_value=jnp.asarray(scores))),
        **TOL)
    for reduce_type in ("sum", "mean", "max"):
        np.testing.assert_allclose(
            to_np(tops.pool_nodes_to_context(tg, "users", reduce_type,
                                             feature_name="h")),
            np.asarray(jops.pool_nodes_to_context(jg, "users", reduce_type,
                                                  feature_name="h")),
            **TOL)
    np.testing.assert_array_equal(
        to_np(tops.broadcast_context_to_nodes(tg, "users",
                                              feature_name="scores")),
        np.asarray(jops.broadcast_context_to_nodes(jg, "users",
                                                   feature_name="scores")))


# ---------------------------------------------------------------------------
# SimpleConv: fused shape and generic path, with carried-over weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce_type,activation", [
    ("sum", "relu"), ("sum", "gelu"), ("mean", "relu"), ("max", "gelu")])
def test_simple_conv_matches_reference(padded, reduce_type, activation):
    jg, tg = padded
    jg = jg.replace_features(node_sets={
        n: {HIDDEN_STATE: ns["h"]} for n, ns in jg.node_sets.items()})
    tg = tg.replace_features(node_sets={
        n: {HIDDEN_STATE: ns["h"]} for n, ns in tg.node_sets.items()})
    jc = jconv.SimpleConv(6, 16, reduce_type=reduce_type,
                          activation=activation)
    params = split_params(jc.init(jax.random.PRNGKey(7)))[0]
    tc = tconv.SimpleConv(6, 16, reduce_type=reduce_type,
                          activation=activation)
    load_jax_params(tc, jax.tree_util.tree_map(np.asarray, params))
    want = jc(params, jg, "purchased")
    got = tc(tg, "purchased")
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # on the CPU every conv takes the plain versions, and says why
    reason = tc.fused_decision(tg, "purchased").reason
    assert not tc.fused_decision(tg, "purchased").use_kernel
    assert ("cpu tensor" in reason if reduce_type == "sum"
            else "pooling not fused" in reason)


def test_load_jax_params_rejects_mismatched_trees():
    lin = TLinear(3, 2)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(lin, {"w": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(lin, {"w": np.zeros((2, 3), np.float32),
                              "b": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# the served §8 model, end to end through both GNNServers
# ---------------------------------------------------------------------------

DIM, FEAT, N_CLASSES, ROUNDS = 16, 16, 4, 2


def _spec(builder_cls, schema):
    """The §8 sampling spec (examples/ogbn_mag_train.py) with smaller
    fanouts."""
    b = builder_cls(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(3, "cites")
    authors = cited.join([seed_op]).sample(2, "written")
    author_papers = authors.sample(2, "writes")
    authors.sample(2, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(2, "has_topic")
    return seed_op.build()


class JInitStates(JModule):
    """Initial states as the §8 example builds them (reference side)."""

    def __init__(self):
        self.paper = JLinear(FEAT, DIM)
        self.tables = {n: JEmbedding(VOCAB, DIM)
                       for n in ("author", "institution", "field_of_study")}

    def init(self, key):
        ks = jax.random.split(key, 4)
        p = {"paper": self.paper.init(ks[0])}
        for i, (n, t) in enumerate(sorted(self.tables.items())):
            p[n] = t.init(ks[i + 1])
        return p

    def __call__(self, params, graph):
        ns = {"paper": {HIDDEN_STATE: jax.nn.relu(self.paper(
            params["paper"], graph.node_sets["paper"]["feat"]))}}
        for n, t in self.tables.items():
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {HIDDEN_STATE: t(params[n], ids, dtype=jnp.float32)}
        return graph.replace_features(node_sets=ns)


class TInitStates(torch.nn.Module):
    """The port's twin of JInitStates (same parameter names)."""

    def __init__(self):
        super().__init__()
        self.paper = TLinear(FEAT, DIM)
        self.author = TEmbedding(VOCAB, DIM)
        self.institution = TEmbedding(VOCAB, DIM)
        self.field_of_study = TEmbedding(VOCAB, DIM)

    def forward(self, graph):
        ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
            graph.node_sets["paper"]["feat"]))}}
        for n in ("author", "institution", "field_of_study"):
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {HIDDEN_STATE: getattr(self, n)(ids,
                                                    dtype=torch.float32)}
        return graph.replace_features(node_sets=ns)


class TServed(torch.nn.Module):
    def __init__(self, reduce_type="sum"):
        super().__init__()
        schema = t_mag_schema()
        edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
        self.task = TRootTask("paper", N_CLASSES, DIM)
        self.init = TInitStates()
        self.gnn = t_vanilla_mpnn(edges, {n: DIM for n in schema.node_sets},
                                  message_dim=DIM, hidden_dim=DIM,
                                  num_rounds=ROUNDS, reduce_type=reduce_type)
        self.head = self.task.head()

    def forward(self, graph):
        return self.task.predict(self.head, self.gnn(self.init(graph)))


@pytest.fixture(scope="module")
def jax_model():
    schema = j_mag_schema()
    edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
    init = JInitStates()
    gnn = j_vanilla_mpnn(edges, {n: DIM for n in schema.node_sets},
                         message_dim=DIM, hidden_dim=DIM, num_rounds=ROUNDS)
    task = JRootTask("paper", N_CLASSES, DIM)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"init": split_params(init.init(k1))[0],
              "gnn": split_params(gnn.init(k2))[0],
              "head": split_params(task.head().init(k3))[0]}

    def apply_fn(p, graph):
        return task.predict(p["head"], gnn(p["gnn"], init(p["init"], graph)))

    return apply_fn, params


STORE_KW = dict(n_papers=60, n_authors=30, n_institutions=6, n_fields=10,
                n_classes=N_CLASSES, feat_dim=FEAT)


def test_served_logits_match_jax_server(jax_model):
    apply_fn, params = jax_model
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    model = TServed()
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    roots = [1, 2, 3, 17, 40]
    jserver = JGNNServer(jstore, _spec(JSpecBuilder, jstore.schema),
                         apply_fn, params, feature_dim=DIM, max_batch=2,
                         batch_window_ms=1.0)
    try:
        want = jserver.serve_sync(roots, timeout=120)
    finally:
        jserver.close()
    tserver = TGNNServer(tstore, _spec(TSpecBuilder, tstore.schema), model,
                         device="cpu", max_batch=2, batch_window_ms=1.0)
    try:
        got = tserver.serve_sync(roots, timeout=120)
        stats = tserver.stats
    finally:
        tserver.close()
    assert got.shape == (len(roots), N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert stats.steady_state_recompiles == 0 and stats.failed == 0


def test_forward_and_mean_path_match_jax_on_one_batch(jax_model):
    """One merged batch of every rung size straight through both models:
    the fused (sum) model, and the generic mean-pooling model."""
    apply_fn, params = jax_model
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    from repro.serve.gnn import build_ladder, spec_size_bounds
    sizes = build_ladder(spec_size_bounds(_spec(JSpecBuilder,
                                                jstore.schema),
                                          jstore.schema),
                         4, DIM).sizes[4]
    from repro.data.sampling import InMemorySampler
    jgraphs = InMemorySampler(jstore, _spec(JSpecBuilder, jstore.schema)) \
        .sample([5, 6, 7])
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    tspec = _spec(TSpecBuilder, tstore.schema)
    tgraphs = [sample_subgraph(tstore, tspec, r, seed_rng(0, r))
               for r in (5, 6, 7)]
    jbatch = j_merge_and_pad(jgraphs, sizes)
    tbatch = to_device(t_merge_and_pad(tgraphs, sizes), "cpu")
    model = TServed()
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        got = model(tbatch)
    np.testing.assert_allclose(to_np(got), np.asarray(
        apply_fn(params, j_graph(jbatch))), rtol=1e-4, atol=1e-5)

    # generic path: reduce_type="mean" (segment_pool on the card)
    schema = j_mag_schema()
    edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
    jgnn = j_vanilla_mpnn(edges, {n: DIM for n in schema.node_sets},
                          message_dim=DIM, hidden_dim=DIM,
                          num_rounds=ROUNDS, reduce_type="mean")
    jinit, jtask = JInitStates(), JRootTask("paper", N_CLASSES, DIM)
    want = jtask.predict(params["head"], jgnn(params["gnn"], jinit(
        params["init"], j_graph(jbatch))))
    mean_model = TServed("mean")
    load_jax_params(mean_model, jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        got = mean_model(tbatch)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with torch.inference_mode():
        decisions = mean_model.gnn.describe_dispatch(mean_model.init(tbatch))
    assert len(decisions) == ROUNDS
    assert all("pooling not fused" in d.reason for rnd in decisions
               for per_set in rnd.values() for d in per_set.values())


def test_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """No device given and no CUDA device: the server raises instead of
    quietly serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, _ = t_synthetic_mag(**STORE_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGNNServer(store, _spec(TSpecBuilder, store.schema), TServed())


def test_root_task_loss_and_labels_match_reference():
    """The task's host-side root labels and its weighted NLL, on the same
    logits, labels and padding weights."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, N_CLASSES)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 5).astype(np.int32)
    weights = np.asarray([1, 1, 0, 1, 0], np.float32)
    jtask, ttask = JRootTask("paper", N_CLASSES, DIM), \
        TRootTask("paper", N_CLASSES, DIM)
    want = jtask.loss(jnp.asarray(logits), jnp.asarray(labels),
                      jnp.asarray(weights))
    got = ttask.loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     torch.from_numpy(weights))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    sizes, per_node = np.asarray([3, 0, 2, 4]), np.arange(10) * 10
    np.testing.assert_array_equal(ttask.root_labels(sizes, per_node),
                                  jtask.root_labels(sizes, per_node))


def test_port_model_draws_parameters_from_a_seed():
    a, b = init_params(TServed(), 3), init_params(TServed(), 3)
    c = init_params(TServed(), 4)
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
