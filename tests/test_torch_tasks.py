"""The port's Graph Networks updates, tasks and example twins against the
JAX package, on the CPU.

The same numpy inputs go through both packages, with the JAX parameters
loaded by `load_jax_params`, JAX kernels off (the reference), tolerance
rtol 1e-4 / atol 1e-5 (fp32 sums in another order):

* `EdgeSetUpdate`, `ContextUpdate` (mean, sum, max) and the full Graph
  Networks round of tests/test_gnn_models.py: forward, and the gradients
  of a fixed random projection of its outputs;
* each of the four new tasks' `predict`, `loss_from_graph` and `metrics`
  (and the head's gradient) on one merged MAG batch with random states;
  `DeepGraphInfomax` on the same corrupted graph in both packages (the
  two packages' permutations cannot match);
* `LinkPrediction.labels`, array-equal, over the cases of
  tests/test_task_property.py and on provider batches;
* the three twins — `quickstart`, `link_prediction`,
  `graph_classification` — against the JAX examples' pieces: the
  quickstart's numbers, and 3 training steps of the others (per-step
  loss, final parameters, eval metrics) from the JAX initial parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_graph
from test_task_property import _sweep_shape

from repro.core import ops as j_ops
from repro.core.convolutions import SimpleConv as JSimpleConv
from repro.core.graph_tensor import HIDDEN_STATE as J_HIDDEN
from repro.core.graph_update import (ContextUpdate as JContextUpdate,
                                     EdgeSetUpdate as JEdgeSetUpdate,
                                     GraphUpdate as JGraphUpdate,
                                     NextStateFromConcat as JNextState,
                                     NodeSetUpdate as JNodeSetUpdate)
from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
from repro.core.schema import mag_schema as j_mag_schema
from repro.data import sampling as j_sampling
from repro.data.batching import find_size_constraints as j_find_sizes
from repro.data.grouping import merge_and_pad as j_merge_and_pad
from repro.data.synthetic import (synthetic_graph_classification as j_gc_set,
                                  synthetic_mag as j_synthetic_mag)
from repro.kernels import dispatch as j_dispatch
from repro.nn.layers import Embedding as JEmbedding, Linear as JLinear
from repro.nn.module import Module as JModule, split_params
from repro.orchestration import evaluation as j_evaluation
from repro.orchestration import tasks as j_tasks
from repro.orchestration.providers import (BatcherProvider as JBatcher,
                                           StoreProvider as JStore)
from repro.orchestration.trainer import Trainer as JTrainer
from repro.train import optimizer as j_opt
from repro.train.train_loop import (make_graph_eval_step as j_eval_step,
                                    make_graph_train_step as j_train_step)

from repro_torch.core import graph_tensor as t_gt
from repro_torch.core.convolutions import SimpleConv
from repro_torch.core.graph_tensor import HIDDEN_STATE, to_device
from repro_torch.core.graph_update import (ContextUpdate, EdgeSetUpdate,
                                           GraphUpdate, NextStateFromConcat,
                                           NodeSetUpdate)
from repro_torch.data import sampling as t_sampling
from repro_torch.data.grouping import merge_and_pad as t_merge_and_pad
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.nn.layers import load_jax_params
from repro_torch.orchestration import graph_classification as t_gc
from repro_torch.orchestration import link_prediction as t_lp
from repro_torch.orchestration import quickstart as t_quickstart
from repro_torch.orchestration import runner as t_runner
from repro_torch.orchestration import tasks as t_tasks

TOL = dict(rtol=1e-4, atol=1e-5)
DIM = 16
STORE_KW = dict(n_papers=96, n_authors=48, n_institutions=6, n_fields=12,
                n_classes=4, feat_dim=8)
BATCH, STEPS = 8, 3


def port_graph(g) -> t_gt.GraphTensor:
    """The port's GraphTensor over the same numpy (or jax) leaves."""
    def arr(x):
        return np.asarray(x)

    return t_gt.GraphTensor(
        t_gt.Context(arr(g.context.sizes),
                     {k: arr(v) for k, v in g.context.features.items()}),
        {n: t_gt.NodeSet(arr(ns.sizes),
                         {k: arr(v) for k, v in ns.features.items()},
                         ns.capacity)
         for n, ns in g.node_sets.items()},
        {n: t_gt.EdgeSet(arr(es.sizes), t_gt.Adjacency(
            arr(es.adjacency.source), arr(es.adjacency.target),
            es.adjacency.source_name, es.adjacency.target_name),
            {k: arr(v) for k, v in es.features.items()}, es.capacity)
         for n, es in g.edge_sets.items()})


def flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree_, (list, tuple)):
        return flat(dict(enumerate(tree_)), prefix)
    return {prefix: np.asarray(tree_)}


def num(x) -> float:
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def jax_params(module, seed=0):
    return split_params(module.init(jax.random.PRNGKey(seed)))[0]


def numpy_tree(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


# ---------------------------------------------------------------------------
# Graph Networks updates
# ---------------------------------------------------------------------------

def recommender_graphs():
    """(JAX graph, port graph) of the recommender example with padding,
    8-wide states in both node sets."""
    g = make_graph(pad_users=2, pad_items=1, pad_edges=3, seed=5)
    states = {n: {J_HIDDEN: g.node_sets[n]["h"]} for n in ("users",
                                                           "items")}
    g = g.replace_features(node_sets=states)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    return jg, to_device(port_graph(g), "cpu")


def gn_round(j_or_t, reduce_type):
    """The full Graph Networks round of tests/test_gnn_models.py:152."""
    if j_or_t == "jax":
        return JGraphUpdate(
            edge_sets={"purchased": JEdgeSetUpdate(8 + 8, 12)},
            node_sets={"users": JNodeSetUpdate(
                {"purchased": JSimpleConv(8, 12 + 8, receiver_tag="target",
                                          sender_node_feature=None,
                                          sender_edge_feature="hidden_state")},
                JNextState(8 + 8, 16))},
            context=JContextUpdate(["users"], 16, 8,
                                   reduce_type=reduce_type))
    return GraphUpdate(
        edge_sets={"purchased": EdgeSetUpdate(8 + 8, 12)},
        node_sets={"users": NodeSetUpdate(
            {"purchased": SimpleConv(8, 12 + 8, receiver_tag="target",
                                     sender_node_feature=None,
                                     sender_edge_feature="hidden_state")},
            NextStateFromConcat(8 + 8, 16))},
        context=ContextUpdate(["users"], 16, 8, reduce_type=reduce_type))


def outputs(g, hidden):
    return (g.edge_sets["purchased"][hidden], g.node_sets["users"][hidden],
            g.context[hidden])


@pytest.mark.parametrize("reduce_type", ["mean", "sum", "max"])
def test_full_graph_networks_round_matches_jax(reduce_type):
    """Edge sets, then node sets, then the context, each reading the graph
    the stage before returned: forward and gradients."""
    jg, tg = recommender_graphs()
    j_mod, t_mod = gn_round("jax", reduce_type), gn_round("torch",
                                                          reduce_type)
    params = jax_params(j_mod, 3)
    load_jax_params(t_mod, numpy_tree(params))
    rng = np.random.default_rng(7)
    want = outputs(j_mod(params, jg), J_HIDDEN)
    got = outputs(t_mod(tg), HIDDEN_STATE)
    assert got[0].shape == (10, 12) and got[1].shape == (6, 16)
    assert got[2].shape == (1, 8)
    cots = [rng.standard_normal(w.shape).astype(np.float32) for w in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)

    def j_loss(p):
        return sum((o * c).sum() for o, c in zip(
            outputs(j_mod(p, jg), J_HIDDEN), cots))

    j_grads = flat(numpy_tree(jax.grad(j_loss)(params)))
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(
        outputs(t_mod(tg), HIDDEN_STATE), cots))
    names = [n for n, _ in t_mod.named_parameters()]
    grads = torch.autograd.grad(loss, list(t_mod.parameters()))
    assert sorted(names) == sorted(j_grads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), j_grads[name], err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("sender,receiver", [(True, True), (True, False),
                                             (False, True)])
def test_edge_set_update_matches_jax(sender, receiver):
    """Without an old edge state the first input takes its place."""
    jg, tg = recommender_graphs()
    n_in = 8 * (sender + receiver)
    j_mod = JEdgeSetUpdate(n_in, 12, use_sender_state=sender,
                           use_receiver_state=receiver)
    t_mod = EdgeSetUpdate(n_in, 12, use_sender_state=sender,
                          use_receiver_state=receiver)
    params = jax_params(j_mod)
    load_jax_params(t_mod, numpy_tree(params))
    np.testing.assert_allclose(t_mod(tg, "is-friend").detach().numpy(),
                               np.asarray(j_mod(params, jg, "is-friend")),
                               **TOL)


def test_context_update_over_two_node_sets_with_an_old_state():
    jg, tg = recommender_graphs()
    ctx = np.random.default_rng(2).standard_normal((1, 4)).astype(
        np.float32)
    jg = jg.replace_features(context={J_HIDDEN: jnp.asarray(ctx)})
    tg = tg.replace_features(context={HIDDEN_STATE: torch.from_numpy(ctx)})
    j_mod = JContextUpdate(["items", "users"], 4 + 8 + 8, 6,
                           reduce_type="sum", activation="tanh")
    t_mod = ContextUpdate(["items", "users"], 4 + 8 + 8, 6,
                          reduce_type="sum", activation="tanh")
    params = jax_params(j_mod, 1)
    load_jax_params(t_mod, numpy_tree(params))
    np.testing.assert_allclose(t_mod(tg).detach().numpy(),
                               np.asarray(j_mod(params, jg)), **TOL)


def test_from_pieces_defaults_to_one_component():
    ns = t_gt.NodeSet(np.asarray([3], np.int32), {}, 3)
    g = t_gt.GraphTensor.from_pieces(node_sets={"n": ns})
    assert g.num_components == 1 and g.context.sizes.dtype == np.int32
    on_device = t_gt.GraphTensor.from_pieces(node_sets={"n": t_gt.NodeSet(
        torch.tensor([3]), {}, 3)})
    assert on_device.context.sizes.dtype == torch.int32
    assert list(t_gt.GraphTensor.from_pieces().node_sets) == []


# ---------------------------------------------------------------------------
# tasks on one merged MAG batch
# ---------------------------------------------------------------------------

def lp_spec(module, schema):
    """The link-prediction example's spec (examples/link_prediction_train
    .py), at fanout 4/2/2."""
    b = module.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(4, "cites")
    authors = cited.join([seed_op]).sample(2, "written")
    authors.sample(2, "writes")
    return seed_op.build()


@pytest.fixture(scope="module")
def mag_batch():
    """(JAX graph, port graph, host graph) of one merged, target-sorted,
    padded batch with the same random 16-wide states in every node set,
    and per-component "label" / "flag" context features."""
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    jspec = lp_spec(j_sampling, jstore.schema)
    tspec = lp_spec(t_sampling, tstore.schema)
    jg = [j_sampling.sample_subgraph(jstore, jspec, r,
                                     j_sampling.seed_rng(0, r))
          for r in range(BATCH)]
    tg = [t_sampling.sample_subgraph(tstore, tspec, r,
                                     t_sampling.seed_rng(0, r))
          for r in range(BATCH)]
    sizes = j_find_sizes(jg, BATCH)
    jb = j_merge_and_pad(jg, sizes, sort_by_target=True)
    host = t_merge_and_pad(tg, sizes, sort_by_target=True)
    rng = np.random.default_rng(0)
    states = {n: rng.standard_normal((ns.capacity, DIM)).astype(np.float32)
              for n, ns in sorted(host.node_sets.items())}
    c = host.num_components
    ctx = {"label": rng.integers(0, 3, c).astype(np.int32),
           "flag": rng.integers(0, 2, c).astype(np.float32)}
    jb = jax.tree_util.tree_map(jnp.asarray, jb).replace_features(
        context={k: jnp.asarray(v) for k, v in ctx.items()},
        node_sets={n: {J_HIDDEN: jnp.asarray(x)} for n, x in states.items()})
    host = host.replace_features(context=ctx, node_sets={
        n: {**host.node_sets[n].features, HIDDEN_STATE: x}
        for n, x in states.items()})
    return jb, to_device(host, "cpu"), host


TASKS = {
    "graph_binary": (lambda m: m.GraphBinaryClassification(
        "paper", DIM, label_feature="flag")),
    "graph_multiclass": (lambda m: m.GraphMulticlassClassification(
        "paper", 3, DIM)),
    "graph_multiclass_sum": (lambda m: m.GraphMulticlassClassification(
        "author", 3, DIM, reduce_type="sum")),
    "link_prediction": (lambda m: m.LinkPrediction("writes", DIM,
                                                   num_negatives=3,
                                                   base_seed=5)),
}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_task_matches_jax(mag_batch, name):
    """predict, loss_from_graph, metrics and the head's loss gradient."""
    jb, tb, host = mag_batch
    j_task, t_task = TASKS[name](j_tasks), TASKS[name](t_tasks)
    j_head = j_task.head()
    params = jax_params(j_head, 4)
    head = t_task.head()
    load_jax_params(head, numpy_tree(params))
    labels = t_task.labels(host, epoch=2, step=7)
    np.testing.assert_array_equal(labels, j_task.labels(jb, epoch=2,
                                                        step=7))
    j_lab, t_lab = jnp.asarray(labels), torch.as_tensor(labels)
    np.testing.assert_allclose(head_predict := t_task.predict(
        head, tb).detach().numpy(), np.asarray(j_task.predict(params, jb)),
        **TOL)
    assert np.isfinite(head_predict).all()
    loss = t_task.loss_from_graph(head, tb, t_lab)
    np.testing.assert_allclose(
        loss.item(), float(j_task.loss_from_graph(params, jb, j_lab)), **TOL)
    got = t_task.metrics(head, tb, t_lab)
    want = j_task.metrics(params, jb, j_lab)
    assert sorted(got) == sorted(want) == list(t_task.metric_names())
    for k in want:
        np.testing.assert_allclose([num(x) for x in got[k]],
                                   [num(x) for x in want[k]], err_msg=k,
                                   **TOL)
    j_grads = flat(numpy_tree(jax.grad(
        lambda p: j_task.loss_from_graph(p, jb, j_lab))(params)))
    t_grads = torch.autograd.grad(loss, list(head.parameters()))
    for (n, _), g in zip(head.named_parameters(), t_grads):
        np.testing.assert_allclose(g.numpy(), j_grads[n], err_msg=n, **TOL)


def test_deep_graph_infomax_matches_jax_on_one_corruption(mag_batch):
    """logits_for / predict / loss on the real graph and on one corrupted
    graph fed to both packages; `corrupt` permutes within the set."""
    jb, tb, _ = mag_batch
    j_task = j_tasks.DeepGraphInfomax("paper", DIM)
    t_task = t_tasks.DeepGraphInfomax("paper", DIM)
    params = jax_params(j_task.head(), 6)
    head = t_task.head()
    load_jax_params(head, numpy_tree(params))
    cap = tb.node_sets["paper"].capacity
    perm = np.random.default_rng(1).permutation(cap)
    states = tb.node_sets["paper"][HIDDEN_STATE]
    j_states = jb.node_sets["paper"][J_HIDDEN]
    mask = tb.node_sets["paper"].mask().to(torch.float32)
    for t_states, js in ((states, j_states),
                         (states[torch.from_numpy(perm)], j_states[perm])):
        t_logits = t_task.logits_for(head, tb, t_states)
        j_logits = j_task.logits_for(params, jb, js)
        np.testing.assert_allclose(t_logits.detach().numpy(),
                                   np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_task.predict(head, tb).detach().numpy(),
                               np.asarray(j_task.predict(params, jb)),
                               **TOL)
    real = torch.ones(cap)
    np.testing.assert_allclose(
        t_task.loss(t_logits, real * 0, mask).item(),
        float(j_task.loss(j_logits, jnp.zeros(cap), jnp.asarray(
            mask.numpy()))), **TOL)
    corrupted = t_task.corrupt(tb, torch.Generator().manual_seed(3))
    got = corrupted.node_sets["paper"][HIDDEN_STATE]
    order = torch.argsort(got[:, 0])
    torch.testing.assert_close(got[order], states[torch.argsort(
        states[:, 0])])
    again = t_task.corrupt(tb, torch.Generator().manual_seed(3))
    assert torch.equal(again.node_sets["paper"][HIDDEN_STATE], got)


@pytest.mark.parametrize("case", range(40))
def test_link_prediction_negatives_are_identical(case):
    """The reference's sweep of tests/test_task_property.py: the port
    draws the same int32 [E, K] negatives, array for array."""
    edge_sizes, tgt_sizes, tgt_cap, base_seed, epoch, step, k = \
        _sweep_shape(np.random.default_rng(case))
    j_task = j_tasks.LinkPrediction("e", 4, num_negatives=k,
                                    base_seed=base_seed)
    t_task = t_tasks.LinkPrediction("e", 4, num_negatives=k,
                                    base_seed=base_seed)
    want = j_task._negatives_row(j_task.negative_rng(epoch, step),
                                 edge_sizes, tgt_sizes, tgt_cap)
    got = t_task._negatives_row(t_task.negative_rng(epoch, step),
                                edge_sizes, tgt_sizes, tgt_cap)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_replicas", [None, 2])
def test_link_prediction_labels_on_provider_batches(num_replicas):
    """labels() over a StoreProvider epoch, scalar and stacked batches."""
    kw = dict(batch_size=8, seed=0, base_seed=0, num_replicas=num_replicas)
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    jspec = lp_spec(j_sampling, jstore.schema)
    tspec = lp_spec(t_sampling, tstore.schema)
    roots = list(range(24))
    sizes = j_find_sizes([j_sampling.sample_subgraph(
        jstore, jspec, r, j_sampling.seed_rng(0, r)) for r in roots],
        8 // (num_replicas or 1))
    from repro_torch.orchestration.providers import StoreProvider
    j_task = j_tasks.LinkPrediction("writes", DIM, num_negatives=2)
    t_task = t_tasks.LinkPrediction("writes", DIM, num_negatives=2)
    want = [j_task.labels(g, epoch=1, step=s) for s, g in enumerate(
        JStore(jstore, jspec, roots, sizes=sizes, **kw).epoch(1))]
    got = [t_task.labels(g, epoch=1, step=s) for s, g in enumerate(
        StoreProvider(tstore, tspec, roots, sizes=sizes, **kw).epoch(1))]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_link_prediction_rejects_zero_negatives_and_runner_reexports():
    with pytest.raises(ValueError, match="num_negatives"):
        t_tasks.LinkPrediction("writes", DIM, num_negatives=0)
    for name in ("DeepGraphInfomax", "GraphBinaryClassification",
                 "GraphMulticlassClassification", "LinkPrediction",
                 "RootNodeMulticlassClassification", "Task"):
        assert getattr(t_runner, name) is getattr(t_tasks, name)


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------

def test_quickstart_twin_matches_the_jax_example():
    """The example's graph, ops and GraphUpdate round, from the JAX
    round's parameters (PRNGKey(0), as the example draws them)."""
    from repro.core.graph_tensor import SOURCE, TARGET
    host = t_quickstart.example_graph()
    g = jax.tree_util.tree_map(jnp.asarray, _reference_graph(host))
    prices = j_ops.broadcast_node_to_edges(g, "purchased", SOURCE,
                                           feature_name="latest_price")
    spend = j_ops.pool_edges_to_node(g, "purchased", TARGET, "sum",
                                     feature_value=prices)
    max_spend = j_ops.pool_nodes_to_context(g, "users", "max",
                                            feature_value=spend)
    frac = spend / j_ops.broadcast_context_to_nodes(
        g, "users", feature_value=max_spend)
    g = g.replace_features(node_sets={
        "users": {J_HIDDEN: jnp.concatenate(
            [spend, g.node_sets["users"]["age"][:, None].astype(
                jnp.float32)], 1)},
        "items": {J_HIDDEN: g.node_sets["items"]["latest_price"]}})
    update = JGraphUpdate(node_sets={"users": JNodeSetUpdate(
        {"purchased": JSimpleConv(8, 1 + 2, receiver_tag=TARGET),
         "is-friend": JSimpleConv(8, 2 + 2, receiver_tag=TARGET)},
        JNextState(2 + 16, 16))})
    params = jax_params(update, 0)
    users = update(params, g).node_sets["users"][J_HIDDEN]
    got = t_quickstart.run(device="cpu", params=numpy_tree(params))
    np.testing.assert_allclose(got.total_spend, np.asarray(spend)[:, 0],
                               **TOL)
    np.testing.assert_allclose(got.total_spend,
                               [160.11, 50.33, 350.0, 45.13], rtol=1e-6)
    np.testing.assert_allclose(got.max_spend_fraction,
                               np.asarray(frac)[:, 0], **TOL)
    np.testing.assert_allclose(got.user_states, np.asarray(users), **TOL)
    assert got.user_states.shape == (4, 16)


def _reference_graph(host):
    """The reference's GraphTensor over a port host graph's arrays."""
    from repro.core import graph_tensor as j_gt
    return j_gt.GraphTensor(
        j_gt.Context(host.context.sizes, dict(host.context.features)),
        {n: j_gt.NodeSet(ns.sizes, dict(ns.features), ns.capacity)
         for n, ns in host.node_sets.items()},
        {n: j_gt.EdgeSet(es.sizes, j_gt.Adjacency(
            es.adjacency.source, es.adjacency.target,
            es.adjacency.source_name, es.adjacency.target_name),
            dict(es.features), es.capacity)
         for n, es in host.edge_sets.items()})


class JLinkInit(JModule):
    """examples/link_prediction_train.py's InitStates."""

    def __init__(self, dim):
        self.paper = JLinear(t_lp.FEAT_DIM, dim)
        self.author = JEmbedding(t_lp.VOCAB, dim)

    def init(self, key):
        k1, k2 = jax.random.split(key)
        return {"paper": self.paper.init(k1),
                "author": self.author.init(k2)}

    def __call__(self, params, graph):
        ids = graph.node_sets["author"]["id"] % t_lp.VOCAB
        return graph.replace_features(node_sets={
            "paper": {J_HIDDEN: jax.nn.relu(self.paper(
                params["paper"], graph.node_sets["paper"]["feat"]))},
            "author": {J_HIDDEN: self.author(params["author"], ids,
                                             dtype=jnp.float32)}})


class JAtomInit(JModule):
    """examples/graph_classification_train.py's InitStates."""

    def __init__(self, dim):
        self.atoms = JLinear(t_gc.FEAT_DIM, dim)

    def init(self, key):
        return {"atoms": self.atoms.init(key)}

    def __call__(self, params, graph):
        return graph.replace_features(node_sets={"atoms": {
            J_HIDDEN: jax.nn.relu(self.atoms(
                params["atoms"], graph.node_sets["atoms"]["feat"]))}})


def jax_steps(init, gnn, task, train, val, lr, total, steps):
    """The reference run: the JAX Trainer's initial parameters, `steps`
    steps of its train step over epoch 0, then `evaluate` over `val`."""
    assert not j_dispatch.enabled()  # the jnp reference, no kernels
    trainer = JTrainer(learning_rate=lr, total_steps=total)
    params = trainer._init_params(init, gnn, task.head())
    initial = numpy_tree(params)
    opt = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(
        lr, trainer.warmup_steps, total), weight_decay=trainer.weight_decay)
    opt_state = opt.init(params)

    def loss_fn(p, graph, labels):
        return task.loss_from_graph(p["head"], gnn(p["gnn"], init(
            p["init"], graph)), labels)

    def metric_fn(p, graph, labels):
        pairs = task.metrics(p["head"], gnn(p["gnn"], init(p["init"],
                                                           graph)), labels)
        return tuple(x for k in task.metric_names() for x in pairs[k])

    step_fn = j_train_step(loss_fn, opt)
    losses = []
    with j_dispatch.layout(sorted_by_target=True):
        for step, graph in enumerate(train.epoch(0)):
            if step == steps:
                break
            labels = task.labels(graph, epoch=0, step=step)
            params, opt_state, loss = step_fn(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray,
                                                          graph),
                jnp.asarray(labels))
            losses.append(float(loss))
        eval_fn = j_eval_step(metric_fn)
        metrics = j_evaluation.evaluate(
            val, task, lambda g, lab: eval_fn(params, g, lab),
            lambda g, lab: (jax.tree_util.tree_map(jnp.asarray, g),
                            jnp.asarray(lab)),
            metric_keys=task.metric_names())
    return initial, losses, numpy_tree(params), metrics


def check_run(result, initial, want_losses, want_params, want_metrics):
    losses = result.metrics["train_losses"]
    assert result.step == len(losses) == len(want_losses) == STEPS
    np.testing.assert_allclose(losses, want_losses, **TOL)
    got = {k: v.numpy() for k, v in result.metrics["params"].items()}
    want = flat(want_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the examples' warmup (50 steps) keeps the first steps' lr near 1e-4
    start = flat(initial)
    assert max(np.abs(got[k] - start[k]).max() for k in got) > 1e-4
    for k, v in want_metrics.items():
        np.testing.assert_allclose(result.metrics["eval"][k], v, err_msg=k,
                                   **TOL)


def test_link_prediction_twin_matches_the_jax_example():
    """3 steps at 96 papers (the example's 480 cut for the CPU), its
    hidden 32, 2 rounds, 4 negatives, batches of 16, then the eval pass."""
    papers = 96
    store, _ = j_synthetic_mag(n_papers=papers, n_authors=papers // 2,
                               n_institutions=40, n_fields=80, n_classes=8,
                               feat_dim=t_lp.FEAT_DIM)
    b = j_sampling.SamplingSpecBuilder(j_mag_schema())
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    authors = cited.join([seed_op]).sample(4, "written")
    authors.sample(4, "writes")
    spec = seed_op.build()
    roots = np.arange(papers)
    n_train = int(papers * 0.75)
    sizes = j_find_sizes([j_sampling.sample_subgraph(
        store, spec, int(r), j_sampling.seed_rng(0, int(r)))
        for r in roots], t_lp.BATCH)
    train, val = (JStore(store, spec, part, batch_size=t_lp.BATCH,
                         sizes=sizes, seed=0, base_seed=0)
                  for part in (roots[:n_train], roots[n_train:]))
    dim = t_lp.HIDDEN
    gnn = j_vanilla_mpnn(t_lp.EDGES, {"paper": dim, "author": dim},
                         message_dim=dim, hidden_dim=dim,
                         num_rounds=t_lp.ROUNDS, use_layer_norm=True)
    task = j_tasks.LinkPrediction("writes", dim,
                                  num_negatives=t_lp.NEGATIVES, base_seed=0)
    initial, losses, params, metrics = jax_steps(
        JLinkInit(dim), gnn, task, train, val, t_lp.LEARNING_RATE,
        t_lp.TOTAL_STEPS, STEPS)
    result = t_lp.run(device="cpu", papers=papers, steps=STEPS,
                      params=initial)
    check_run(result, initial, losses, params, metrics)


def test_graph_classification_twin_matches_the_jax_example(tmp_path):
    """3 steps at 96 graphs (the example's 480 cut for the CPU), its 3
    classes, hidden 32, 3 rounds, batches of 16, then the eval pass the
    cut epoch ends with; checkpointing on, its best pinned."""
    graphs = 96
    data = j_gc_set(num_graphs=graphs, num_classes=t_gc.CLASSES,
                    feat_dim=t_gc.FEAT_DIM, seed=0)
    n_train = int(graphs * 0.75)
    sizes = j_find_sizes(data, t_gc.BATCH)
    train = JBatcher(data[:n_train], t_gc.BATCH, sizes, seed=0)
    val = JBatcher(data[n_train:], t_gc.BATCH, sizes, seed=0)
    dim = t_gc.HIDDEN
    gnn = j_vanilla_mpnn({"bonds": ("atoms", "atoms")}, {"atoms": dim},
                         message_dim=dim, hidden_dim=dim,
                         num_rounds=t_gc.ROUNDS, use_layer_norm=True)
    task = j_tasks.GraphMulticlassClassification("atoms", t_gc.CLASSES,
                                                 dim)
    initial, losses, params, metrics = jax_steps(
        JAtomInit(dim), gnn, task, train, val, t_gc.LEARNING_RATE,
        t_gc.TOTAL_STEPS, STEPS)
    result = t_gc.run(device="cpu", graphs=graphs, steps=STEPS,
                      params=initial, ckpt_dir=str(tmp_path / "ck"))
    check_run(result, initial, losses, params, metrics)
    assert result.metrics["best_checkpoint"].endswith(
        f"step_{STEPS:010d}")
