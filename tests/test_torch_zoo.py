"""The port's GNN model zoo against the JAX package, on the CPU.

On one small merged MAG batch (8 sampled subgraphs, target-sorted,
padded; 16-wide random states in every node set), from the JAX initial
parameters (`load_jax_params`), JAX kernels off (the reference):

* each new conv — `GCNConv`, `SAGEConv` (mean, pool), `GATv2Conv`
  (TARGET, SOURCE and CONTEXT receivers), `MultiHeadAttentionConv` — and
  each new model — `rgcn`, `gcn`, `graph_sage`, `gatv2`, `hgt_like` —
  forward (rtol 1e-4 / atol 1e-5) and gradients of a fixed random
  projection of the output with respect to every parameter (same
  tolerance; fp32 sums in another order);
* `hgt_like` and `gatv2` trained 3 steps by the port's `Trainer` and by
  the JAX `make_graph_train_step` loop over the same stream: per-step
  losses within rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convolutions as j_convs
from repro.core import models as j_models
from repro.core.graph_tensor import HIDDEN_STATE as J_HIDDEN
from repro.data import sampling as j_sampling
from repro.data.batching import find_size_constraints as j_find_sizes
from repro.data.grouping import merge_and_pad as j_merge_and_pad
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.kernels import dispatch as j_dispatch
from repro.nn.layers import Embedding as JEmbedding, Linear as JLinear
from repro.nn.module import Module as JModule, split_params
from repro.orchestration.providers import BatcherProvider as JProvider
from repro.orchestration.tasks import (
    RootNodeMulticlassClassification as JRootTask)
from repro.orchestration.trainer import Trainer as JTrainer
from repro.train import optimizer as j_opt
from repro.train.train_loop import make_graph_train_step as j_train_step

from repro_torch.core import convolutions as t_convs
from repro_torch.core import models as t_models
from repro_torch.core.graph_tensor import (CONTEXT, HIDDEN_STATE, SOURCE,
                                           TARGET, to_device)
from repro_torch.data import sampling as t_sampling
from repro_torch.data.grouping import merge_and_pad as t_merge_and_pad
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.nn.layers import Embedding, Linear, init_params, \
    load_jax_params
from repro_torch.orchestration.providers import BatcherProvider
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.orchestration.trainer import Trainer

FEAT, DIM, HEADS, PER_HEAD, N_CLASSES, VOCAB = 8, 16, 2, 8, 4, 64
STORE_KW = dict(n_papers=96, n_authors=48, n_institutions=6, n_fields=12,
                n_classes=N_CLASSES, feat_dim=FEAT)
BATCH, N_ROOTS, TRAIN_STEPS = 8, 24, 3
LR, WARMUP, TOTAL = 3e-3, 2, 20
TOL = dict(rtol=1e-4, atol=1e-5)


def section8_spec(module, schema):
    """The §8 sampling spec (examples/ogbn_mag_train.py) at fanout 2."""
    b = module.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(4, "cites")
    authors = cited.join([seed_op]).sample(2, "written")
    author_papers = authors.sample(2, "writes")
    authors.sample(2, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(2, "has_topic")
    return seed_op.build()


@pytest.fixture(scope="module")
def data():
    """The same sampled subgraphs in both packages (held equal in
    test_torch_host_parity.py), their size constraints, and the edge
    sets of the schema."""
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    jspec = section8_spec(j_sampling, jstore.schema)
    tspec = section8_spec(t_sampling, tstore.schema)
    jg = [j_sampling.sample_subgraph(jstore, jspec, r,
                                     j_sampling.seed_rng(0, r))
          for r in range(N_ROOTS)]
    tg = [t_sampling.sample_subgraph(tstore, tspec, r,
                                     t_sampling.seed_rng(0, r))
          for r in range(N_ROOTS)]
    edges = {k: (v.source, v.target)
             for k, v in tstore.schema.edge_sets.items()}
    return jg, tg, j_find_sizes(jg, BATCH), edges


@pytest.fixture(scope="module")
def batch(data):
    """(JAX graph, port graph) of one batch with the same random
    16-wide states in every node set and the context."""
    jg, tg, sizes, _ = data
    jb = j_merge_and_pad(jg[:BATCH], sizes, sort_by_target=True)
    tb = to_device(t_merge_and_pad(tg[:BATCH], sizes, sort_by_target=True),
                   "cpu")
    rng = np.random.default_rng(0)
    states = {n: rng.standard_normal((ns.capacity, DIM)).astype(np.float32)
              for n, ns in sorted(tb.node_sets.items())}
    ctx = rng.standard_normal((tb.num_components, DIM)).astype(np.float32)
    jb = jax.tree_util.tree_map(jnp.asarray, jb).replace_features(
        context={J_HIDDEN: jnp.asarray(ctx)},
        node_sets={n: {J_HIDDEN: jnp.asarray(x)} for n, x in states.items()})
    tb = tb.replace_features(
        context={HIDDEN_STATE: torch.from_numpy(ctx)},
        node_sets={n: {HIDDEN_STATE: torch.from_numpy(x)}
                   for n, x in states.items()})
    return jb, tb


def flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree_, (list, tuple)):
        return flat(dict(enumerate(tree_)), prefix)
    return {prefix: np.asarray(tree_)}


def check_against_jax(j_module, t_module, j_apply, t_apply, cot_seed):
    """Forward of both packages from the JAX initial parameters, then the
    gradients of sum(out * cot) for one random cotangent per output."""
    params = split_params(j_module.init(jax.random.PRNGKey(1)))[0]
    load_jax_params(t_module, jax.tree_util.tree_map(np.asarray, params))
    want, vjp = jax.vjp(j_apply, params)
    got = t_apply(t_module)
    assert sorted(want) == sorted(got)
    rng = np.random.default_rng(cot_seed)
    cots = {k: rng.standard_normal(np.shape(want[k])).astype(np.float32)
            for k in sorted(want)}
    for k in sorted(want):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)
    (want_grads,) = vjp({k: jnp.asarray(c) for k, c in cots.items()})
    loss = sum((got[k] * torch.from_numpy(c)).sum() for k, c in cots.items())
    names = [n for n, _ in t_module.named_parameters()]
    grads = torch.autograd.grad(loss, list(t_module.parameters()))
    want_flat = flat(want_grads)
    assert sorted(names) == sorted(want_flat)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_flat[name], err_msg=name,
                                   **TOL)


CONVS = {
    "gcn": (lambda m: m.GCNConv(DIM, DIM), "cites", TARGET),
    "sage_mean": (lambda m: m.SAGEConv(DIM, DIM), "writes", TARGET),
    # the reference's `w` takes in_dim, so `hidden` must equal it
    "sage_pool": (lambda m: m.SAGEConv(DIM, DIM, aggregator="pool"),
                  "writes", TARGET),
    "gatv2": (lambda m: m.GATv2Conv(HEADS, PER_HEAD, DIM), "writes",
              TARGET),
    "gatv2_source": (lambda m: m.GATv2Conv(HEADS, PER_HEAD, DIM,
                                           receiver_tag="source"),
                     "has_topic", SOURCE),
    "gatv2_context": (lambda m: m.GATv2Conv(HEADS, PER_HEAD, DIM,
                                            receiver_tag="context"),
                      "cites", CONTEXT),
    "multi_head_attention": (lambda m: m.MultiHeadAttentionConv(
        HEADS, PER_HEAD, DIM), "cites", TARGET),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(batch, name):
    make, edge_set, tag = CONVS[name]
    jb, tb = batch
    j_conv, t_conv = make(j_convs), make(t_convs)
    assert t_conv.receiver_tag == tag
    check_against_jax(
        j_conv, t_conv,
        lambda p: {"out": j_conv(p, jb, edge_set)},
        lambda m: {"out": m(tb, edge_set)}, cot_seed=len(name))


def zoo(module, edges, dims):
    """{name: stack} of the five models at the test's widths."""
    return {
        "rgcn": lambda: module.rgcn(edges, dims, hidden_dim=DIM),
        "gcn": lambda: module.gcn("cites", "paper", DIM, hidden_dim=DIM),
        "graph_sage": lambda: module.graph_sage(edges, dims,
                                                hidden_dim=DIM),
        "gatv2": lambda: module.gatv2(edges, dims, num_heads=HEADS,
                                      per_head=PER_HEAD),
        "hgt_like": lambda: module.hgt_like(edges, dims, num_heads=HEADS,
                                            per_head=PER_HEAD),
    }


@pytest.mark.parametrize("name", ["rgcn", "gcn", "graph_sage", "gatv2",
                                  "hgt_like"])
def test_model_matches_jax(data, batch, name):
    edges = data[3]
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    jb, tb = batch
    j_gnn = zoo(j_models, edges, dims)[name]()
    t_gnn = zoo(t_models, edges, dims)[name]()
    check_against_jax(
        j_gnn, t_gnn,
        lambda p: {n: ns[J_HIDDEN] for n, ns in j_gnn(p, jb).node_sets.items()},
        lambda m: {n: ns[HIDDEN_STATE] for n, ns in m(tb).node_sets.items()},
        cot_seed=len(name))


def test_gatv2_draws_attention_logits_from_the_seed():
    """init_params draws GATv2's attn_logits (N(0, 1) / sqrt(C), as the
    reference) along with its Linears, from the one seed."""
    a = init_params(t_convs.GATv2Conv(4, 32, 16), 0)
    b = init_params(t_convs.GATv2Conv(4, 32, 16), 0)
    assert torch.equal(a.attn_logits, b.attn_logits)
    assert 0.1 < a.attn_logits.std().item() * 32 ** 0.5 < 10
    assert torch.equal(a.w_query.w, b.w_query.w)


# ---------------------------------------------------------------------------
# three training steps through the Trainer
# ---------------------------------------------------------------------------

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
        ns = {"paper": {J_HIDDEN: jax.nn.relu(self.paper(
            params["paper"], graph.node_sets["paper"]["feat"]))}}
        for n, t in self.tables.items():
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {J_HIDDEN: t(params[n], ids, dtype=jnp.float32)}
        return graph.replace_features(node_sets=ns)


class TInitStates(torch.nn.Module):
    """The port's twin of JInitStates (same parameter names)."""

    def __init__(self):
        super().__init__()
        self.paper = Linear(FEAT, DIM)
        self.author = Embedding(VOCAB, DIM)
        self.institution = Embedding(VOCAB, DIM)
        self.field_of_study = Embedding(VOCAB, DIM)

    def forward(self, graph):
        ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
            graph.node_sets["paper"]["feat"]))}}
        for n in ("author", "institution", "field_of_study"):
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {HIDDEN_STATE: getattr(self, n)(ids,
                                                    dtype=torch.float32)}
        return graph.replace_features(node_sets=ns)


@pytest.mark.parametrize("name", ["hgt_like", "gatv2"])
def test_trainer_steps_match_jax(data, name):
    jg, tg, sizes, edges = data
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    init, gnn = JInitStates(), zoo(j_models, edges, dims)[name]()
    task = JRootTask("paper", N_CLASSES, DIM)
    trainer = JTrainer(learning_rate=LR, warmup_steps=WARMUP,
                       total_steps=TOTAL)
    params = trainer._init_params(init, gnn, task.head())
    initial = jax.tree_util.tree_map(np.asarray, params)
    opt = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(LR, WARMUP, TOTAL),
                      weight_decay=trainer.weight_decay)
    opt_state = opt.init(params)

    def loss_fn(p, graph, labels):
        return task.loss_from_graph(p["head"], gnn(p["gnn"], init(
            p["init"], graph)), labels)

    step_fn = j_train_step(loss_fn, opt)
    want = []
    assert not j_dispatch.enabled()  # the jnp reference, no kernels
    with j_dispatch.layout(sorted_by_target=True):
        for step, graph in enumerate(JProvider(jg, BATCH, sizes).epoch(0)):
            if step == TRAIN_STEPS:
                break
            labels = task.labels(graph, epoch=0, step=step)
            params, opt_state, loss = step_fn(
                params, opt_state,
                jax.tree_util.tree_map(jnp.asarray, graph),
                jnp.asarray(labels))
            want.append(float(loss))

    result = Trainer(learning_rate=LR, warmup_steps=WARMUP,
                     total_steps=TOTAL, max_steps=TRAIN_STEPS, device="cpu",
                     log_every=10 ** 6).fit(
        lambda: (TInitStates(), zoo(t_models, edges, dims)[name]()),
        RootNodeMulticlassClassification("paper", N_CLASSES, DIM),
        BatcherProvider(tg, BATCH, sizes), params=initial)
    assert result.step == TRAIN_STEPS == len(want)
    np.testing.assert_allclose(result.metrics["train_losses"], want, **TOL)
    assert want[0] != want[-1]


@pytest.mark.parametrize("hidden", [DIM // 2, 2 * DIM])
def test_sage_pool_with_hidden_not_in_dim_raises_in_both(batch, hidden):
    """`SAGEConv(aggregator="pool", hidden=h)` with h != in_dim: the
    reference's `w` is `Linear(in_dim, units)`, but it reads the pooled
    `hidden`-wide messages, so the JAX package fails at that product, and
    the port, which copies it, fails at the same step."""
    jb, tb = batch
    make = lambda m: m.SAGEConv(DIM, DIM, aggregator="pool", hidden=hidden)
    j_conv, t_conv = make(j_convs), make(t_convs)
    params = split_params(j_conv.init(jax.random.PRNGKey(1)))[0]
    load_jax_params(t_conv, jax.tree_util.tree_map(np.asarray, params))
    assert params["pool"]["w"].shape == (DIM, hidden)
    with pytest.raises(TypeError, match="dot_general"):
        j_conv(params, jb, "writes")
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        t_conv(tb, "writes")
