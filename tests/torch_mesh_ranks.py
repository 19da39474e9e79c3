"""What each rank of the port's mesh tests runs (imported by name in the
spawned rank processes, so it imports torch and `repro_torch` only).

The problem is the §8 pipeline at a small size, as
tests/test_torch_train.py builds it: synthetic MAG (96 papers), the §8
sampling spec at fanout 2, a 2-round 16-wide `vanilla_mpnn`, the
root-node task; batches of 8 roots cut into component groups
(`BatcherProvider(num_replicas=R)`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_tensor import HIDDEN_STATE, unstack_graph
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema
from repro_torch.data import sampling
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.synthetic import synthetic_mag
from repro_torch.nn.layers import Embedding, Linear, init_params
from repro_torch.orchestration.providers import BatcherProvider
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.orchestration.trainer import Trainer, TrainModel

FEAT, DIM, N_CLASSES, ROUNDS, VOCAB = 8, 16, 4, 2, 64
STORE_KW = dict(n_papers=96, n_authors=48, n_institutions=6, n_fields=12,
                n_classes=N_CLASSES, feat_dim=FEAT)
BATCH, N_TRAIN = 8, 48
LR, WARMUP, TOTAL = 3e-3, 2, 20


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


class InitStates(torch.nn.Module):
    """Initial states as the §8 example builds them (the names of the
    reference's parameter tree)."""

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


def model_fn(reduce_type: str = "sum"):
    schema = mag_schema()
    edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
    return InitStates(), vanilla_mpnn(
        edges, {n: DIM for n in schema.node_sets}, message_dim=DIM,
        hidden_dim=DIM, num_rounds=ROUNDS, reduce_type=reduce_type)


def graphs():
    """The sampled training subgraphs and their size constraints per
    group of BATCH // 2 roots (the same in every process)."""
    store, _ = synthetic_mag(**STORE_KW)
    spec = section8_spec(sampling, store.schema)
    gs = [sampling.sample_subgraph(store, spec, r, sampling.seed_rng(0, r))
          for r in range(N_TRAIN)]
    return gs, find_size_constraints(gs, BATCH // 2)


def task():
    return RootNodeMulticlassClassification("paper", N_CLASSES, DIM)


def train(num_devices, model_parallel=1, num_replicas=2, *, params=None,
          reduce_type="sum", max_steps=None, ckpt_dir="", resume=False,
          save_interval_steps=100, epochs=1):
    """One `Trainer.fit` on the CPU over stacked super-batches of
    `num_replicas` groups; returns what the tests compare (numpy)."""
    gs, sizes = graphs()
    trainer = Trainer(learning_rate=LR, warmup_steps=WARMUP,
                      total_steps=TOTAL, device="cpu", log_every=10 ** 6,
                      num_devices=num_devices, model_parallel=model_parallel,
                      max_steps=max_steps, ckpt_dir=ckpt_dir, resume=resume,
                      save_interval_steps=save_interval_steps, epochs=epochs)
    res = trainer.fit(lambda: model_fn(reduce_type), task(),
                      BatcherProvider(gs, BATCH, sizes,
                                      num_replicas=num_replicas),
                      params=params)
    return {"losses": res.metrics["train_losses"], "step": res.step,
            "params": {k: v.numpy().copy()
                       for k, v in res.metrics["params"].items()},
            "opt_state_bytes": res.metrics["opt_state_bytes"]}


# ---------------------------------------------------------------------------
# the pieces of the mesh, on one world
# ---------------------------------------------------------------------------

def _segment_cases(plan, ops, graph):
    """Every split call site of `core.ops` on one batch (edge features
    64 wide, like a pool of split 128-wide messages at model=2)."""
    rng = np.random.default_rng(7)
    out = {}
    for name, es in sorted(graph.edge_sets.items()):
        vals = torch.from_numpy(rng.standard_normal(
            (es.capacity, 6)).astype(np.float32))
        for reduce in ("sum", "mean", "max", "min"):
            out[f"{name}/{reduce}"] = ops.pool_edges_to_node(
                graph, name, "target", reduce, feature_value=vals)
        out[f"{name}/source_sum"] = ops.pool_edges_to_node(
            graph, name, "source", "sum", feature_value=vals)
        out[f"{name}/softmax"] = ops.segment_softmax(
            graph, name, "target", feature_value=vals)
    for name, ns in sorted(graph.node_sets.items()):
        vals = torch.from_numpy(rng.standard_normal(
            (ns.capacity, 4)).astype(np.float32))
        out[f"ctx/{name}"] = ops.pool_nodes_to_context(
            graph, name, "mean", feature_value=vals)
    # a width the model axis does not divide stays unsharded
    es_name = sorted(graph.edge_sets)[0]
    odd = torch.from_numpy(rng.standard_normal(
        (graph.edge_sets[es_name].capacity, 3)).astype(np.float32))
    out["odd"] = ops.pool_edges_to_node(graph, es_name, "target", "sum",
                                        feature_value=odd)
    return out


def model_axis_pieces():
    """On a (data=1, model=2) world: the split segment reductions
    against the unsharded op (bit for bit), and one batch's gradients
    under the model context, averaged over the mesh as the step does,
    against the unsharded gradients."""
    from repro_torch.core import ops
    from repro_torch.distributed import collectives, partition
    plan = partition.make_plan(2, model_parallel=2, device="cpu")
    gs, sizes = graphs()
    prov = BatcherProvider(gs, BATCH, sizes, num_replicas=2)
    host = next(iter(prov.epoch(0)))
    labels = task().labels(host)
    graph, lab = plan.put_super_batch(host, labels)
    g0 = unstack_graph(graph)[0]
    plain = _segment_cases(plan, ops, g0)
    with plan.model_context() as ctx:
        split = _segment_cases(plan, ops, g0)
        splits = ctx is not None
    same = {k: bool(torch.equal(plain[k], split[k])) for k in plain}

    model = init_params(TrainModel(*model_fn("sum"), task().head()), 0)
    t = task()
    params = dict(model.named_parameters())

    def grads():
        loss = t.loss_from_graph(model.head, model(g0), lab[0])
        return torch.autograd.grad(loss, list(params.values()),
                                   allow_unused=True,
                                   materialize_grads=True)

    want = grads()
    with plan.model_context():
        got = grads()
    world = plan.mesh.world
    got = [collectives.all_reduce(g, world) / world.size for g in got]
    return {"splits": splits, "same": same,
            "grads": {k: (a.numpy(), b.numpy())
                      for k, a, b in zip(params, got, want)}}


def zero_pieces():
    """On a (data=2) world: ZeRO-1's reduce-scatter, global norm and
    AdamW update against the plain versions on the full trees."""
    from repro_torch.distributed import collectives, partition
    from repro_torch.train import optimizer as opt_mod
    plan = partition.make_plan(2, device="cpu")
    rng = np.random.default_rng(3)
    shapes = {"emb": (8, 5), "w": (6, 4), "b": (4,), "odd": (3, 2),
              "s": ()}
    params = {k: torch.from_numpy(np.asarray(rng.standard_normal(s),
                                             np.float32))
              for k, s in shapes.items()}
    # each rank's gradient differs; the mean is what both must see
    per_rank = [{k: torch.from_numpy(np.asarray(
        np.random.default_rng(10 + r).standard_normal(s) * 3.0, np.float32))
                 for k, s in shapes.items()} for r in range(2)]
    mine = per_rank[plan.rank]
    mean = {k: (per_rank[0][k] + per_rank[1][k]) / 2 for k in shapes}
    specs = plan.zero_param_specs(params)
    dims = plan.zero_dims(specs)
    g_loc = plan.zero_reduce_grads(mine, dims)
    want_loc = plan.zero_slice(mean, dims)
    opt = opt_mod.AdamW(learning_rate=opt_mod.warmup_cosine(1e-2, 2, 10))
    state = plan.place_opt_state(opt, params, opt.init(params))
    p_loc = plan.zero_slice(params, dims)
    norm_zero = opt_mod.global_norm(g_loc, group=plan.data_axis,
                                    shard_dims=dims)
    norm_plain = opt_mod.global_norm(mean)
    p_full, s_full = dict(params), opt.init(params)
    for _ in range(3):
        p_new, state, _ = opt.update(g_loc, state, p_loc,
                                     group=plan.data_axis, shard_dims=dims)
        p_loc = p_new
        p_full, s_full, _ = opt.update(mean, s_full, p_full)
    gathered = plan.zero_gather(p_loc, dims)
    full_state = plan.gather_opt_state(opt, params, state)
    # the 1-D surface: rank 0's values everywhere, this rank's group
    from repro_torch.distributed import graph_sharding
    mesh = graph_sharding.make_data_mesh(2)
    mine_tree = {"x": torch.full((3,), float(plan.rank))}
    graph_sharding.replicate(mine_tree, mesh)
    gs, sizes = graphs()
    host = next(iter(BatcherProvider(gs, BATCH, sizes,
                                     num_replicas=2).epoch(0)))
    local, lab = graph_sharding.put_super_batch(host, task().labels(host),
                                                mesh, device="cpu")
    return {"dims": dims, "specs": specs,
            "reduced": {k: (g_loc[k].numpy(), want_loc[k].numpy())
                        for k in shapes},
            "norm": (float(norm_zero), float(norm_plain)),
            "params": {k: (gathered[k].numpy(), p_full[k].numpy())
                       for k in shapes},
            "m": {k: (full_state.m[k].numpy(), s_full.m[k].numpy())
                  for k in shapes},
            "bytes": plan.opt_state_bytes_per_device(state),
            "replicated": mine_tree["x"].numpy(),
            "data_spec": graph_sharding.data_spec(mesh),
            "local_feat": local.node_sets["paper"]["feat"].numpy(),
            "global_feat": np.asarray(host.node_sets["paper"]["feat"]),
            "local_labels": lab.numpy(),
            "global_labels": task().labels(host),
            "full_bytes": plan.opt_state_bytes_per_device(s_full),
            "data_sum": float(collectives.all_reduce(
                torch.ones(()), plan.data_axis))}


def resume_case(ckpt_dir: str) -> dict:
    """On a (data=2) world, ZeRO-1 on: an uninterrupted epoch, then the
    same epoch stopped at a save after step 3 and resumed from it."""
    whole = train(2, 1, 2)
    first = train(2, 1, 2, max_steps=3, ckpt_dir=ckpt_dir,
                  save_interval_steps=3)
    resumed = train(2, 1, 2, ckpt_dir=ckpt_dir, resume=True)
    return {"whole": whole, "first": first, "resumed": resumed}


def train_on(device: str, num_devices: int, model_parallel: int) -> dict:
    """The mean model on `device` over 2-group super-batches, 3 steps."""
    gs, sizes = graphs()
    trainer = Trainer(learning_rate=LR, warmup_steps=WARMUP,
                      total_steps=TOTAL, device=device, log_every=10 ** 6,
                      num_devices=num_devices, model_parallel=model_parallel,
                      max_steps=3)
    res = trainer.fit(lambda: model_fn("mean"), task(),
                      BatcherProvider(gs, BATCH, sizes, num_replicas=2))
    return {"losses": res.metrics["train_losses"]}
