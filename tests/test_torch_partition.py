"""The port's mesh (`repro_torch.distributed.partition` and what it
drives) against its plain versions and the JAX package, on the CPU.

Rank worlds run on gloo, spawned, joined through a `FileStore` in a
temporary directory (`repro_torch.distributed.launch.run_ranks`), each
with its own deadline; what a rank runs is in tests/torch_mesh_ranks.py.
One JAX subprocess (4 host devices) trains the reference's `Trainer` on a
(data=2, model=2) mesh.

* The rule tables resolve as the reference's do (the spec tuples equal
  the reference's PartitionSpecs).
* (data=1, model=2): every split segment reduction of `core.ops` is
  bit-identical to the unsharded op, and one batch's gradients under
  the model context, averaged over the mesh as the step averages them,
  equal the unsharded gradients (rtol 1e-6 of each parameter's largest
  entry) — a gather whose backward
  only sliced the cotangent would hand every parameter upstream of a
  split pool half of its gradient.
* (data=2): ZeRO-1's reduce-scattered gradient slices, global norm and
  three AdamW updates against the plain versions on the full trees
  (rtol 1e-6), and the state's bytes a rank halved.
* The port's 4-rank `Trainer` at (data=2, model=2) from the JAX initial
  parameters against the JAX `Trainer` on the same mesh: per-step losses
  and final parameters rtol 1e-4 / atol 1e-5, optimizer-state bytes per
  rank equal to the reference's `opt_state_bytes_per_device`; and one
  rank over the same 2-group super-batches reaches the same losses
  (1e-4, the reference's rule across device counts).
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_ranks as R  # noqa: E402 — its directory is put on the path

from repro.distributed import sharding as j_sharding  # noqa: E402
from repro_torch.distributed import sharding as t_sharding  # noqa: E402
from repro_torch.distributed.launch import run_ranks  # noqa: E402

FLEET_TIMEOUT_S = 120
STEPS = 3


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names,sizes", [(("data",), (4,)),
                                         (("data", "model"), (2, 2)),
                                         (("data", "model"), (1, 2))])
@pytest.mark.parametrize("axes,shape", [
    (("batch", None, "feature"), (4, 6, 8)),
    (("batch", None, "feature"), (4, 6, 3)),
    (("batch", None), (2, 5)),
    (("embed", None), (6, 3)),
    (("embed", None), (5, 3)),
    ((), ()),
    (("embed", "mlp"), (8, 4)),
])
def test_resolve_matches_reference(names, sizes, axes, shape):
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(sizes))
    tmesh = types.SimpleNamespace(axis_names=names,
                                  shape=dict(zip(names, sizes)))
    jctx = j_sharding.ShardingContext(jmesh, j_sharding.DEFAULT_PARAM_RULES,
                                      j_sharding.DEFAULT_ACT_RULES)
    tctx = t_sharding.ShardingContext(tmesh, t_sharding.DEFAULT_PARAM_RULES,
                                      t_sharding.DEFAULT_ACT_RULES)
    for kind in ("param_rules", "act_rules"):
        want = tuple(jctx.resolve(axes, getattr(jctx, kind), shape=shape))
        got = tctx.resolve(axes, getattr(tctx, kind), shape=shape)
        assert got == want, (kind, got, want)
    assert t_sharding.data_axis_names(tmesh) == \
        j_sharding.data_axis_names(jmesh)


def test_rule_tables_and_axes_leaves_are_the_reference_s():
    assert t_sharding.DEFAULT_PARAM_RULES == j_sharding.DEFAULT_PARAM_RULES
    assert t_sharding.DEFAULT_ACT_RULES == j_sharding.DEFAULT_ACT_RULES
    for x in [(), ("embed", None), ("a",), (("a", "b"),), [None], "x"]:
        assert t_sharding.is_axes_leaf(x) == j_sharding.is_axes_leaf(x)


# ---------------------------------------------------------------------------
# the model axis: split reductions and their gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_world():
    return run_ranks(R.model_axis_pieces, 2, threads=1,
                     timeout_s=FLEET_TIMEOUT_S)


def test_mp_segment_reduce_is_bit_identical_at_model_2(model_world):
    for rank, res in enumerate(model_world):
        assert res["splits"], rank
        assert len(res["same"]) > 20
        bad = [k for k, same in res["same"].items() if not same]
        assert not bad, (rank, bad)


def test_model_parallel_gradients_equal_unsharded(model_world):
    res = model_world[0]
    reached = 0
    for name, (got, want) in res["grads"].items():
        # rtol 1e-6 of the parameter's largest entry (the repo's gradient
        # rule): the model-axis mean sums the chunks' shares in another
        # order than the unsharded backward
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=name)
        reached += scale > 0
    # parameters upstream of split pools (the init states, the first
    # round's messages) are among those the loss reaches
    assert reached > 10
    assert np.abs(res["grads"]["init.paper.w"][1]).max() > 0
    for name, (got, _) in model_world[1]["grads"].items():
        np.testing.assert_array_equal(got, res["grads"][name][0])


# ---------------------------------------------------------------------------
# ZeRO-1 at data=2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zero_world():
    return run_ranks(R.zero_pieces, 2, threads=1, timeout_s=FLEET_TIMEOUT_S)


def test_zero_layout_follows_the_leading_dim(zero_world):
    res = zero_world[0]
    assert res["dims"] == {"emb": 0, "w": 0, "b": 0, "odd": -1, "s": -1}
    assert res["specs"]["emb"] == ("data", None)
    assert res["specs"]["odd"] == (None, None)
    assert res["data_sum"] == 2.0


def test_data_parallel_surface_places_each_rank_s_group(zero_world):
    """graph_sharding: a rank holds rank 0's replicated values and the
    group of the super-batch its data index names."""
    for rank, res in enumerate(zero_world):
        assert res["data_spec"] == ("data",)
        np.testing.assert_array_equal(res["replicated"], np.zeros(3))
        np.testing.assert_array_equal(res["local_feat"],
                                      res["global_feat"][rank:rank + 1])
        np.testing.assert_array_equal(res["local_labels"],
                                      res["global_labels"][rank:rank + 1])


def test_zero_reduce_scatter_norm_and_updates_match_plain(zero_world):
    for res in zero_world:
        for name, (got, want) in res["reduced"].items():
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        np.testing.assert_allclose(*res["norm"], rtol=1e-6)
        for part in ("params", "m"):
            for name, (got, want) in res[part].items():
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{part} {name}")
    # the moments of the three sliced leaves are halved a rank; the
    # replicated leaves and the step count stay whole
    res = zero_world[0]
    sliced = 2 * 4 * (8 * 5 + 6 * 4 + 4) // 2
    whole = 2 * 4 * (3 * 2 + 1) + 4
    assert res["bytes"] == sliced + whole
    assert res["full_bytes"] == 2 * sliced + whole


# ---------------------------------------------------------------------------
# the Trainer on a (data=2, model=2) mesh against the JAX Trainer
# ---------------------------------------------------------------------------

JAX_MESH_RUN = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_mesh_ranks as R
    from repro.core.graph_tensor import HIDDEN_STATE
    from repro.core.models import vanilla_mpnn
    from repro.core.schema import mag_schema
    from repro.data import sampling
    from repro.data.batching import find_size_constraints
    from repro.data.synthetic import synthetic_mag
    from repro.distributed import partition
    from repro.nn.layers import Embedding, Linear
    from repro.nn.module import Module
    from repro.orchestration import trainer as jt
    from repro.orchestration.providers import BatcherProvider
    from repro.orchestration.tasks import RootNodeMulticlassClassification

    assert jax.device_count() == 4, jax.devices()

    class InitStates(Module):
        def __init__(self):
            self.paper = Linear(R.FEAT, R.DIM)
            self.tables = {{n: Embedding(R.VOCAB, R.DIM) for n in
                           ("author", "institution", "field_of_study")}}

        def init(self, key):
            ks = jax.random.split(key, 4)
            p = {{"paper": self.paper.init(ks[0])}}
            for i, (n, t) in enumerate(sorted(self.tables.items())):
                p[n] = t.init(ks[i + 1])
            return p

        def __call__(self, params, graph):
            ns = {{"paper": {{HIDDEN_STATE: jax.nn.relu(self.paper(
                params["paper"], graph.node_sets["paper"]["feat"]))}}}}
            for n, t in self.tables.items():
                ids = graph.node_sets[n]["id"] % R.VOCAB
                ns[n] = {{HIDDEN_STATE: t(params[n], ids,
                                          dtype=jnp.float32)}}
            return graph.replace_features(node_sets=ns)

    store, _ = synthetic_mag(**R.STORE_KW)
    spec = R.section8_spec(sampling, store.schema)
    gs = [sampling.sample_subgraph(store, spec, r, sampling.seed_rng(0, r))
          for r in range(R.N_TRAIN)]
    sizes = find_size_constraints(gs, R.BATCH // 2)
    schema = mag_schema()
    edges = {{k: (v.source, v.target) for k, v in schema.edge_sets.items()}}

    def model_fn():
        return InitStates(), vanilla_mpnn(
            edges, {{n: R.DIM for n in schema.node_sets}},
            message_dim=R.DIM, hidden_dim=R.DIM, num_rounds=R.ROUNDS)

    task = RootNodeMulticlassClassification("paper", R.N_CLASSES, R.DIM)
    trainer = jt.Trainer(learning_rate=R.LR, warmup_steps=R.WARMUP,
                         total_steps=R.TOTAL, num_devices=4,
                         model_parallel=2, max_steps={steps},
                         log_every=10 ** 6)
    init, gnn = model_fn()
    initial = trainer._init_params(init, gnn, task.head())

    losses, placed = [], {{}}
    real = jt.make_graph_train_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def wrapped(*a):
            out = step(*a)
            losses.append(float(out[2]))
            placed["opt"] = out[1]
            return out
        return wrapped

    jt.make_graph_train_step = spy
    res = trainer.fit(model_fn, task,
                      BatcherProvider(gs, R.BATCH, sizes, num_replicas=2))
    plan = partition.make_plan(4, model_parallel=2)

    def flat(tree, prefix=""):
        if isinstance(tree, (list, tuple)):
            tree = dict(enumerate(tree))
        if isinstance(tree, dict):
            out = {{}}
            for k, v in tree.items():
                out.update(flat(v, f"{{prefix}}.{{k}}" if prefix
                                else str(k)))
            return out
        return {{prefix: np.asarray(tree)}}

    arrays = {{"init/" + k: v for k, v in flat(initial).items()}}
    arrays.update({{"final/" + k: v
                   for k, v in flat(res.metrics["params"]).items()}})
    np.savez({out!r}, **arrays)
    print("JAX_MESH", json.dumps({{
        "losses": losses,
        "opt_bytes": plan.opt_state_bytes_per_device(placed["opt"])}}))
""")


@pytest.fixture(scope="module")
def jax_mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    script = JAX_MESH_RUN.format(tests=tests, steps=STEPS, out=str(out))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "JAX_MESH" in res.stdout, (res.stdout[-2000:],
                                      res.stderr[-3000:])
    summary = json.loads(res.stdout.split("JAX_MESH", 1)[1])
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    initial = {k[len("init/"):]: v for k, v in arrays.items()
               if k.startswith("init/")}
    final = {k[len("final/"):]: v for k, v in arrays.items()
             if k.startswith("final/")}
    return initial, final, summary


def _close_to_jax(got, initial, final, summary):
    np.testing.assert_allclose(got["losses"], summary["losses"], rtol=1e-4,
                               atol=1e-5)
    assert sorted(got["params"]) == sorted(final)
    for k, want in final.items():
        np.testing.assert_allclose(got["params"][k], want, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert max(np.abs(got["params"][k] - initial[k]).max()
               for k in final) > 1e-3


def test_mesh_trainer_matches_jax_on_a_2x2_mesh(jax_mesh_run):
    initial, final, summary = jax_mesh_run
    assert len(summary["losses"]) == STEPS
    runs = run_ranks(R.train, 4, args=(4, 2, 2),
                     kwargs=dict(params=initial, max_steps=STEPS),
                     threads=1, timeout_s=FLEET_TIMEOUT_S)
    for rank, got in enumerate(runs):
        assert got["step"] == STEPS, rank
        _close_to_jax(got, initial, final, summary)
        assert got["opt_state_bytes"] == summary["opt_bytes"], rank
    # the ranks hold one set of parameters and one loss sequence
    for got in runs[1:]:
        assert got["losses"] == runs[0]["losses"]
        for k in final:
            np.testing.assert_array_equal(got["params"][k],
                                          runs[0]["params"][k])


def test_one_rank_trains_the_mesh_program(jax_mesh_run):
    """`Trainer(num_devices=1)`: no process group, the same 2-group
    super-batches, the same trajectory as the 4-device mesh."""
    initial, final, summary = jax_mesh_run
    got = R.train(1, 1, 2, params=initial, max_steps=STEPS)
    _close_to_jax(got, initial, final, summary)
    # no ZeRO on one data shard: the whole AdamW state on the rank
    n = sum(v.size for v in final.values())
    assert got["opt_state_bytes"] == 2 * 4 * n + 4
