"""The LM on the mesh against the JAX package, on the CPU.

* `param_axes(model)` for all 10 arch ids against the reference's
  ``model.axes()`` (its stacked leaves split per layer, their leading
  "layers" axis dropped).
* `use_sharding` / `logical_to_spec` / `param_shardings` against the
  reference's on a grid of axes, meshes and shapes;
  `shard_activation` and `constrain_tree` are the identity.
* The registry's `partitioned` context: nesting, restore, the
  `data_parallel` alias and its per-shard counts against the reference's
  `_per_shard` / `_per_shard_feature`.
* The mesh train step against the reference's.  One JAX subprocess (4
  host devices) runs ``make_train_step(plan=plan_for(make_host_mesh(4,
  shape=(2, 2))), zero1=True)`` for 3 steps on each case of
  `torch_lm_mesh_ranks.CASES` (qwen1.5-4b with AdamW, two microbatches
  and an uneven loss mask; granite-moe-3b-a800m at capacity factor 0.5,
  with drops; command-r-plus-104b with `pick_optimizer`'s Adafactor;
  rwkv6-3b), and one 4-rank gloo world runs the port on the same initial
  parameters and batches: per-step metrics and final parameters at rtol
  1e-4 / atol 1e-5 on every rank, every rank the same.  The learning
  rate is 1e-4: Adam's first steps move a parameter by about its
  gradient's sign times the rate, so a gradient element within rounding
  of zero, summed in another order, can land up to twice the rate away.
  The same world checks Adafactor and the global norm on a tree cut over
  both axes against the whole tree (rtol 1e-6), and the bytes a rank
  holds (parameters at most 0.55 of the whole, optimizer state at most
  1 / 3.5).
* A world of one rank running the mesh program gives the plain step's
  numbers bit for bit, and an MoE whose group count the data ranks do
  not divide raises.
* On the card (marked `cuda`, skipped here): the qwen case on 4 gloo
  ranks sharing the card against one rank of the card (fp32, TF32 off).
  The file imports the JAX package only inside the tests that compare
  with it, so on a machine with a card and no JAX ``PYTHONPATH=src
  python -m pytest -q --noconftest -m cuda tests/test_torch_lm_mesh.py``
  runs it.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_mesh_ranks as R  # noqa: E402 — its directory is on the path

from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed import sharding as t_sharding  # noqa: E402
from repro_torch.distributed.collectives import Axis  # noqa: E402
from repro_torch.distributed.launch import run_ranks  # noqa: E402
from repro_torch.kernels import registry as t_registry  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

WORLD_TIMEOUT_S = 480


def reference(module: str):
    """A module of the JAX package (imported here, not at the top, so
    the card's test runs where there is no JAX)."""
    return importlib.import_module(module)


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_axes_match_reference(arch):
    j_registry = reference("repro.models.registry")
    ref = R.flatten(j_registry.build_model(
        j_registry.get_config(arch + "-smoke")).axes())
    model = registry.build_model(registry.get_config(arch + "-smoke"), "cpu")
    stacks = {k: len(getattr(model, k)) for k in layers.LAYER_STACKS
              if isinstance(getattr(model, k, None), torch.nn.ModuleList)}
    want = {}
    for key, axes in ref.items():
        top, _, rest = key.partition(".")
        if top in stacks:
            assert axes[0] == "layers", (key, axes)
            want.update({f"{top}.{i}.{rest}": tuple(axes[1:])
                         for i in range(stacks[top])})
        else:
            want[key] = tuple(axes)
    assert layers.param_axes(model) == want


def test_param_axes_refuses_an_undeclared_parameter():
    class Bare(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))

    with pytest.raises(ValueError, match="declares no logical axes"):
        layers.param_axes(Bare())


# ---------------------------------------------------------------------------
# the sharding context
# ---------------------------------------------------------------------------

def _meshes(names, sizes):
    return (types.SimpleNamespace(axis_names=names, devices=np.empty(sizes)),
            types.SimpleNamespace(axis_names=names,
                                  shape=dict(zip(names, sizes))))


AXES_SHAPES = [
    (("embed", "heads"), (128, 96)),
    (("heads", "embed"), (96, 128)),
    (("vocab", "embed"), (49155, 64)),
    (("expert", "embed", "mlp"), (4, 128, 64)),
    (("embed", "vocab"), (6, 7)),
    (("layers", "embed", "kv_heads"), (2, 5, 8)),
    (("batch", "seq", None), (4, 16, 8)),
    (("moe_group", "expert", None, "mlp"), (8, 4, 2, 6)),
    ((None,), (3,)),
    ((), ()),
]


@pytest.mark.parametrize("names,sizes", [(("data",), (4,)),
                                         (("data", "model"), (2, 2)),
                                         (("data", "model"), (1, 4)),
                                         (("pod", "data", "model"),
                                          (2, 2, 2))])
@pytest.mark.parametrize("kind", ["param", "act"])
def test_sharding_specs_match_reference(monkeypatch, names, sizes, kind):
    j_sharding = reference("repro.distributed.sharding")
    jmesh, tmesh = _meshes(names, sizes)
    # the reference wraps each spec in a NamedSharding of a device mesh;
    # the spec is what both packages compute
    monkeypatch.setattr(j_sharding, "NamedSharding", lambda mesh, spec: spec)
    axes_tree = {f"leaf{i}": a for i, (a, _) in enumerate(AXES_SHAPES)}
    shapes = {f"leaf{i}": types.SimpleNamespace(shape=s)
              for i, (_, s) in enumerate(AXES_SHAPES)}
    rules = {"embed": None} if kind == "act" else None
    with j_sharding.use_sharding(jmesh, param_rules=rules):
        want_specs = [tuple(j_sharding.logical_to_spec(a, kind=kind))
                      for a, _ in AXES_SHAPES]
        want = j_sharding.param_shardings(axes_tree, kind=kind)
        want_fit = j_sharding.param_shardings(axes_tree, kind=kind,
                                              specs_tree=shapes)
    assert t_sharding.current_context() is None
    with t_sharding.use_sharding(tmesh, param_rules=rules) as ctx:
        assert t_sharding.current_context() is ctx
        got_specs = [t_sharding.logical_to_spec(a, kind=kind)
                     for a, _ in AXES_SHAPES]
        got = t_sharding.param_shardings(axes_tree, kind=kind)
        got_fit = t_sharding.param_shardings(axes_tree, kind=kind,
                                             specs_tree=shapes)
    assert t_sharding.current_context() is None
    assert got_specs == want_specs
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got_fit == {k: tuple(v) for k, v in want_fit.items()}


def test_context_is_seen_by_other_threads():
    """On the card autograd recomputes a checkpointed layer on its own
    device thread, which must see the forward's mesh (an MoE layer there
    would otherwise regroup its tokens)."""
    import threading
    _, tmesh = _meshes(("data", "model"), (2, 2))
    seen = []
    with t_sharding.use_sharding(tmesh) as ctx:
        worker = threading.Thread(
            target=lambda: seen.append(t_sharding.current_context()))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    assert seen == [ctx]


def test_constraints_are_the_identity_and_specs_need_a_context():
    x = torch.arange(6.0).reshape(2, 3)
    _, tmesh = _meshes(("data", "model"), (2, 2))
    with t_sharding.use_sharding(tmesh):
        assert t_sharding.shard_activation(x, ("batch", None)) is x
        tree = {"a": x}
        assert t_sharding.constrain_tree(tree, {"a": ("embed", None)}) \
            is tree
        assert t_sharding.mesh_axis("data") is None  # no rank axes
    assert t_sharding.logical_to_spec(("embed",)) == ()
    with pytest.raises(RuntimeError, match="use_sharding"):
        t_sharding.param_shardings({"a": ("embed",)})


# ---------------------------------------------------------------------------
# the registry's partitioned context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (2, 2), (4, 2),
                                        (3, 5)])
def test_partitioned_counts_match_reference(data, model):
    j_dispatch = reference("repro.kernels.dispatch")
    counts = [0, 1, 7, 64, 1000, 1001]
    with j_dispatch.partitioned(data=data, model=model):
        want = ([j_dispatch._per_shard(n) for n in counts],
                [j_dispatch._per_shard_feature(n) for n in counts],
                j_dispatch.data_shards(), j_dispatch.model_shards())
    with t_registry.partitioned(data=data, model=model):
        got = ([t_registry._per_shard(n) for n in counts],
               [t_registry._per_shard_feature(n) for n in counts],
               t_registry.data_shards(), t_registry.model_shards())
    assert got == want


def test_partitioned_nests_and_restores():
    assert (t_registry.data_shards(), t_registry.model_shards()) == (1, 1)
    with t_registry.partitioned(data=4, model=2):
        with t_registry.data_parallel(8):
            assert (t_registry.data_shards(),
                    t_registry.model_shards()) == (8, 1)
        assert (t_registry.data_shards(), t_registry.model_shards()) == (4, 2)
        with pytest.raises(KeyError):
            with t_registry.partitioned(data=0, model=-1):
                assert (t_registry.data_shards(),
                        t_registry.model_shards()) == (1, 1)
                raise KeyError("inside")
        assert (t_registry.data_shards(), t_registry.model_shards()) == (4, 2)
    assert (t_registry.data_shards(), t_registry.model_shards()) == (1, 1)


def test_plan_dispatch_context_scales_the_autotune_key(monkeypatch):
    """Under the plan's context a decision's autotune key counts one
    data shard's rows and segments and one model shard's width."""
    from repro_torch.kernels import autotune
    seen = []
    monkeypatch.setattr(t_registry, "_AUTOTUNE", True)
    monkeypatch.setattr(t_registry, "_plain_reason", lambda t: None)
    monkeypatch.setattr(autotune, "device_sm", lambda d: 90)
    monkeypatch.setattr(autotune, "lookup", lambda key: seen.append(key))
    plan = types.SimpleNamespace(data_size=2, model_size=4)
    values = torch.zeros(10, 8)
    with partition.MeshPlan.dispatch_context(plan):
        t_registry.segment_reduce_decision(values, False, n_segments=5)
    t_registry.segment_reduce_decision(values, False, n_segments=5)
    assert seen[0] == autotune.pool_key(n=3, d=2, dtype=values.dtype,
                                        reduce="sum", layout="unsorted",
                                        e=5, sm=90)
    assert seen[1] == autotune.pool_key(n=5, d=8, dtype=values.dtype,
                                        reduce="sum", layout="unsorted",
                                        e=10, sm=90)


# ---------------------------------------------------------------------------
# the mesh step against the reference's
# ---------------------------------------------------------------------------

JAX_LM_MESH = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_lm_mesh_ranks as R
    import jax, jax.numpy as jnp
    from repro.distributed import partition
    from repro.launch.mesh import make_host_mesh
    from repro.launch.specs import pick_optimizer
    from repro.models import registry
    from repro.nn.module import split_params
    from repro.train import optimizer as opt
    from repro.train import train_loop

    assert jax.device_count() == 4, jax.devices()
    plan = partition.plan_for(make_host_mesh(4, shape=(2, 2)))
    metrics, arrays = {{}}, {{}}
    for name in {names!r}:
        case = R.CASES[name]
        cfg = R.config(registry, case)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(0)))[0]
        for k, v in R.flatten(jax.tree_util.tree_map(
                np.asarray, params)).items():
            arrays[f"{{name}}/init/{{k}}"] = v
        o = (pick_optimizer(registry.get_config(case["arch"]))
             if case["opt"] == "pick" else opt.AdamW(learning_rate=R.LR))
        step = train_loop.make_train_step(
            model, cfg, o, plan=plan, zero1=True,
            n_microbatches=case["n_micro"])
        state = o.init(params)
        batch = {{k: jnp.asarray(v)
                 for k, v in R.batch_np(cfg, case).items()}}
        metrics[name] = []
        for _ in range(R.STEPS):
            params, state, m = step(params, state, batch)
            metrics[name].append({{k: float(v) for k, v in m.items()}})
        for k, v in R.flatten(jax.tree_util.tree_map(
                np.asarray, params)).items():
            arrays[f"{{name}}/final/{{k}}"] = v

    # the compressed step, its gradient before each compression caught by
    # a callback (one run: R.COMPRESS_CASES start from the qwen case)
    from repro.distributed import compression as comp
    case = R.CASES["qwen"]
    cfg = R.config(registry, case)
    model = registry.build_model(cfg)
    params = split_params(model.init(jax.random.PRNGKey(0)))[0]
    caught = []

    def catching(grads):
        jax.debug.callback(lambda g: caught.append(
            jax.tree_util.tree_map(np.asarray, g)), grads)
        return comp.compress_int8_stateless(grads)

    o = opt.AdamW(learning_rate=R.LR)
    step = train_loop.make_train_step(
        model, cfg, o, plan=plan, zero1=True,
        n_microbatches=case["n_micro"], grad_compression=catching)
    state = o.init(params)
    batch = {{k: jnp.asarray(v) for k, v in R.batch_np(cfg, case).items()}}
    metrics["compress"] = []
    for _ in range(R.STEPS):
        params, state, m = step(params, state, batch)
        metrics["compress"].append({{k: float(v) for k, v in m.items()}})
    jax.effects_barrier()
    assert len(caught) == R.STEPS, len(caught)
    for i, grads in enumerate(caught):
        for k, v in R.flatten(grads).items():
            arrays[f"compress/x{{i}}/{{k}}"] = v
    for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                 params)).items():
        arrays[f"compress/final/{{k}}"] = v

    # the compressors on each piece's whole stacked trees
    for name in R.COMPRESS_PIECES:
        trees = [{{k: jnp.asarray(v) for k, v in R.stack_np(t).items()}}
                 for t in R.compress_trees(name)]

        def put(tag, tree):
            for k, v in tree.items():
                arrays[f"pieces/{{name}}/{{tag}}/{{k}}"] = np.asarray(v)

        put("stateless", comp.compress_int8_stateless(trees[0]))
        ef = comp.ErrorFeedbackCompressor()
        ef_state = ef.init(trees[0])
        for i, tree in enumerate(trees):
            out, ef_state = ef.compress(tree, ef_state)
            put(f"ef{{i}}", out)
            put(f"res{{i}}", ef_state.residual)
    np.savez({out!r}, **arrays)
    print("JAX_LM_MESH", json.dumps(metrics))
""")


@pytest.fixture(scope="module")
def jax_lm_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_mesh") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    script = JAX_LM_MESH.format(tests=tests, names=list(R.CASES),
                                out=str(out))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "JAX_LM_MESH" in res.stdout, (res.stdout[-2000:],
                                         res.stderr[-3000:])
    metrics = json.loads(res.stdout.split("JAX_LM_MESH", 1)[1])
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    split = {name: ({}, {}) for name in R.CASES}
    split["compress"] = {}
    pieces = {name: {} for name in R.COMPRESS_PIECES}
    for key, v in arrays.items():
        name, when, leaf = key.split("/", 2)
        if name == "compress":
            split[name].setdefault(when, {})[leaf] = v
        elif name == "pieces":
            tag, leaf = leaf.split("/", 1)
            pieces[when].setdefault(tag, {})[leaf] = v
        else:
            split[name][when == "final"][leaf] = v
    split["pieces"] = pieces
    return split, metrics


@pytest.fixture(scope="module")
def port_lm_mesh(jax_lm_mesh):
    trees, _ = jax_lm_mesh
    initial = {name: trees[name][0] for name in R.CASES}
    return run_ranks(R.lm_mesh_world, 4,
                     args=(list(R.CASES), initial, trees["pieces"]),
                     threads=1, timeout_s=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("name", list(R.CASES))
def test_mesh_step_matches_reference(jax_lm_mesh, port_lm_mesh, name):
    trees, metrics = jax_lm_mesh
    initial, final = trees[name]
    want = metrics[name]
    assert len(want) == R.STEPS
    for rank, world in enumerate(port_lm_mesh):
        got = world[name]
        for step, (g, w) in enumerate(zip(got["metrics"], want)):
            assert set(g) == set(w), (rank, step)
            for k in w:
                np.testing.assert_allclose(
                    g[k], w[k], rtol=1e-4, atol=1e-5,
                    err_msg=f"{name} rank {rank} step {step + 1} {k}")
        assert sorted(got["params"]) == sorted(final)
        for k, v in final.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"{name} rank {rank} {k}")
        if rank:  # one set of parameters on every rank
            for k, v in port_lm_mesh[0][name]["params"].items():
                np.testing.assert_array_equal(got["params"][k], v)
    moved = max(np.abs(final[k] - initial[k]).max() for k in final)
    assert moved > (1e-6 if name == "command_r" else 1e-4)
    assert want[-1]["loss"] < want[0]["loss"] or name == "command_r"
    if name == "granite":
        assert all(m["moe_drop_fraction"] > 0.05 for m in want)


def test_mesh_memory_per_rank(port_lm_mesh):
    """qwen at (data=2, model=2): a rank holds its model half of the
    parameters and a quarter of the optimizer state (the leaves that
    stay whole, the norms and scalars, add a little to both)."""
    got = port_lm_mesh[0]["qwen"]
    cfg = registry.get_config("qwen1.5-4b-smoke")
    model = registry.build_model(cfg, "cpu")
    full = sum(p.numel() * 4 for p in model.parameters())
    assert got["param_bytes"] <= 0.55 * full
    # AdamW: m and v of every leaf, and the int32 step
    assert got["opt_bytes"] <= 2 * full / 3.5


def test_optimizer_on_both_axes_matches_whole_tree(port_lm_mesh):
    for world in port_lm_mesh:
        mine, want = world["pieces"]["params"]
        for k in R.PIECE_SHAPES:
            np.testing.assert_allclose(mine[k], want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        np.testing.assert_allclose(*world["pieces"]["norm"], rtol=1e-6)


@pytest.fixture
def one_thread():
    """One intra-op thread: the embedding gradient's scatter-add then
    sums in one order, so a step repeats bit for bit on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_world_of_one_rank_gives_the_plain_step(one_thread):
    case = R.CASES["granite"]
    tree = R.flatten(layers.stack_lm_tree(dict(layers.init_params(
        registry.build_model(R.config(registry, case), "cpu"),
        3).named_parameters())))
    got = R.train_case(case, tree, model_parallel=1, steps=2)
    want = R.train_case(case, tree, mesh=False, steps=2)
    assert got["metrics"] == want["metrics"]
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_mesh_and_plan_arguments_give_one_step():
    """``mesh=`` is wrapped by `plan_for`, as the reference's."""
    cfg = registry.get_config("qwen1.5-4b-smoke")
    model = registry.build_model(cfg, "cpu")
    plan = partition.make_plan(1, device="cpu")
    step = train_loop.make_train_step(model, cfg, t_opt.AdamW(),
                                      mesh=plan.mesh)
    assert isinstance(step, train_loop.MeshTrainStep)
    assert step.plan.mesh is plan.mesh
    # a plan with grad_compression builds a step
    compressed = train_loop.make_train_step(
        model, cfg, t_opt.AdamW(), plan=plan, grad_compression=lambda g: g)
    assert isinstance(compressed, train_loop.MeshTrainStep)
    assert compressed.grad_compression is not None


# ---------------------------------------------------------------------------
# gradient compression on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.COMPRESS_CASES))
def test_compressed_mesh_step_matches_reference(jax_lm_mesh, port_lm_mesh,
                                                name):
    """The step with ``compress_int8_stateless`` against the reference's
    compressed mesh step: metrics at rtol 1e-4 / atol 1e-5; each step's
    scales within ``1e-6 + 1e-4 |s|``; the first step's codes equal but
    where the reference's ``x / scale`` lies within 1e-3 of a
    half-integer (the two sums of the gradient may round to either side
    there), at most `MAX_MISSES` a leaf; the final parameters at rtol
    1e-4 / atol 1e-5 but at the elements whose codes differed in a
    step, which are held to ``STEPS x LR + 1e-5``."""
    from test_torch_lm_train_arch import MAX_MISSES
    trees, metrics = jax_lm_mesh
    ref = trees["compress"]
    want = metrics["compress"]
    got = port_lm_mesh[0]["compress"][name]
    for step, (g, w) in enumerate(zip(got["metrics"], want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} step {step + 1} {k}")
    differed = {}
    for step in range(R.STEPS):
        x_got, out_got = got["grads"][step]
        for k, miss in R.code_misses(ref[f"x{step}"], x_got, out_got,
                                     f"{name} step {step + 1}",
                                     MAX_MISSES if step == 0
                                     else None).items():
            differed[k] = differed.get(k, False) | miss
    for rank, world in enumerate(port_lm_mesh):
        params = world["compress"][name]["params"]
        R.final_within(params, ref["final"], differed, f"{name} rank {rank}")
        if rank:
            for k, v in port_lm_mesh[0]["compress"][name]["params"].items():
                np.testing.assert_array_equal(params[k], v)
    assert want[-1]["loss"] < want[0]["loss"]


@pytest.mark.parametrize("name", list(R.COMPRESS_PIECES))
def test_compressor_on_slices_matches_reference_exactly(port_lm_mesh, name):
    """Each rank's compressed slices (stateless) and its error-feedback
    output and residual over `COMPRESS_CALLS` calls equal its slices of
    the reference's compressors on the whole stacked trees, bit for
    bit."""
    for rank, world in enumerate(port_lm_mesh):
        got = world["compress_pieces"][name]
        assert len(got["mismatch"]) == 1 + 2 * R.COMPRESS_CALLS
        for tag, leaves in got["mismatch"].items():
            bad = {k: n for k, n in leaves.items() if n}
            assert not bad, (name, rank, tag, bad)
        assert got["elements"] > 0


def test_compressor_pieces_cover_every_leaf_kind(port_lm_mesh):
    for world in port_lm_mesh:
        kinds = {k for got in world["compress_pieces"].values()
                 for k in got["kinds"]}
        assert kinds >= set(R.COMPRESS_KINDS), kinds


def test_compression_takes_at_most_three_all_max_calls(port_lm_mesh):
    """One vector of maxima per set of cut axes: an `all_max` over
    "model", then one over "data" (at most 3 a step, 2 here)."""
    for world in port_lm_mesh:
        counts = [n for got in world["compress"].values()
                  for n in got["calls"]]
        counts += [n for got in world["compress_pieces"].values()
                   for n in got["calls"]]
        assert counts and all(0 < n <= 3 for n in counts), counts
        print("all_max calls a compression:", sorted(set(counts)))


def test_moe_groups_must_split_over_the_data_ranks():
    """Three data ranks: the group count (a power of two) cannot split,
    and the layer says so before any collective."""
    cfg = registry.get_config("granite-moe-3b-a800m-smoke")
    model = registry.build_model(cfg, "cpu")
    mesh = types.SimpleNamespace(axis_names=("data",), shape={"data": 3},
                                 axes={"data": Axis("data", 3, 0)})
    x = torch.zeros(1, 16, cfg.d_model)
    with t_sharding.use_sharding(mesh):
        with pytest.raises(ValueError, match="do not split over 3 data"):
            model.blocks[0].ffn(x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share it over gloo")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_mesh_matches_one_rank(cuda_device):
    case = R.CASES["qwen"]
    tree = R.flatten(layers.stack_lm_tree(dict(layers.init_params(
        registry.build_model(R.config(registry, case), "cpu"),
        0).named_parameters())))
    want = R.train_case(case, tree, mesh=False, device="cuda")
    for got in run_ranks(R.train_case, 4, args=(case, tree),
                         kwargs=dict(device="cuda"), device="cuda",
                         timeout_s=WORLD_TIMEOUT_S):
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
