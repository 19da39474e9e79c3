"""The reference's FSDP (ZeRO-3) layout on the port's mesh, against the
JAX package, on the CPU.

One JAX subprocess (4 host devices, a (data=2, model=2) mesh) places
the reference's parameters as its production `run_cell` does,
``param_shardings(model.axes(), kind="param")`` ("embed" over "data"),
and runs on them: 3 steps of ``make_train_step(plan=, zero1=True)`` for
each case of `torch_lm_mesh_ranks.FSDP_CASES` (qwen1.5-4b with AdamW,
two microbatches and an uneven mask, remat "layer"; granite-moe at
capacity factor 0.5, remat "dots", with drops; qwen1.5-4b at remat
"none"), the gradient of the first step, and the jitted prefill and
greedy decode of the dense, MoE and vlm smoke models.  It also runs the
reference's MoE layer with 2 groups on a batch of 4 rows, unsharded (the
semantics GSPMD keeps).  One 4-rank gloo world runs the port on the
same initial parameters, placed by `MeshPlan.place_params_`:

* the step: per-step metrics and whole final parameters at rtol 1e-4 /
  atol 1e-5 on every rank; the first step's gradient, whole, within
  ``1e-6 + 1e-4 |g|`` of the reference's;
* bytes: at (data=2, model=2) a rank holds at most 0.30 of the
  parameter bytes, and no leaf whole but the norms;
* no whole weight outlives its layer: every tensor the forward gathers
  is gone when it returns, and no more than one unit (a layer, or the
  embedding table, the final norm and the head) is alive at once, under
  "layer", "dots" and "none";
* `collectives.gather_at_use`: forward the whole, backward the sum of
  every rank's gradient of it, cut to the rank's slice;
* split prefill and decode of the placed models: logits rtol 1e-4 /
  atol 1e-5 and greedy tokens equal;
* the MoE at (pod=2, data=2, model=1) with fewer groups (2) than batch
  ranks (4): outputs, auxiliary values and gradients.

A fake world of 4 (`repro_torch.launch.dryrun`) traces the placed step:
its peak bytes by category on real CPU tensors equal those on meta
tensors (so the tally frees what a rank frees), under each remat; and
its calls and bytes per op equal the real gloo ranks'.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch_ranks as L  # noqa: E402 — its directory is on the path
import torch_lm_mesh_ranks as R  # noqa: E402

from repro_torch.distributed.launch import run_ranks  # noqa: E402
from repro_torch.models import registry  # noqa: E402

WORLD_TIMEOUT_S = 300
# leaves a placed smoke model keeps whole on every rank: the norms
WHOLE_OK = ("norm", "ln_")

JAX_FSDP = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_launch_ranks as L
    import torch_lm_mesh_ranks as R
    import jax, jax.numpy as jnp
    from repro.distributed import partition
    from repro.distributed.sharding import param_shardings, use_sharding
    from repro.launch.mesh import make_host_mesh
    from repro.models import registry
    from repro.nn.module import split_params
    from repro.nn.moe import MoELayer
    from repro.train import optimizer as opt
    from repro.train import train_loop

    assert jax.device_count() == 4, jax.devices()
    mesh = make_host_mesh(4, shape=(2, 2))
    plan = partition.plan_for(mesh)
    arrays, runs = {{}}, {{}}

    def save(prefix, tree):
        for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                     tree)).items():
            arrays[f"{{prefix}}/{{k}}"] = v

    def placed(model, params):
        with use_sharding(mesh):
            shard = param_shardings(model.axes(), kind="param",
                                    specs_tree=params)
        return jax.device_put(params, shard)

    for name, case in R.FSDP_CASES.items():
        cfg = R.config(registry, case)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(0)))[0]
        save(f"{{name}}/init", params)
        params = placed(model, params)
        batch = {{k: jnp.asarray(v)
                 for k, v in R.batch_np(cfg, case).items()}}
        loss_fn = train_loop.make_loss_fn(model, cfg)
        micro = train_loop._split_microbatches(batch, case["n_micro"])

        def mean_loss(p):
            return sum(loss_fn(p, jax.tree_util.tree_map(
                lambda x: x[i], micro))[0]
                for i in range(case["n_micro"])) / case["n_micro"]

        with use_sharding(mesh, plan.param_rules, plan.act_rules):
            save(f"{{name}}/grads", jax.jit(jax.grad(mean_loss))(params))
        o = opt.AdamW(learning_rate=R.LR)
        step = train_loop.make_train_step(
            model, cfg, o, plan=plan, zero1=True,
            n_microbatches=case["n_micro"])
        state = o.init(params)
        runs[name] = []
        for _ in range(R.STEPS):
            params, state, m = step(params, state, batch)
            runs[name].append({{k: float(v) for k, v in m.items()}})
        save(f"{{name}}/final", params)

    for name, arch in L.SERVE_CASES.items():
        cfg = L.serve_config(registry, arch)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(2)))[0]
        save(f"serve/{{name}}/init", params)
        inputs = {{k: jnp.asarray(v)
                  for k, v in L.serve_inputs(cfg).items()}}
        extras = {{k: v for k, v in inputs.items() if k != "tokens"}}
        max_len = L.SERVE_PROMPT + L.SERVE_STEPS + cfg.num_patches
        params = placed(model, params)
        with use_sharding(mesh):
            prefill = jax.jit(lambda p, t, e: model.prefill(
                p, t, max_len=max_len, **e))
            decode = jax.jit(model.decode_step)
            out, cache = prefill(params, inputs["tokens"], extras)
            logits, tokens = [], []
            for _ in range(L.SERVE_STEPS):
                last = out.logits[:, -1]
                logits.append(np.asarray(last))
                tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
                tokens.append(np.asarray(tok))
                out, cache = decode(params, tok, cache)
            logits.append(np.asarray(out.logits[:, -1]))
        arrays[f"serve/{{name}}/logits"] = np.stack(logits, 1)
        arrays[f"serve/{{name}}/tokens"] = np.concatenate(tokens, 1)

    c = R.MOE_PODS
    layer = MoELayer(c["dim"], c["hidden"], c["n_experts"], c["top_k"],
                     capacity_factor=c["capacity_factor"],
                     n_groups=c["n_groups"])
    params = split_params(layer.init(jax.random.PRNGKey(3)))[0]
    save("moe/init", params)
    inputs = {{k: jnp.asarray(v) for k, v in R.moe_pods_inputs().items()}}

    def moe_loss(p, x):
        y, aux = layer(p, x)
        return ((y * inputs["r"]).sum() + aux.load_balance_loss
                + aux.router_z_loss), (y, aux)

    (_, (y, aux)), (g_p, g_x) = jax.value_and_grad(
        moe_loss, argnums=(0, 1), has_aux=True)(params, inputs["x"])
    arrays["moe/y"] = np.asarray(y)
    arrays["moe/x_grad"] = np.asarray(g_x)
    save("moe/grads", g_p)
    runs["moe_aux"] = [float(a) for a in aux]
    np.savez({out!r}, **arrays)
    print("JAX_FSDP", json.dumps(runs))
""")


def _part(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_fsdp(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_fsdp") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", JAX_FSDP.format(tests=tests, out=str(out))],
        env=env, capture_output=True, text=True, timeout=500)
    assert "JAX_FSDP" in res.stdout, (res.stdout[-2000:], res.stderr[-3000:])
    runs = json.loads(res.stdout.split("JAX_FSDP", 1)[1])
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, runs


@pytest.fixture(scope="module")
def port_fsdp(jax_fsdp):
    arrays, _ = jax_fsdp
    initial = {name: _part(arrays, f"{name}/init/")
               for name in R.FSDP_CASES}
    initial.update({f"serve/{name}": _part(arrays, f"serve/{name}/init/")
                    for name in L.SERVE_CASES})
    return run_ranks(R.fsdp_world, 4,
                     args=(initial, _part(arrays, "moe/init/")),
                     threads=1, timeout_s=WORLD_TIMEOUT_S)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.FSDP_CASES))
def test_fsdp_step_matches_reference(jax_fsdp, port_fsdp, name):
    arrays, runs = jax_fsdp
    initial = _part(arrays, f"{name}/init/")
    final = _part(arrays, f"{name}/final/")
    want = runs[name]
    assert len(want) == R.STEPS
    for rank, world in enumerate(port_fsdp):
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
            for k, v in port_fsdp[0][name]["params"].items():
                np.testing.assert_array_equal(got["params"][k], v)
    assert max(np.abs(final[k] - initial[k]).max() for k in final) > 1e-4
    assert want[-1]["loss"] < want[0]["loss"]
    if name == "granite":
        assert all(m["moe_drop_fraction"] > 0.05 for m in want)


@pytest.mark.parametrize("name", list(R.FSDP_CASES))
def test_fsdp_gradients_match_reference(jax_fsdp, port_fsdp, name):
    """The first step's gradient, summed over the mesh and whole, against
    the reference's on its placed parameters."""
    arrays, _ = jax_fsdp
    want = _part(arrays, f"{name}/grads/")
    for rank, world in enumerate(port_fsdp):
        got = world[name]["grads"]
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            d = np.abs(got[k] - g)
            bad = d > 1e-6 + 1e-4 * np.abs(g)
            assert not bad.any(), (name, rank, k, float(d.max()))
    assert max(np.abs(g).max() for g in want.values()) > 1e-3


def test_fsdp_bytes_per_rank(port_fsdp):
    """(data=2, model=2): a rank holds about a quarter of the parameter
    bytes; only the norms stay whole."""
    cfg = R.config(registry, R.FSDP_CASES["qwen"])
    model = registry.build_model(cfg, "cpu")
    full = sum(p.numel() * 4 for p in model.parameters())
    for world in port_fsdp:
        got = world["qwen"]
        assert got["param_bytes"] <= 0.30 * full, got["param_bytes"] / full
        assert got["whole_leaves"], "the norms stay whole"
        assert all(any(w in k for w in WHOLE_OK)
                   for k in got["whole_leaves"]), got["whole_leaves"]
        # AdamW's moments over the same slices
        assert got["opt_bytes"] <= 2 * 0.30 * full + 64


@pytest.mark.parametrize("name", list(R.FSDP_CASES))
def test_no_whole_weight_outlives_its_layer(port_fsdp, name):
    for world in port_fsdp:
        live = world[name]["liveness"]
        assert live["gathers"] > 0
        # two microbatches (or one): nothing gathered survives a forward
        assert live["after_forward"] == [0] * R.FSDP_CASES[name]["n_micro"]
        assert 0 < live["most"] <= live["largest_unit"], live


# ---------------------------------------------------------------------------
# the gather Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1])
def test_gather_at_use_is_all_gather_then_reduce_scatter_sum(port_fsdp,
                                                             dim):
    parts, weights = R.gather_pieces(dim)
    whole = np.concatenate(parts, axis=dim)
    total = sum(weights)
    seen = set()
    for world in port_fsdp:
        got = world["gather"]
        i = got["index"]
        seen.add(i)
        y, grad = got[dim]
        np.testing.assert_array_equal(y, whole)
        want = np.split(total, len(parts), axis=dim)[i]
        np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)
    assert seen == {0, 1}


# ---------------------------------------------------------------------------
# serving under the placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(L.SERVE_CASES))
def test_placed_prefill_and_decode_match_reference(jax_fsdp, port_fsdp,
                                                   name):
    arrays, _ = jax_fsdp
    want_logits = arrays[f"serve/{name}/logits"]
    want_tokens = arrays[f"serve/{name}/tokens"]
    cfg = L.serve_config(registry, L.SERVE_CASES[name])
    full = sum(p.numel() * 4
               for p in registry.build_model(cfg, "cpu").parameters())
    covered = []
    for rank, world in enumerate(port_fsdp):
        got = world["serve"][name]
        rows = slice(*got["rows"])
        covered.append(got["rows"])
        np.testing.assert_allclose(got["logits"], want_logits[rows],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} rank {rank}")
        np.testing.assert_array_equal(got["tokens"], want_tokens[rows])
        assert got["param_bytes"] <= 0.30 * full, got["param_bytes"] / full
    assert sorted(set(covered)) == [(0, 2), (2, 4)]


# ---------------------------------------------------------------------------
# the MoE groups over pod x data
# ---------------------------------------------------------------------------

def test_moe_groups_shared_over_pods_match_reference(jax_fsdp, port_fsdp):
    """2 groups over 2 pods x 2 data ranks: each group spans two batch
    ranks, which compute it alike and keep their own rows."""
    arrays, runs = jax_fsdp
    rows = R.MOE_PODS["batch"] // 4
    want_grads = _part(arrays, "moe/grads/")
    seen = set()
    for world in port_fsdp:
        got = world["moe_pods"]
        i = got["index"]
        seen.add(i)
        cut = slice(i * rows, (i + 1) * rows)
        np.testing.assert_allclose(got["y"], arrays["moe/y"][cut],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["x_grad"], arrays["moe/x_grad"][cut],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["aux"], runs["moe_aux"], rtol=1e-5,
                                   atol=1e-7)
        assert sorted(got["grads"]) == sorted(want_grads)
        for k, g in want_grads.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert seen == {0, 1, 2, 3}
    assert runs["moe_aux"][2] > 0   # tokens dropped: capacity binds


# ---------------------------------------------------------------------------
# the dry run's tally under FSDP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fsdp_tally():
    [fake] = run_ranks(L.fsdp_tally_fake, 1, threads=1,
                       timeout_s=WORLD_TIMEOUT_S)
    real = run_ranks(L.tally_world, 4, args=(True,), threads=1,
                     timeout_s=WORLD_TIMEOUT_S)
    return fake, real


@pytest.mark.parametrize("remat", list(L.FSDP_TALLY))
def test_tally_on_real_tensors_equals_meta(fsdp_tally, remat):
    """The placed step traced on real CPU tensors and on meta ones: the
    same step peak by category (gathered layers included), calls and
    bytes held.  (The setup differs: real parameters are drawn.)"""
    fake, _ = fsdp_tally
    meta, real = fake[f"{remat}/meta"], fake[f"{remat}/cpu"]
    assert real["peak"] == meta["peak"]
    assert real["collectives"] == meta["collectives"]
    assert real["held"] == meta["held"]
    assert meta["peak"]["gathered"] > 0


@pytest.mark.parametrize("name", list(L.TALLY_CASES))
def test_fsdp_dry_run_calls_equal_the_real_ranks(fsdp_tally, name):
    fake, real = fsdp_tally
    want = real[0][name]
    got = fake[name]
    assert got["held"] == want["held"] == want["mesh_bytes"]
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"]
    per_op = want["collectives"]["per_axis"]["data"]
    assert per_op["count"] > 0    # the gathers at use and their backward
    for other in real[1:]:
        assert other[name]["held"] == want["held"]
        assert other[name]["collectives"] == want["collectives"]
