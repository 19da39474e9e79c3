"""A split model serving, the "pod" axis and the dry run's tally, on
gloo ranks on the CPU.

* Prefill and greedy decode of the dense, MoE and vlm smoke models split
  over (data=2, model=2) on 4 gloo ranks (each rank its data block of
  the prompts, its kv heads in the cache, whole logits) against the
  reference's `prefill` / `decode_step` jitted with `param_shardings` on
  a 2 x 2 JAX CPU mesh (fp32 logits rtol 1e-4 / atol 1e-5, greedy tokens
  equal), and against the port's own one-rank run.
* The qwen train case of `tests/test_torch_lm_mesh.py` on (pod=2,
  data=1, model=2) against the reference's mesh step on a JAX mesh of
  the same axes, at that file's tolerances.
* One traced train step (`repro_torch.launch.dryrun.trace_train`) of
  smoke qwen and granite-moe at (data=2, model=2): rank 0 of a fake
  world of 4 (a spawned process) against the real 4-rank gloo world,
  exactly: the parameter and optimizer bytes a rank holds (also as the
  mesh counts them, `tree_bytes` and `opt_state_bytes_per_device`) and
  the count and bytes of each kind of `torch.distributed` call.
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

WORLD_TIMEOUT_S = 240

JAX_SERVE = textwrap.dedent("""
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
    from repro.train import optimizer as opt
    from repro.train import train_loop

    assert jax.device_count() == 4, jax.devices()
    mesh = make_host_mesh(4, shape=(2, 2))
    arrays, runs = {{}}, {{}}
    for name, arch in L.SERVE_CASES.items():
        cfg = L.serve_config(registry, arch)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(0)))[0]
        for k, v in R.flatten(jax.tree_util.tree_map(
                np.asarray, params)).items():
            arrays[f"{{name}}/init/{{k}}"] = v
        inputs = {{k: jnp.asarray(v)
                  for k, v in L.serve_inputs(cfg).items()}}
        extras = {{k: v for k, v in inputs.items() if k != "tokens"}}
        max_len = L.SERVE_PROMPT + L.SERVE_STEPS + cfg.num_patches
        with use_sharding(mesh):
            shard = param_shardings(model.axes(), kind="param",
                                    specs_tree=params)
            placed = jax.device_put(params, shard)
            prefill = jax.jit(lambda p, t, e: model.prefill(
                p, t, max_len=max_len, **e))
            decode = jax.jit(model.decode_step)
            out, cache = prefill(placed, inputs["tokens"], extras)
            logits, tokens = [], []
            for _ in range(L.SERVE_STEPS):
                last = out.logits[:, -1]
                logits.append(np.asarray(last))
                tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
                tokens.append(np.asarray(tok))
                out, cache = decode(placed, tok, cache)
            logits.append(np.asarray(out.logits[:, -1]))
        arrays[f"{{name}}/logits"] = np.stack(logits, 1)
        arrays[f"{{name}}/tokens"] = np.concatenate(tokens, 1)

    # the train case on (pod=2, data=1, model=2)
    case = L.POD_CASE
    cfg = R.config(registry, case)
    model = registry.build_model(cfg)
    params = split_params(model.init(jax.random.PRNGKey(1)))[0]
    for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                 params)).items():
        arrays[f"pod/init/{{k}}"] = v
    plan = partition.plan_for(make_host_mesh(
        4, axes=("pod", "data", "model"), shape=(2, 1, 2)))
    o = opt.AdamW(learning_rate=R.LR)
    step = train_loop.make_train_step(model, cfg, o, plan=plan, zero1=True,
                                      n_microbatches=case["n_micro"])
    state = o.init(params)
    batch = {{k: jnp.asarray(v) for k, v in R.batch_np(cfg, case).items()}}
    runs["pod"] = []
    for _ in range(R.STEPS):
        params, state, m = step(params, state, batch)
        runs["pod"].append({{k: float(v) for k, v in m.items()}})
    for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                 params)).items():
        arrays[f"pod/final/{{k}}"] = v
    np.savez({out!r}, **arrays)
    print("JAX_SERVE", json.dumps(runs))
""")


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", JAX_SERVE.format(tests=tests, out=str(out))],
        env=env, capture_output=True, text=True, timeout=400)
    assert "JAX_SERVE" in res.stdout, (res.stdout[-2000:],
                                       res.stderr[-3000:])
    metrics = json.loads(res.stdout.split("JAX_SERVE", 1)[1])
    tree: dict = {}
    with np.load(out) as data:
        for key in data.files:
            name, _, rest = key.partition("/")
            tree.setdefault(name, {})[rest] = data[key]
    return tree, metrics


def _part(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def port_serve(jax_serve):
    tree, _ = jax_serve
    initial = {name: _part(tree[name], "init/") for name in L.SERVE_CASES}
    return run_ranks(L.serve_world, 4,
                     args=(initial, _part(tree["pod"], "init/")),
                     threads=1, timeout_s=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("name", list(L.SERVE_CASES))
def test_split_prefill_and_decode_match_reference(jax_serve, port_serve,
                                                  name):
    tree, _ = jax_serve
    want_logits, want_tokens = tree[name]["logits"], tree[name]["tokens"]
    one = L.serve_case(L.SERVE_CASES[name], _part(tree[name], "init/"),
                       split=False)
    np.testing.assert_allclose(one["logits"], want_logits, rtol=1e-4,
                               atol=1e-5, err_msg=f"{name} one rank")
    np.testing.assert_array_equal(one["tokens"], want_tokens)
    covered = []
    for rank, world in enumerate(port_serve):
        got = world[name]
        rows = slice(*got["rows"])
        covered.append(got["rows"])
        assert got["logits"].shape[-1] == want_logits.shape[-1]  # whole
        np.testing.assert_allclose(got["logits"], want_logits[rows],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} rank {rank}")
        np.testing.assert_allclose(got["logits"], one["logits"][rows],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got["tokens"], want_tokens[rows])
        # the cache holds this rank's kv heads (the smoke configs' split)
        assert got["kv_heads"] * 2 == one["kv_heads"], (name, got["kv_heads"])
    assert sorted(set(covered)) == [(0, 2), (2, 4)]


def test_pod_axis_step_matches_reference(jax_serve, port_serve):
    tree, metrics = jax_serve
    final = _part(tree["pod"], "final/")
    want = metrics["pod"]
    for rank, world in enumerate(port_serve):
        got = world["pod"]
        assert len(got["metrics"]) == R.STEPS
        for step, (g, w) in enumerate(zip(got["metrics"], want)):
            for k in w:
                np.testing.assert_allclose(
                    g[k], w[k], rtol=1e-4, atol=1e-5,
                    err_msg=f"pod rank {rank} step {step + 1} {k}")
        for k, v in final.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {rank} {k}")
    assert want[-1]["loss"] < want[0]["loss"]


@pytest.fixture(scope="module")
def tally_pair():
    real = run_ranks(L.tally_world, 4, threads=1, timeout_s=WORLD_TIMEOUT_S)
    [fake] = run_ranks(L.tally_fake, 1, threads=1,
                       timeout_s=WORLD_TIMEOUT_S)
    return real, fake


@pytest.mark.parametrize("name", list(L.TALLY_CASES))
def test_dry_run_counts_equal_the_real_ranks(tally_pair, name):
    real, fake = tally_pair
    want = real[0][name]
    got = fake[name]
    assert got["held"] == want["held"] == want["mesh_bytes"]
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"]
    assert got["peak"]["params"] == want["peak"]["params"]
    per_op = want["collectives"]["per_op"]
    assert per_op["reduce_scatter_tensor"]["count"] >= 1   # ZeRO-1
    assert per_op["all_gather_into_tensor"]["count"] >= 1
    assert set(want["collectives"]["per_axis"]) <= {"data", "model"}
    for other in real[1:]:  # every rank holds and calls the same
        assert other[name]["held"] == want["held"]
        assert other[name]["collectives"] == want["collectives"]
