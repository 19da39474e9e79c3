"""The reference's sequence parallelism on the port's mesh, against the
JAX package, on the CPU.

Under the plan's act rule ``"seq": "model"`` the port holds the residual
stream as each model rank's slice of the sequence in training and
prefill, and cuts the KV caches by sequence with a softmax merged over
"model" in decode.  One JAX subprocess (4 host devices, a (data=2,
model=2) mesh) runs the reference under the same rule:
``make_train_step(plan=plan_for(mesh, act_rules={"seq": "model"}),
zero1=True)`` for 3 steps on each case of
`torch_lm_mesh_ranks.SEQ_CASES` (command-r-plus-104b: the parallel
block, LayerNorm, tied embeddings and Adafactor, remat "layer";
granite-moe at capacity factor 0.5, remat "dots"; qwen1.5-4b with 5
heads, so that attention stays whole over "model" and its leaves take
the model-axis gradient sum, two microbatches and an uneven mask;
zamba2-1.2b; rwkv6-3b split by heads, and with 3 heads of 32 by value
columns, its weights cut at rest;
whisper-medium over 32 frames and 32 tokens), the gradient of the first
step, and the jitted prefill and greedy decode of the dense, MoE, vlm,
zamba2, whisper and rwkv6 smoke models.
One 4-rank gloo world runs the port on the same initial parameters:

* the step: per-step metrics and whole final parameters at rtol 1e-4 /
  atol 1e-5 on every rank; the first step's gradient, whole, within
  ``1e-6 + 1e-4 |g|`` of the reference's;
* prefill and decode: logits at rtol 1e-4 / atol 1e-5 and greedy tokens
  equal (rwkv6's decode reads the token shifts and wkv state its cut
  prefill left), every KV cache a rank holds half of the whole along
  the sequence (whisper's cross cache along the frames), and every
  prefill gathers the residual (it held the rank's slice);
* no whole gathered residual outlives its block under remat "layer",
  "dots" and "none" (and in rwkv6 under "none", whisper under "dots"):
  when a microbatch's forward returns, the one whole sequence alive is
  the head's input;
* `gather_seq` / `reduce_scatter_seq` forward and backward against
  their definitions;
* the dry run's trace of the command-r smoke step under the rule, on
  rank 0 of a fake world of 4: its calls and bytes per op equal the real
  ranks', its peak on real CPU tensors equal to that on meta tensors.

whisper's key biases have a true gradient of zero
(`torch_lm_mesh_ranks.zero_grad_leaves`): their final values are held
to ``STEPS x LR + 1e-5``, as `tests/test_torch_lm_tp_families.py` holds
them.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_mesh_ranks as R  # noqa: E402 — its directory is on the path

from repro_torch.distributed.collectives import Axis  # noqa: E402
from repro_torch.distributed.launch import run_ranks  # noqa: E402
from repro_torch.models import registry  # noqa: E402

WORLD_TIMEOUT_S = 600

JAX_SEQ = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_launch_ranks as L
    import torch_lm_mesh_ranks as R
    import jax, jax.numpy as jnp
    from repro.distributed import partition
    from repro.distributed.sharding import use_sharding
    from repro.launch.mesh import make_host_mesh
    from repro.launch.specs import pick_optimizer
    from repro.models import registry
    from repro.nn.module import split_params
    from repro.train import optimizer as opt
    from repro.train import train_loop

    assert jax.device_count() == 4, jax.devices()
    mesh = make_host_mesh(4, shape=(2, 2))
    plan = partition.plan_for(mesh, act_rules=R.SEQ_RULES)
    arrays, runs = {{}}, {{}}

    def save(prefix, tree):
        for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                     tree)).items():
            arrays[f"{{prefix}}/{{k}}"] = v

    for name, case in R.SEQ_CASES.items():
        cfg = R.config(registry, case)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(0)))[0]
        save(f"{{name}}/init", params)
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
        o = (pick_optimizer(registry.get_config(case["arch"]))
             if case["opt"] == "pick" else opt.AdamW(learning_rate=R.LR))
        step = train_loop.make_train_step(
            model, cfg, o, plan=plan, zero1=True,
            n_microbatches=case["n_micro"])
        state = o.init(params)
        runs[name] = []
        for _ in range(R.STEPS):
            params, state, m = step(params, state, batch)
            runs[name].append({{k: float(v) for k, v in m.items()}})
        save(f"{{name}}/final", params)

    for name, arch in R.SEQ_SERVE.items():
        cfg = L.serve_config(registry, arch)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(2)))[0]
        save(f"serve/{{name}}/init", params)
        inputs = {{k: jnp.asarray(v)
                  for k, v in R.seq_serve_inputs(cfg).items()}}
        extras = {{k: v for k, v in inputs.items() if k != "tokens"}}
        max_len = L.SERVE_PROMPT + L.SERVE_STEPS + cfg.num_patches
        with use_sharding(mesh, act_rules=R.SEQ_RULES):
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
    np.savez({out!r}, **arrays)
    print("JAX_SEQ", json.dumps(runs))
""")


def _part(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_seq(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_seq") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", JAX_SEQ.format(tests=tests, out=str(out))],
        env=env, capture_output=True, text=True, timeout=700)
    assert "JAX_SEQ" in res.stdout, (res.stdout[-2000:], res.stderr[-3000:])
    runs = json.loads(res.stdout.split("JAX_SEQ", 1)[1])
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, runs


@pytest.fixture(scope="module")
def port_seq(jax_seq):
    arrays, _ = jax_seq
    initial = {name: _part(arrays, f"{name}/init/") for name in R.SEQ_CASES}
    serve = {name: _part(arrays, f"serve/{name}/init/")
             for name in R.SEQ_SERVE}
    return run_ranks(R.seq_world, 4, args=(initial, serve), threads=1,
                     timeout_s=WORLD_TIMEOUT_S)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.SEQ_CASES))
def test_seq_step_matches_reference(jax_seq, port_seq, name):
    arrays, runs = jax_seq
    initial = _part(arrays, f"{name}/init/")
    final = _part(arrays, f"{name}/final/")
    want = runs[name]
    assert len(want) == R.STEPS
    bounds = _final_bounds(arrays, name, final)
    for rank, world in enumerate(port_seq):
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
                                       atol=bounds[k],
                                       err_msg=f"{name} rank {rank} {k}")
        if rank:  # one set of parameters on every rank
            for k, v in port_seq[0][name]["params"].items():
                np.testing.assert_array_equal(got["params"][k], v)
    # the steps moved the parameters (Adafactor's first steps by ~1e-5)
    assert max(np.abs(final[k] - initial[k]).max() for k in final) > 1e-5
    assert want[-1]["loss"] < want[0]["loss"]
    if name == "granite":
        assert all(m["moe_drop_fraction"] > 0.05 for m in want)


def _final_bounds(arrays: dict, name: str, final: dict) -> dict:
    """Each final leaf's atol: 1e-5, but ``STEPS x LR + 1e-5`` for the
    leaves whose true gradient is zero (`R.zero_grad_leaves`: the key
    bias of each of whisper's attentions, whose reference gradient is
    rounding), where Adam moves by steps of up to the rate with the
    rounding's sign in both packages."""
    if R.SEQ_CASES[name]["arch"] != "whisper-medium":
        return {k: 1e-5 for k in final}   # no leaf takes the bound
    zero = R.zero_grad_leaves(final)
    # the encoder's self, the decoder's self and cross attention
    assert len(zero) == 3, zero
    grads = _part(arrays, f"{name}/grads/")
    scale = max(np.abs(g).max() for g in grads.values())
    for k in zero:   # the rule's premise: their gradient is rounding
        assert np.abs(grads[k]).max() <= 1e-6 * scale, (k, scale)
    wide = R.STEPS * R.LR + 1e-5
    return {k: wide if k in zero else 1e-5 for k in final}


@pytest.mark.parametrize("name", list(R.SEQ_CASES))
def test_seq_gradients_match_reference(jax_seq, port_seq, name):
    """The first step's gradient, summed over the mesh (the leaves whole
    over "model" over it too) and whole, against the reference's."""
    arrays, _ = jax_seq
    want = _part(arrays, f"{name}/grads/")
    for rank, world in enumerate(port_seq):
        got = world[name]["grads"]
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            d = np.abs(got[k] - g)
            bad = d > 1e-6 + 1e-4 * np.abs(g)
            assert not bad.any(), (name, rank, k, float(d.max()))
    assert max(np.abs(g).max() for g in want.values()) > 1e-3


def test_whole_attention_case_keeps_its_attention_whole():
    """The 5-head case: the heads do not split over model=2, so the
    attention computes whole on every rank; its weights are cut at rest
    by the fused 5 x 32 columns (the reference resolver's fall-through)
    and gathered at use, their gradient the reduce-scatter of each
    rank's part under the cut sequence."""
    cfg = R.config(registry, R.SEQ_CASES["heads5"])
    model = registry.build_model(cfg, "meta")
    model.split_(Axis("model", 2, 0))
    attn = model.blocks[0].attn
    assert attn.axis is None and attn.n_heads == 5
    assert attn.cut_at_rest() is not None
    assert tuple(attn.wq.w.shape) == (cfg.d_model, 5 * 32 // 2)
    assert tuple(attn.wo.w.shape) == (5 * 32 // 2, cfg.d_model)
    assert model.blocks[0].ffn.axis is not None


# ---------------------------------------------------------------------------
# serving with the caches cut by sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.SEQ_SERVE))
def test_seq_prefill_and_decode_match_reference(jax_seq, port_seq, name):
    arrays, _ = jax_seq
    want_logits = arrays[f"serve/{name}/logits"]
    want_tokens = arrays[f"serve/{name}/tokens"]
    covered = []
    for rank, world in enumerate(port_seq):
        got = world["serve"][name]
        rows = slice(*got["rows"])
        covered.append(got["rows"])
        np.testing.assert_allclose(got["logits"], want_logits[rows],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} rank {rank}")
        np.testing.assert_array_equal(got["tokens"], want_tokens[rows])
    assert sorted(set(covered)) == [(0, 2), (2, 4)]


@pytest.mark.parametrize("name", list(R.SEQ_SERVE))
def test_seq_cache_is_half_of_the_whole_along_the_sequence(port_seq, name):
    """Every KV cache a rank holds has half the positions of the whole
    one (all its kv heads); the SSM states have no sequence dim and are
    cut by heads as the split model holds them (zamba2's ssm state its
    half of the heads, its conv buffer its half of the x channels and
    all the B/C ones; rwkv6's wkv state its half of the heads, its token
    shifts whole, and no KV cache)."""
    cfg = registry.get_config(R.SEQ_SERVE[name] + "-smoke")
    for world in port_seq:
        got = world["serve"][name]
        kv = [k for k in got["held"]
              if k in ("k", "v", "dec_k", "dec_v", "enc_k", "enc_v")]
        if cfg.family == "ssm":
            assert not got["cuts"] and not kv, got
        else:
            assert got["cuts"] and all(got["cuts"].values()), got["cuts"]
            assert kv, got["held"]
        for key, held in got["held"].items():
            whole = got["whole"][key]
            if key in kv:
                assert held[2] * 2 == whole[2], (key, held, whole)
                assert held[:2] + held[3:] == whole[:2] + whole[3:]
            elif key in ("ssm", "wkv"):
                assert held[2] * 2 == whole[2], (key, held, whole)
                assert held[:2] + held[3:] == whole[:2] + whole[3:]
            elif key == "conv":
                n = 2 * cfg.ssm_state
                assert held[3] == (whole[3] - n) // 2 + n, (held, whole)
                assert held[:3] == whole[:3]
            else:
                assert held == whole, (key, held, whole)


@pytest.mark.parametrize("name", list(R.SEQ_SERVE))
def test_seq_prefill_holds_the_residual_cut(port_seq, name):
    """The prefill under the rule gathers its residual (every block's
    normed input, and whisper's encoder frames), so between blocks a
    rank held its slice of the prompt."""
    cfg = registry.get_config(R.SEQ_SERVE[name] + "-smoke")
    layers = (cfg.enc_layers + cfg.dec_layers if cfg.family == "audio"
              else cfg.num_layers)
    for world in port_seq:
        assert world["serve"][name]["prefill_gathers"] >= layers, name


# ---------------------------------------------------------------------------
# the remat carry is the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", list(R.SEQ_LIVENESS))
def test_no_whole_residual_outlives_its_block(port_seq, remat):
    for world in port_seq:
        live = world["liveness"][remat]
        # each block gathers its normed input once or twice a forward
        assert live["gathers"] >= 2 * live["layers"] * 2, live
        # when the forward returns, only the head's input is whole
        assert live["after_forward"] == [1, 1], live
        # a block's two gathered inputs and the one before it at most
        assert 0 < live["most"] <= 3, live


# ---------------------------------------------------------------------------
# the two Functions
# ---------------------------------------------------------------------------

def test_gather_seq_is_all_gather_then_reduce_scatter_sum(port_seq):
    seen = set()
    for world in port_seq:
        got = world["collectives"]
        i = got["index"]
        seen.add(i)
        parts, weights, _ = got["inputs"]
        y, grad = got["gather"]
        np.testing.assert_array_equal(y, np.concatenate(parts, axis=1))
        want = np.split(sum(weights), len(parts), axis=1)[i]
        np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)
    assert seen == {0, 1}


def test_reduce_scatter_seq_is_reduce_scatter_then_all_gather(port_seq):
    for world in port_seq:
        got = world["collectives"]
        i = got["index"]
        _, weights, halves = got["inputs"]
        w, grad = got["scatter"]
        want = np.split(sum(weights), len(weights), axis=1)[i]
        np.testing.assert_allclose(w, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(grad, np.concatenate(halves, axis=1))


# ---------------------------------------------------------------------------
# the dry run's tally under the rule
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq_tally_fake():
    [fake] = run_ranks(R.seq_tally_fake, 1, threads=1,
                       timeout_s=WORLD_TIMEOUT_S)
    return fake


def test_seq_dry_run_calls_equal_the_real_ranks(seq_tally_fake, port_seq):
    want = port_seq[0]["tally"]
    got = seq_tally_fake["meta"]
    assert got["held"] == want["held"]
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"]
    # the sequence's gathers and reduce-scatters are "model" calls
    ops = want["collectives"]["per_op"]
    assert ops["reduce_scatter_tensor"]["count"] > 0
    assert want["collectives"]["per_axis"]["model"]["count"] > 0
    for other in port_seq[1:]:
        assert other["tally"]["collectives"] == want["collectives"]


def test_seq_tally_on_real_tensors_equals_meta(seq_tally_fake):
    meta, real = seq_tally_fake["meta"], seq_tally_fake["cpu"]
    assert real["peak"] == meta["peak"]
    assert real["collectives"] == meta["collectives"]
    assert real["held"] == meta["held"]


# ---------------------------------------------------------------------------
# what the reference does with heads the model axis does not divide
# ---------------------------------------------------------------------------

JAX_UNEVEN_HEADS = textwrap.dedent("""
    import json, types
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.sharding import (DEFAULT_PARAM_RULES,
                                            ShardingContext, param_shardings,
                                            use_sharding)
    from repro.launch.mesh import make_host_mesh
    from repro.nn.attention import Attention
    from repro.nn.module import split_params

    # the resolver at 16 x 16: qwen1.5-4b's wq (20 heads x 128 columns)
    grid = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))
    ctx = ShardingContext(grid, DEFAULT_PARAM_RULES, DEFAULT_PARAM_RULES)
    wq20 = ctx.resolve(("embed", "heads"), DEFAULT_PARAM_RULES,
                       shape=(2560, 20 * 128))
    # 5 heads x 8 columns on a model axis of 4: 1.25 heads a device
    mesh = make_host_mesh(4, shape=(1, 4))
    att = Attention(64, 5, 5, 8, rope=False)
    params = split_params(att.init(jax.random.PRNGKey(0)))[0]
    with use_sharding(mesh):
        sh = param_shardings(att.axes(), kind="param", specs_tree=params)
    hlo = jax.jit(lambda p, x: att(p, x),
                  in_shardings=(sh, NamedSharding(mesh, P()))).lower(
        params, jnp.ones((2, 16, 64))).compile().as_text()
    print("UNEVEN", json.dumps({
        "wq20": [str(e) for e in wq20], "wq5": [str(e) for e in sh["wq"]["w"].spec],
        "ops": {k: hlo.count(k) for k in ("pad(", "all-gather",
                                           "all-reduce", "all-to-all")}}))
""")


def test_reference_cuts_uneven_heads_at_rest_and_gathers_them():
    """The reference's resolver sees the fused heads x head_dim columns,
    which the model axis divides: a 20-head wq at model 16 is cut 16 ways
    (1.25 heads a device), not replicated, and GSPMD all-gathers around
    the head reshape (no pad in the compiled program of a 5-head layer
    at model 4).  The port cuts such attention's weights the same way at
    rest and gathers them whole at use."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", JAX_UNEVEN_HEADS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "UNEVEN" in res.stdout, (res.stdout[-2000:], res.stderr[-3000:])
    got = json.loads(res.stdout.split("UNEVEN", 1)[1])
    print(got)
    assert got["wq20"] == ["data", "model"]
    assert got["wq5"] == ["data", "model"]
    assert got["ops"]["pad("] == 0 and got["ops"]["all-gather"] > 0
    model = registry.build_model(registry.get_config("qwen1.5-4b"), "meta")
    model.blocks[0].split_(Axis("model", 16, 0))
    attn = model.blocks[0].attn
    assert attn.axis is None   # computed whole on every model rank
    assert attn.cut_at_rest() is not None   # cut at rest as the reference
    assert tuple(attn.wq.w.shape) == (2560, 20 * 128 // 16)
