"""Tensor parallelism for rwkv6, zamba2 and whisper on the port's mesh,
against the JAX package, on the CPU.

The reference's rules put these families' "heads" and "mlp" leaves on
"model", so its GSPMD program cuts Mamba2 by its fused projection and
the RWKV6 mixes and Whisper's attention and MLPs over that axis.  The
port splits them by heads (`split_`): Mamba2 by SSM heads with B and C
held on every rank, RWKV6's time mix by heads and its channel mix by
hidden width, Whisper's blocks as the decoder's; the gated norm and
RWKV6's ``ln_x`` take their statistics over the axis.  Two JAX
subprocesses side by side (4 host devices each, a (data=2, model=2)
mesh; `JAX_SPLIT` shares the cases between them) run the
reference's ``make_train_step(plan=, zero1=True)`` for 3 steps on each
case of `torch_lm_mesh_ranks.TP_CASES` (rwkv6-3b; zamba2-1.2b; zamba2
under ``"seq": "model"`` with remat "layer", two microbatches and an
uneven mask, placed by FSDP on the port's side; whisper-medium over 32
frames; and two uneven splits as the reference's resolver takes them:
granite-moe with 3 experts cut by their hidden width and 3 query heads
over 1 kv head cut at rest by fused columns, placed, and rwkv6 with 3
heads of 32, its time mix by value columns with its weights cut at
rest), the gradient of the first step (the float64 judge runs each
case's own config), and the jitted prefill and greedy decode of the
three smoke models and of rwkv6 with 3 heads of 32 under the mesh.  One 4-rank
gloo world runs the port on the same initial parameters:

* (a) the step: per-step metrics and whole final parameters at rtol
  1e-4 / atol 1e-5 on every rank, all at the default lr 1e-4; the one
  exception is the leaves whose true gradient is zero (the key biases
  of whisper's three attentions, `torch_lm_mesh_ranks.zero_grad_leaves`):
  their reference gradient is rounding, which Adam turns into steps of
  up to the rate, so they are held to ``steps x lr + 1e-5``;
* (b) the first step's gradient, whole, within ``1e-6 + 1e-4 |g|`` of
  the reference's, an element that misses judged by the reference's
  float64 gradient (at most `MAX_MISSES` a leaf, as
  `tests/test_torch_lm_train_arch.py` judges them);
* (c) prefill and decode: logits at rtol 1e-4 / atol 1e-5 and greedy
  tokens equal, each cache a rank holds cut by heads (rwkv6's with 3
  heads of 32 by value columns);
* (d) each split leaf holds its share, the fused ``in_proj`` its heads'
  share plus B and C, and `gather_params` rebuilds the whole tree bit
  for bit;
* (e) one split `LayerNorm` against the whole one, forward and
  backward, on 2 gloo ranks;
* (f) the dry run's trace of the zamba2 smoke step (placed, under the
  rule) on rank 0 of a fake world of 4: its calls and bytes per op and
  per axis equal the real ranks'.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_mesh_ranks as R  # noqa: E402 — its directory is on the path

from repro_torch.distributed.launch import run_ranks  # noqa: E402
from repro_torch.models import registry  # noqa: E402

WORLD_TIMEOUT_S = 300

JAX_TP = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_launch_ranks as L
    import torch_lm_mesh_ranks as R
    import jax, jax.numpy as jnp
    from repro.distributed import partition
    from repro.distributed.sharding import use_sharding
    from repro.launch.mesh import make_host_mesh
    from repro.models import registry
    from repro.nn.module import split_params
    from repro.train import optimizer as opt
    from repro.train import train_loop

    assert jax.device_count() == 4, jax.devices()
    mesh = make_host_mesh(4, shape=(2, 2))
    arrays, runs = {{}}, {{}}

    def save(prefix, tree):
        for k, v in R.flatten(jax.tree_util.tree_map(np.asarray,
                                                     tree)).items():
            arrays[f"{{prefix}}/{{k}}"] = v

    for name in {names!r}:
        case = R.TP_CASES[name]
        plan = partition.plan_for(mesh, act_rules=R.TP_RULES.get(name))
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
        o = opt.AdamW(learning_rate=case.get("lr", R.LR))
        step = train_loop.make_train_step(
            model, cfg, o, plan=plan, zero1=True,
            n_microbatches=case["n_micro"])
        state = o.init(params)
        runs[name] = []
        for _ in range(R.STEPS):
            params, state, m = step(params, state, batch)
            runs[name].append({{k: float(v) for k, v in m.items()}})
        save(f"{{name}}/final", params)

    for name in (R.TP_SERVE if {serve!r} else ()):
        cfg = R.tp_serve_config(registry, name)
        model = registry.build_model(cfg)
        params = split_params(model.init(jax.random.PRNGKey(2)))[0]
        save(f"serve/{{name}}/init", params)
        inputs = {{k: jnp.asarray(v)
                  for k, v in R.seq_serve_inputs(cfg).items()}}
        extras = {{k: v for k, v in inputs.items() if k != "tokens"}}
        max_len = L.SERVE_PROMPT + L.SERVE_STEPS + cfg.num_patches
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
    np.savez({out!r}, **arrays)
    print("JAX_TP", json.dumps(runs))
""")


def _part(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


# the reference's cases in two subprocesses run side by side (each
# case's compile is most of its time), the serving with the second
JAX_SPLIT = (("rwkv", "zamba", "zamba_seq", "granite_uneven"),
             ("whisper", "rwkv_uneven"))


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    assert sorted(sum(JAX_SPLIT, ())) == sorted(R.TP_CASES)
    tmp = tmp_path_factory.mktemp("jax_tp")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = []
    for i, names in enumerate(JAX_SPLIT):
        out = tmp / f"run{i}.npz"
        script = JAX_TP.format(tests=tests, out=str(out), names=names,
                               serve=i == len(JAX_SPLIT) - 1)
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", script], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    arrays, runs = {}, {}
    try:
        for out, proc in procs:
            stdout, stderr = proc.communicate(timeout=500)
            assert "JAX_TP" in stdout, (stdout[-2000:], stderr[-3000:])
            runs.update(json.loads(stdout.split("JAX_TP", 1)[1]))
            with np.load(out) as data:
                arrays.update({k: data[k] for k in data.files})
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return arrays, runs


@pytest.fixture(scope="module")
def port_tp(jax_tp):
    arrays, _ = jax_tp
    initial = {name: _part(arrays, f"{name}/init/") for name in R.TP_CASES}
    serve = {name: _part(arrays, f"serve/{name}/init/")
             for name in R.TP_SERVE}
    return run_ranks(R.tp_world, 4, args=(initial, serve), threads=1,
                     timeout_s=WORLD_TIMEOUT_S)


# ---------------------------------------------------------------------------
# (a) the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.TP_CASES))
def test_tp_step_matches_reference(jax_tp, port_tp, name):
    arrays, runs = jax_tp
    initial = _part(arrays, f"{name}/init/")
    final = _part(arrays, f"{name}/final/")
    want = runs[name]
    assert len(want) == R.STEPS
    bounds = _final_bounds(arrays, name, final)
    for rank, world in enumerate(port_tp):
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
            for k, v in port_tp[0][name]["params"].items():
                np.testing.assert_array_equal(got["params"][k], v)
        # the model is split: no rank holds all of it
        assert got["whole_leaves"] != sorted(got["params"]), name
    assert max(np.abs(final[k] - initial[k]).max() for k in final) > 1e-5
    assert want[-1]["loss"] < want[0]["loss"]


def _final_bounds(arrays: dict, name: str, final: dict) -> dict:
    """Each final leaf's atol: 1e-5, but ``STEPS x lr + 1e-5`` for the
    leaves whose true gradient is zero (`R.zero_grad_leaves`: the key
    bias of each of whisper's attentions, whose reference gradient is
    rounding), where Adam moves by steps of up to the rate with the
    rounding's sign in both packages."""
    zero = R.zero_grad_leaves(final)
    case = R.TP_CASES[name]
    # whisper's encoder self, decoder self and decoder cross attention;
    # no other case has a key bias, so no other leaf takes the bound
    assert len(zero) == (3 if case["arch"] == "whisper-medium" else 0), zero
    assert all(".wk." in k and "attn" in k for k in zero), zero
    grads = _part(arrays, f"{name}/grads/")
    scale = max(np.abs(g).max() for g in grads.values())
    for k in zero:   # the rule's premise: their gradient is rounding
        assert np.abs(grads[k]).max() <= 1e-6 * scale, (k, scale)
    wide = R.STEPS * case.get("lr", R.LR) + 1e-5
    return {k: wide if k in zero else 1e-5 for k in final}


# ---------------------------------------------------------------------------
# (b) the first gradient
# ---------------------------------------------------------------------------

def _dotted(key: str) -> str:
    """A `jax.tree_util.keystr` path as the flat trees' dotted key."""
    return ".".join(re.findall(r"\['([^']*)'\]", key))


@pytest.mark.parametrize("name", list(R.TP_CASES))
def test_tp_gradients_match_reference(jax_tp, port_tp, name):
    """The first step's gradient, summed over the mesh and whole, within
    the rule of the reference's; a miss judged by its float64 run."""
    from test_torch_lm_train_arch import check_grads, reference_float64_grads
    arrays, _ = jax_tp
    want = _part(arrays, f"{name}/grads/")
    case = R.TP_CASES[name]
    cfg = R.config(registry, case)

    def judge():
        from repro.models import registry as j_registry
        g64 = reference_float64_grads(
            case["arch"], R.nest(_part(arrays, f"{name}/init/")),
            R.batch_np(cfg, case), case["n_micro"],
            cfg=R.config(j_registry, case))
        return {_dotted(k): v for k, v in g64.items()}

    for rank, world in enumerate(port_tp):
        check_grads(world[name]["grads"], want, judge, f"{name} rank {rank}")
    assert max(np.abs(g).max() for g in want.values()) > 1e-3


# ---------------------------------------------------------------------------
# (c) serving on the split model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.TP_SERVE))
def test_tp_prefill_and_decode_match_reference(jax_tp, port_tp, name):
    arrays, _ = jax_tp
    want_logits = arrays[f"serve/{name}/logits"]
    want_tokens = arrays[f"serve/{name}/tokens"]
    covered = []
    for rank, world in enumerate(port_tp):
        got = world["serve"][name]
        rows = slice(*got["rows"])
        covered.append(got["rows"])
        np.testing.assert_allclose(got["logits"], want_logits[rows],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} rank {rank}")
        np.testing.assert_array_equal(got["tokens"], want_tokens[rows])
    assert sorted(set(covered)) == [(0, 2), (2, 4)]


# the dim of each cache leaf cut by heads (kv heads; Mamba2's conv
# buffer by its channels)
CACHE_HEAD_DIMS = {"wkv": 2, "ssm": 2, "k": 3, "v": 3, "dec_k": 3,
                   "dec_v": 3, "enc_k": 3, "enc_v": 3, "conv": 3}


@pytest.mark.parametrize("name", list(R.TP_SERVE))
def test_tp_caches_are_cut_by_heads(port_tp, name):
    """Each cache a rank holds is its half of the heads (the conv buffer
    its x channels and all the B/C ones; rwkv6's wkv state, where its
    heads do not split, its half of every head's value columns, as the
    reference's resolver cuts it); nothing is cut by sequence (the rules
    leave "seq" whole); token shifts stay whole."""
    cfg = R.tp_serve_config(registry, name)
    heads = cfg.d_model // cfg.ssm_head_dim if cfg.family == "ssm" else 0
    dims = dict(CACHE_HEAD_DIMS, wkv=2 if heads % 2 == 0 else 4)
    for world in port_tp:
        got = world["serve"][name]
        assert not any(got["cuts"].values()), got["cuts"]
        assert set(got["held"]) & set(CACHE_HEAD_DIMS), got["held"]
        for key, held in got["held"].items():
            whole = got["whole"][key]
            dim = dims.get(key)
            if dim is None:
                assert held == whole, (key, held, whole)
                continue
            n = 2 * cfg.ssm_state
            want = ((whole[dim] - n) // 2 + n if key == "conv"
                    else whole[dim] // 2)
            assert held[dim] == want, (key, held, whole)
            assert held[:dim] + held[dim + 1:] == whole[:dim] + whole[dim + 1:]


# ---------------------------------------------------------------------------
# (d) the split leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.TP_SERVE))
def test_split_leaves_hold_their_share(port_tp, name):
    cfg = R.tp_serve_config(registry, name)
    for world in port_tp:
        got = world["leaves"][name]
        split = [k for k, d in got["model_dims"].items() if d >= 0]
        assert split, name
        for k in got["whole"]:
            whole, held, dim = got["whole"][k], got["held"][k], \
                got["model_dims"][k]
            if dim < 0:
                assert held == whole, k
                continue
            assert held[:dim] + held[dim + 1:] == \
                whole[:dim] + whole[dim + 1:], k
            if k in got["fused"]:
                pieces = got["fused"][k][1]
                assert sum(w for w, _ in pieces) == whole[dim], k
                assert held[dim] == sum(w // 2 if cut else w
                                        for w, cut in pieces), k
            else:
                assert held[dim] * 2 == whole[dim], k
        assert sorted(got["gathered_equal"]) == sorted(got["whole"])
        assert sorted(got["part_equal"]) == sorted(got["whole"])
    if name == "zamba":
        got = port_tp[0]["leaves"][name]
        di, n, h = 2 * cfg.d_model, cfg.ssm_state, \
            2 * cfg.d_model // cfg.ssm_head_dim
        key = "mamba.0.mamba.in_proj.w"
        # the heads' z, x and dt, and all of B and C
        assert got["held"][key][1] == di // 2 * 2 + 2 * n + h // 2
        assert got["dup"][key] == (1, [(di, di + n), (di + n, di + 2 * n)])
        assert "mamba.0.mamba.A_log" in got["partial"]
    if name in ("rwkv", "rwkv_uneven"):
        got = port_tp[0]["leaves"][name]
        assert "blocks.0.tm.bonus_u" in got["partial"]
        assert got["model_dims"]["blocks.0.cm.r.w"] == 1
        # by value columns: v and g cut at rest by fused columns, o by rows
        assert got["model_dims"]["blocks.0.tm.v.w"] == 1
        assert got["model_dims"]["blocks.0.tm.o.w"] == 0


# ---------------------------------------------------------------------------
# (e) the cross-rank norm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_norm():
    return run_ranks(R.split_norm_case, 2, threads=1,
                     timeout_s=WORLD_TIMEOUT_S)


def test_split_layernorm_matches_whole(split_norm):
    seen = set()
    for got in split_norm:
        i = got["index"]
        seen.add(i)
        whole, split = got["whole"], got["split"]
        cols = slice(24 * i, 24 * (i + 1))
        np.testing.assert_allclose(split["y"], whole["y"][..., cols],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(split["x_grad"],
                                   whole["x_grad"][..., cols],
                                   rtol=1e-5, atol=1e-6)
        for k in ("scale_grad", "bias_grad"):
            np.testing.assert_allclose(split[k], whole[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        # a rank's half of the channels alone would normalize otherwise
        x = got["x"][..., cols]
        alone = (x - x.mean(-1, keepdims=True)) / np.sqrt(
            x.var(-1, keepdims=True) + 1e-5)
        whole_x = got["x"]
        normed = ((whole_x - whole_x.mean(-1, keepdims=True)) / np.sqrt(
            whole_x.var(-1, keepdims=True) + 1e-5))[..., cols]
        assert np.abs(alone - normed).max() > 1e-2
    assert seen == {0, 1}


# ---------------------------------------------------------------------------
# (f) the dry run's tally of a split zamba2 step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_tally_fake():
    [fake] = run_ranks(R.tp_tally_fake, 1, threads=1,
                       timeout_s=WORLD_TIMEOUT_S)
    return fake


def test_tp_dry_run_calls_equal_the_real_ranks(tp_tally_fake, port_tp):
    want = port_tp[0]["tally"]
    assert tp_tally_fake["held"] == want["held"]
    assert tp_tally_fake["collectives"] == want["collectives"]
    assert tp_tally_fake["flops"] == want["flops"]
    per_axis = want["collectives"]["per_axis"]
    assert per_axis["model"]["count"] > 0 and per_axis["data"]["count"] > 0
    for other in port_tp[1:]:
        assert other["tally"]["collectives"] == want["collectives"]
