"""The port's LM train step against the JAX package, arch by arch, on
the CPU: the dense decoders here (qwen1.5-4b, qwen2.5-32b,
command-r-plus-104b, deepseek-7b, phi-3-vision-4.2b), the other families
in `test_torch_lm_train_families.py`, each at its ``-smoke`` config.

Both packages start from the reference's initial parameters
(``split_params(model.init(PRNGKey(0)))[0]``, carried with
`load_jax_lm_params` into a model built for the test) and take the same
numpy batch (seeded tokens; phi-3-vision's patch embeddings, whisper's
frame embeddings) with AdamW(1e-3), as `tests/test_arch_smoke.py` does.

* Three steps of `repro_torch.train.train_loop.make_train_step` against
  ``jax.jit(make_train_step(...))``: losses rtol 1e-5 at step 1 and
  1e-4 after (Adam amplifies an ulp of a gradient near zero: at step 1
  ``m / sqrt(v)`` is the gradient's sign); the metric keys and step 1's
  values (tokens, the MoE terms) 1e-5.
* Step-1 gradients (the raw ``.grad``, restacked by `stack_lm_tree`)
  against those the reference's step hands its optimizer (read through
  an identity ``grad_compression``), element by element:
  ``|d| <= 1e-6 + 1e-4 * |g|``.  An element that misses the rule is
  judged against the reference's gradient in float64 (its loss under
  ``jax.enable_x64`` with compute_dtype float64 and its ``jnp.float32``
  casts read as float64, so that every sum is float64): the miss is let
  pass only where the reference itself is off that gradient by more
  than the rule and the port is no further from it than the reference
  plus the rule, and at most `MAX_MISSES` elements of a leaf.  Then the
  miss is the reference's fp32 summation order in a leaf of large
  entries that cancel (rwkv6's ``bonus_u``: entries up to 12, one
  element at 6.3e-4 with the reference 6.2e-6 and the port 3.3e-6 off
  float64).  Misses are counted and printed.
* ``n_microbatches=2`` against the reference's microbatched step (2
  steps, batch 4; step-1 gradients its accumulated ones, the
  microbatches' summed and multiplied by 1 / 2): qwen1.5-4b here,
  granite-moe-3b-a800m there (its capacity drops and load-balance loss
  are per microbatch, so not the whole batch's gradient).
* `make_eval_step`'s metrics against the reference's, rtol 1e-5.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as j_registry
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_loop

from repro_torch.models import registry
from repro_torch.nn import layers as t_layers
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_loop
from test_torch_lm import lm_pair

DENSE = ["qwen1.5-4b", "qwen2.5-32b", "command-r-plus-104b", "deepseek-7b",
         "phi-3-vision-4.2b"]
LR = 1e-3


def batch_np(cfg, batch=2, seq=32, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(batch, seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def pair(arch: str):
    """(reference model, its initial tree, a fresh port model loaded from
    it, cfg): the port's model is built here, since the train step
    updates it in place (the `lm_pair` cache's stays untouched)."""
    ref, tree, _, cfg = lm_pair(arch + "-smoke")
    model = t_layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                        tree)
    return ref, tree, model, cfg


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# the reference's modules whose `jnp.float32` casts keep fp32 sums in a
# float64 run; `reference_float64_grads` reads them as float64
F64_MODULES = ("repro.nn.layers", "repro.nn.attention", "repro.nn.moe",
               "repro.nn.ssm", "repro.nn.transformer", "repro.models.rwkv",
               "repro.models.zamba", "repro.models.whisper",
               "repro.train.train_loop")
# misses of the rule a leaf may hold, each judged by float64 (there is
# one today, in rwkv6's bonus_u)
MAX_MISSES = 2


class _Float64Numpy:
    """`jax.numpy` with `float32` read as `float64`."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def reference_float64_grads(arch: str, tree, batch: dict,
                            n_micro: int = 1, cfg=None) -> dict:
    """The reference's gradient of the same loss in float64 throughout
    (with microbatches, the mean of theirs): independent of the port.
    `cfg`: the reference's config to run (``arch``'s smoke config by
    default)."""
    mods = [importlib.import_module(m) for m in F64_MODULES]
    cfg = dataclasses.replace(cfg or j_registry.get_config(arch + "-smoke"),
                              compute_dtype="float64")
    saved = [m.jnp for m in mods]
    with jax.enable_x64(True):
        try:
            for m in mods:
                m.jnp = _Float64Numpy()
            loss_fn = j_loop.make_loss_fn(j_registry.build_model(cfg), cfg)
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tree)
            grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
            rows = len(batch["tokens"]) // n_micro
            total = None
            for i in range(n_micro):
                mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows],
                                     jnp.float64 if v.dtype.kind == "f"
                                     else v.dtype)
                      for k, v in batch.items()}
                g = leaves(grad(params, mb))
                total = g if total is None else {
                    k: total[k] + g[k] for k in g}
        finally:
            for m, j in zip(mods, saved):
                m.jnp = j
    return {k: v / n_micro for k, v in total.items()}


def reference_step(ref, opt, n_micro: int):
    """``jax.jit`` of the reference's `make_train_step`, also returning
    the gradients its optimizer is handed (read through an identity
    ``grad_compression``: with microbatches, their sum times 1 / n)."""
    def step(params, opt_state, batch):
        seen = {}

        def spy(grads):
            seen["grads"] = grads
            return grads

        out = j_loop.make_train_step(ref, ref.cfg, opt,
                                     n_microbatches=n_micro,
                                     grad_compression=spy)(
            params, opt_state, batch)
        return (*out, seen["grads"])

    return jax.jit(step)


def check_grads(got: dict, want: dict, judge, label: str) -> int:
    """The step-1 gradient rule (module docstring); `judge()` gives the
    reference's float64 gradients.  Returns the misses it let pass."""
    assert got.keys() == want.keys()
    g64, misses = None, 0
    for k in want:
        w, g = want[k], got[k]
        bad = np.abs(g - w) > 1e-6 + 1e-4 * np.abs(w)
        if not bad.any():
            continue
        if g64 is None:
            g64 = judge()
        t = g64[k]
        rule = 1e-6 + 1e-4 * np.abs(t)
        off = np.abs(w - t)
        ok = (off > rule) & (np.abs(g - t) <= off + rule)
        assert ok[bad].all(), (
            f"{label} {k}: {int((bad & ~ok).sum())} gradient elements off "
            f"the reference where it is within the rule of float64, or "
            f"the port is further from float64 than the reference plus "
            f"the rule")
        assert bad.sum() <= MAX_MISSES, (
            f"{label} {k}: {int(bad.sum())} gradient elements miss the "
            f"rule (at most {MAX_MISSES} a leaf)")
        misses += int(bad.sum())
        print(f"{label} {k}: {int(bad.sum())} of {bad.size} elements miss "
              f"the rule, each where the reference is off float64 by more "
              f"than the rule and the port is no further than it")
    return misses


def run_steps(arch: str, *, steps: int = 3, n_micro: int = 1,
              batch: int = 2):
    """(the reference's metrics a step, the port's, the reference's
    step-1 gradients, the port's)."""
    ref, tree, model, cfg = pair(arch)
    b = batch_np(cfg, batch=batch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jopt, topt = j_opt.AdamW(learning_rate=LR), t_opt.AdamW(learning_rate=LR)
    jstep = reference_step(ref, jopt, n_micro)
    tstep = t_loop.make_train_step(model, cfg, topt,
                                   n_microbatches=n_micro)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = dict(model.named_parameters())
    ts = topt.init(tp)
    j_metrics, t_metrics = [], []
    for step in range(steps):
        jp, js, jm, jg = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        j_metrics.append({k: float(v) for k, v in jm.items()})
        t_metrics.append({k: float(v) for k, v in tm.items()})
        if step == 0:
            j_grads = leaves(jg)
            t_grads = leaves(t_layers.stack_lm_tree(
                {k: p.grad for k, p in tp.items()}))
    return j_metrics, t_metrics, j_grads, t_grads


def check_run(arch: str, **kw) -> None:
    j_metrics, t_metrics, j_grads, t_grads = run_steps(arch, **kw)
    assert set(t_metrics[0]) == set(j_metrics[0])
    for step, (jm, tm) in enumerate(zip(j_metrics, t_metrics)):
        assert np.isfinite(tm["loss"])
        np.testing.assert_allclose(tm["loss"], jm["loss"],
                                   rtol=1e-5 if step == 0 else 1e-4,
                                   err_msg=f"{arch} step {step + 1}")
    for k in ("total_loss", "tokens", "moe_lb_loss", "moe_z_loss",
              "moe_drop_fraction", "grad_norm", "learning_rate"):
        np.testing.assert_allclose(t_metrics[0][k], j_metrics[0][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert t_metrics[-1]["loss"] < t_metrics[0]["loss"]
    _, tree, _, cfg = lm_pair(arch + "-smoke")
    b = batch_np(cfg, batch=kw.get("batch", 2))
    check_grads(t_grads, j_grads,
                lambda: reference_float64_grads(arch, tree, b,
                                                kw.get("n_micro", 1)),
                arch)


def check_eval(arch: str) -> None:
    ref, tree, model, cfg = pair(arch)
    b = batch_np(cfg, seed=3)
    want = jax.jit(j_loop.make_eval_step(ref, ref.cfg))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()})
    got = t_loop.make_eval_step(model, cfg)(
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference(arch):
    check_run(arch)


def test_microbatched_step_matches_reference():
    check_run("qwen1.5-4b", steps=2, n_micro=2, batch=4)


@pytest.mark.parametrize("arch", DENSE)
def test_eval_step_matches_reference(arch):
    check_eval(arch)


def test_microbatches_must_split_the_batch():
    _, _, model, cfg = pair("qwen1.5-4b")
    step = t_loop.make_train_step(model, cfg, t_opt.AdamW(), n_microbatches=2)
    params = dict(model.named_parameters())
    b = {k: torch.from_numpy(v) for k, v in batch_np(cfg, batch=3).items()}
    with pytest.raises(ValueError, match="does not split into 2"):
        step(params, t_opt.AdamW().init(params), b)


def test_gradient_judge_refuses_a_wrong_leaf():
    """A wrong term in one leaf of the port's gradient fails the rule,
    and the float64 judge, the reference's, does not let it pass."""
    _, _, j_grads, t_grads = run_steps("qwen1.5-4b", steps=1)
    _, tree, _, cfg = lm_pair("qwen1.5-4b-smoke")
    b = batch_np(cfg)
    judge = lambda: reference_float64_grads("qwen1.5-4b", tree, b)  # noqa
    assert check_grads(t_grads, j_grads, judge, "qwen1.5-4b") == 0
    g64 = judge()
    for k in g64:
        assert g64[k].dtype == np.float64
        np.testing.assert_allclose(g64[k], j_grads[k], rtol=1e-3, atol=1e-6)
    key = "['blocks']['attn']['wq']['w']"
    wrong = dict(t_grads, **{key: t_grads[key] * (1 + 1e-3)})
    with pytest.raises(AssertionError, match="off the reference"):
        check_grads(wrong, j_grads, judge, "qwen1.5-4b")
