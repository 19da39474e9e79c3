"""Gradient compression in the port's train steps, against the JAX
package, on the CPU.

The mesh cases run in the 4-rank world of `tests/test_torch_lm_mesh.py`
(its one JAX subprocess runs the reference's compressed mesh step and
its compressors on whole stacked trees; `torch_lm_mesh_ranks.
COMPRESS_CASES` and `COMPRESS_PIECES`): the compressor on every kind of
slice bit for bit, the compressed step under the code rule, and the
`all_max` calls a step.  This file holds what needs no world:

* the one-device step with `compress_int8_stateless` against the
  reference's (`jax.jit(make_train_step(..., grad_compression=))`) on a
  two-layer model: the scale of a layer's leaf is its stack's (the
  reference compresses its stacked ``[L, ...]`` leaves), held by the
  code rule of `torch_lm_mesh_ranks.code_misses` for 3 steps;
* `stacked_max` against the maximum of the stacked leaf;
* a bound compressor sizes its residual from the first gradient it
  sees, a residual of another shape raises, and a world-of-one mesh
  step hands a foreign ``grads -> grads`` callable the gradients as
  they are.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_mesh_ranks as R  # noqa: E402 — its directory is on the path

from repro_torch.distributed import compression, partition  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

CASE = R.CASES["qwen"]


def _reference_run(init: dict) -> tuple:
    """The reference's jitted one-device step with
    ``compress_int8_stateless`` from `init` (the reference's tree):
    per-step metrics, each step's gradient before the compression, and
    the final parameters (flat trees)."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as j_comp
    from repro.models import registry as j_registry
    from repro.train import optimizer as j_opt
    from repro.train import train_loop as j_loop
    cfg = R.config(j_registry, CASE)
    model = j_registry.build_model(cfg)
    caught = []

    def catching(grads):
        jax.debug.callback(lambda g: caught.append(
            jax.tree_util.tree_map(np.asarray, g)), grads)
        return j_comp.compress_int8_stateless(grads)

    o = j_opt.AdamW(learning_rate=R.LR)
    step = jax.jit(j_loop.make_train_step(
        model, cfg, o, n_microbatches=CASE["n_micro"],
        grad_compression=catching))
    params = jax.tree_util.tree_map(jnp.asarray, R.nest(init))
    state = o.init(params)
    batch = {k: jnp.asarray(v) for k, v in R.batch_np(cfg, CASE).items()}
    metrics = []
    for _ in range(R.STEPS):
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    jax.effects_barrier()
    assert len(caught) == R.STEPS
    return (metrics, [R.flatten(g) for g in caught],
            R.flatten(jax.tree_util.tree_map(np.asarray, params)))


def _port_run(init: dict) -> tuple:
    """The port's one-device step with ``compress_int8_stateless``:
    per-step metrics, each step's gradient before and after the
    compression, and the final parameters (flat stacked trees)."""
    cfg = R.config(registry, CASE)
    model = layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      R.nest(init))
    seen = []
    real = compression.compress_int8_stateless

    def compress(grads, *, max_over=None):
        out = real(grads, max_over=max_over)
        seen.append(tuple(R.flatten(layers.stack_lm_tree(
            {k: v.detach() for k, v in tree.items()}))
            for tree in (grads, out)))
        return out

    opt = t_opt.AdamW(learning_rate=R.LR)
    # the spy stands in for the stateless compressor (the step hands it
    # the stack's scale as it would the compressor)
    compression.compress_int8_stateless = compress
    try:
        step = train_loop.make_train_step(
            model, cfg, opt, n_microbatches=CASE["n_micro"],
            grad_compression=compress)
        params = dict(model.named_parameters())
        state = opt.init(params, layers.stack_groups(params))
        batch = {k: torch.from_numpy(v)
                 for k, v in R.batch_np(cfg, CASE).items()}
        metrics = []
        for _ in range(R.STEPS):
            params, state, m = step(params, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        compression.compress_int8_stateless = real
    return metrics, seen, R.flatten(layers.stack_lm_tree(params))


def test_one_device_compressed_step_matches_reference():
    from test_torch_lm_train_arch import MAX_MISSES
    cfg = R.config(registry, CASE)
    assert cfg.num_layers > 1   # a stack's scale differs from a layer's
    init = R.flatten(layers.stack_lm_tree(dict(layers.init_params(
        registry.build_model(cfg, "cpu"), 0).named_parameters())))
    want, caught, final = _reference_run(init)
    got, seen, params = _port_run(init)
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {step + 1} {k}")
    differed = {}
    for step, (x_ref, (x_got, out_got)) in enumerate(zip(caught, seen)):
        for k, miss in R.code_misses(x_ref, x_got, out_got,
                                     f"step {step + 1}",
                                     MAX_MISSES if step == 0
                                     else None).items():
            differed[k] = differed.get(k, False) | miss
    R.final_within(params, final, differed, "one device")
    assert want[-1]["loss"] < want[0]["loss"]


def test_stacked_max_is_the_stacks_maximum():
    rng = np.random.default_rng(3)
    tree = {"blocks.0.attn.wq.w": rng.standard_normal((4, 3)),
            "blocks.1.attn.wq.w": 5 * rng.standard_normal((4, 3)),
            "blocks.0.norm1.scale": rng.standard_normal(4),
            "blocks.1.norm1.scale": rng.standard_normal(4),
            "final_norm.scale": rng.standard_normal(4)}
    amax = {k: torch.tensor(np.abs(v).max(), dtype=torch.float32)
            for k, v in tree.items()}
    got = compression.stacked_max(amax, layers.stack_groups(list(tree)))
    stacked = R.stack_np(tree)
    for key, members in layers.stack_groups(list(tree)).items():
        for k in [members] if isinstance(members, str) else members:
            assert got[k].item() == np.float32(np.abs(stacked[key]).max())


def test_bound_compressor_sizes_its_residual_from_the_first_gradient():
    comp = compression.ErrorFeedbackCompressor()
    grads = {"a": torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5)).astype(np.float32))}
    bound = comp.bind()
    assert bound.state is None
    out = bound(grads)
    want, state = comp.compress(grads, comp.init(grads))
    assert torch.equal(out["a"], want["a"])
    assert torch.equal(bound.state.residual["a"], state.residual["a"])
    # a residual of the parameter's shape where the rank holds a slice
    wrong = comp.bind(comp.init({"a": torch.zeros(6, 5)}))
    with pytest.raises(ValueError, match="residual"):
        wrong(grads)


def test_foreign_callable_sees_the_gradients_as_they_are():
    """On a world of one rank the mesh step hands a ``grads -> grads``
    callable that is not one of the repo's compressors the gradients,
    and uses what it returns."""
    cfg = registry.get_config("qwen1.5-4b-smoke")
    model = layers.init_params(registry.build_model(cfg, "cpu"), 0)
    seen = []

    def halve(grads):
        seen.append({k: g.clone() for k, g in grads.items()})
        return {k: g * 0.5 for k, g in grads.items()}

    plan = partition.make_plan(1, device="cpu")
    step = train_loop.make_train_step(model, cfg,
                                      t_opt.AdamW(learning_rate=R.LR),
                                      plan=plan, grad_compression=halve)
    assert not compression.takes_max_over(halve)
    assert compression.takes_max_over(compression.compress_int8_stateless)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step(params, step.init_opt_state(params), batch)
    assert len(seen) == 1 and sorted(seen[0]) == sorted(params)
    assert all(g.shape == params[k].shape for k, g in seen[0].items())
