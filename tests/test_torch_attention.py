"""The port's flash attention and graph attention against the JAX
package, on the CPU.

* `attention_ref` (and the CPU path of `flash_attention`) against the
  JAX Pallas kernel in interpret mode and the JAX `attention_ref`, over a
  subset of the JAX sweep (`tests/test_kernels.py`): causal or not, GQA,
  fp32 and bf16, segment masks whose sentinel rows are exact zeros.
  Tolerances are the sweep's `tol(dtype)`.
* Causal attention over Sq != Skv raises on the CPU path (the reference's
  kernel and oracle disagree there).
* `GraphSelfAttention` from the JAX parameters (`load_jax_params`)
  against the JAX module with kernels off and on (Pallas interpret):
  the forward on every row, padding included, and the gradients of the
  masked loss, at `examples/gat_flash_parity.py`'s tolerances (loss rtol
  1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5).
* `gat_flash_parity.run(device="cpu")` against the numbers the JAX
  example computes, and the registry's graph-attention plumbing
  (`FlashAttentionFunction` against the JAX custom VJP).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as j_ops
from repro.kernels import dispatch as j_dispatch
from repro.kernels.flash_attention.kernel import (
    flash_attention as j_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.nn.graph_attention import GraphSelfAttention as JGraphSelfAttention
from repro.nn.module import split_params

from repro_torch.core.graph_tensor import to_device
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     segment_attention_ref)
from repro_torch.nn.graph_attention import GraphSelfAttention
from repro_torch.nn.layers import load_jax_params
from repro_torch.orchestration import gat_flash_parity

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EXAMPLE_TOL = dict(loss=dict(rtol=1e-5, atol=1e-6),
                   grads=dict(rtol=1e-4, atol=1e-5))


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def inputs(seed, shapes, dtype):
    """The same standard-normal arrays in both packages, rounded to
    `dtype` once (numpy fp32 -> jnp and torch, each cast to dtype)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,kh,d", [(1, 128, 4, 4, 32),
                                        (2, 128, 8, 2, 64),
                                        (1, 64, 2, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_kernel_and_oracle(b, s, h, kh, d, causal,
                                                 dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(
        s + h + d, [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    want_kernel = j_flash_attention(jq, jk, jv, causal=causal, q_block=64,
                                    kv_block=64, interpret=True)
    want_ref = j_attention_ref(jq, jk, jv, causal=causal)
    got = attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, d)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))
    # the entry point's CPU path is the plain version, not a launch
    before = flash_kernel.flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=causal), got)
    assert flash_kernel.flash_attention.launches == before


@pytest.mark.parametrize("s,h,d", [(128, 2, 16), (256, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_mask_matches_jax_with_exact_zero_sentinel_rows(s, h, d,
                                                                dtype):
    """Rows attend only within their segment; the last 32 queries carry
    a segment id (-1) that no key has (-2), so they emit exact zeros."""
    rng = np.random.default_rng(s)
    (jq, jk, jv), (tq, tk, tv) = inputs(s, [(1, s, h, d)] * 3, dtype)
    n_valid = s - 32
    comp = np.sort(rng.integers(0, 5, n_valid)).astype(np.int32)
    q_seg = np.concatenate([comp, np.full(32, -1, np.int32)])[None]
    kv_seg = np.concatenate([comp, np.full(32, -2, np.int32)])[None]
    want_kernel = j_flash_attention(jq, jk, jv, jnp.asarray(q_seg),
                                    jnp.asarray(kv_seg), causal=False,
                                    q_block=64, kv_block=64, interpret=True)
    want_ref = j_attention_ref(jq, jk, jv, jnp.asarray(q_seg),
                               jnp.asarray(kv_seg), causal=False)
    got = flash_attention(tq, tk, tv, torch.from_numpy(q_seg),
                          torch.from_numpy(kv_seg), causal=False)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))
    assert not as_f32(got)[0, n_valid:].any()


def test_causal_with_unequal_lengths_raises():
    """The reference's kernel aligns the causal mask at the start and its
    oracle at the end; for Sq != Skv the port raises instead of picking
    one (same shapes as the disagreement measured in interpret mode)."""
    q = torch.randn(1, 8, 2, 16)
    kv = torch.randn(1, 16, 1, 16)
    for fn in (flash_attention, attention_ref,
               flash_kernel.flash_attention):
        with pytest.raises(ValueError, match="Sq == Skv"):
            fn(q, kv, kv, causal=True)
        assert fn(q, kv, kv, causal=False).shape == (1, 8, 2, 16)


# ---------------------------------------------------------------------------
# GraphSelfAttention and its parity driver
# ---------------------------------------------------------------------------

def jax_example():
    """examples/gat_flash_parity.py's graph (built by the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        "gat_flash_parity_example", REPO / "examples" / "gat_flash_parity.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    from repro.data.batching import (SizeConstraints, merge_graphs,
                                     pad_to_sizes)
    merged = merge_graphs([example.component(i, n) for i, n in
                           enumerate(gat_flash_parity.NODE_COUNTS)])
    return pad_to_sizes(merged, SizeConstraints(
        total_num_components=5, total_num_nodes={"nodes": 96},
        total_num_edges={"links": 192}))


@pytest.fixture(scope="module")
def example():
    """(JAX graph, JAX module, its parameters as jnp and as numpy)."""
    graph = jax_example()
    module = JGraphSelfAttention(num_heads=4, per_head_channels=8,
                                 in_dim=gat_flash_parity.DIM)
    params = split_params(module.init(jax.random.PRNGKey(0)))[0]
    return graph, module, params, jax.tree_util.tree_map(np.asarray, params)


def jax_loss_and_grads(graph, module, params, kernels: bool):
    mask = graph.node_sets["nodes"].mask()[:, None]

    def loss(p):
        out = module(p, graph, "nodes")
        return jnp.mean(jnp.where(mask, out, 0.0) ** 2), out

    j_ops.use_kernels(kernels)
    try:
        (value, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    finally:
        j_ops.use_kernels(False)
    return float(value), np.asarray(out), grads


def test_example_graph_is_the_jax_examples():
    want = jax_example()
    got = gat_flash_parity.example_graph()
    np.testing.assert_array_equal(got.node_sets["nodes"].sizes,
                                  want.node_sets["nodes"].sizes)
    np.testing.assert_array_equal(got.node_sets["nodes"]["hidden_state"],
                                  want.node_sets["nodes"]["hidden_state"])
    np.testing.assert_array_equal(got.context.sizes, want.context.sizes)
    adj, jadj = got.edge_sets["links"].adjacency, \
        want.edge_sets["links"].adjacency
    np.testing.assert_array_equal(adj.source, jadj.source)
    np.testing.assert_array_equal(adj.target, jadj.target)
    assert got.node_sets["nodes"].capacity == 96


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["jax-reference", "jax-pallas-interpret"])
def test_graph_self_attention_matches_jax(example, kernels):
    graph, module, params, np_params = example
    want_loss, want_out, want_grads = jax_loss_and_grads(graph, module,
                                                         params, kernels)
    port = load_jax_params(GraphSelfAttention(4, 8, gat_flash_parity.DIM),
                           np_params)
    g = to_device(gat_flash_parity.example_graph(), "cpu")
    out = port(g, "nodes")
    # every row, padding rows included (they attend among themselves)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-6)
    mask = g.node_sets["nodes"].mask()[:, None]
    loss = torch.where(mask, out, torch.zeros_like(out)).square().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **EXAMPLE_TOL["loss"])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(want_grads[name.split(".")[0]]["w"]),
            err_msg=name, **EXAMPLE_TOL["grads"])


def test_parity_driver_reproduces_the_jax_example(example):
    graph, module, params, np_params = example
    want_loss, _, want_grads = jax_loss_and_grads(graph, module, params,
                                                  kernels=True)
    result = gat_flash_parity.run(device="cpu", params=np_params)
    result.check()  # kernel path == plain path (both plain on the CPU)
    assert result.forward_launches == result.backward_launches == 0
    np.testing.assert_allclose(result.loss, want_loss, **EXAMPLE_TOL["loss"])
    assert sorted(result.grads) == ["wk.w", "wo.w", "wq.w", "wv.w"]
    for name, g in result.grads.items():
        np.testing.assert_allclose(
            g.numpy(), np.asarray(want_grads[name.split(".")[0]]["w"]),
            err_msg=name, **EXAMPLE_TOL["grads"])
    # a seeded draw when no parameters are given: a pure function of it
    a = gat_flash_parity.run(device="cpu", seed=3)
    b = gat_flash_parity.run(device="cpu", seed=3)
    assert a.loss == b.loss and a.loss != result.loss


def test_parity_driver_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gat_flash_parity.run()


def test_graph_attention_routing_on_the_cpu():
    q = torch.randn(10, 2, 4)
    dec = registry.graph_attention_decision(q)
    assert not dec.use_kernel and "cpu tensor" in dec.reason
    with registry.plain_versions():
        assert registry.graph_attention_decision(q).reason == \
            "plain versions requested"
    assert registry.registry()["graph_attention"].kernels == {
        "flash_attention": flash_kernel.flash_attention}


def test_flash_attention_function_matches_the_jax_custom_vjp():
    """`FlashAttentionFunction` (here with the wrapper's CPU path as its
    forward) against jax.vjp of `dispatch.graph_attention` with kernels
    on (the Pallas kernel in interpret mode, the reference's gradient):
    values and the gradients of q, k and v, across three components and
    a padding segment."""
    rng = np.random.default_rng(11)
    n, h, d = 70, 2, 8
    arrays = [rng.standard_normal((n, h, d)).astype(np.float32)
              for _ in range(4)]
    segments = np.repeat(np.arange(4, dtype=np.int32), [20, 25, 15, 10])
    j_ops.use_kernels(True)
    try:
        want, vjp = jax.vjp(
            lambda a, b, c: j_dispatch.graph_attention(
                a, b, c, jnp.asarray(segments)),
            *[jnp.asarray(a) for a in arrays[:3]])
        want_grads = vjp(jnp.asarray(arrays[3]))
    finally:
        j_ops.use_kernels(False)
    q, k, v = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    seg = torch.from_numpy(segments)
    got = registry.FlashAttentionFunction.apply(
        q, k, v, seg, flash_kernel.flash_attention)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got.backward(torch.from_numpy(arrays[3]))
    for t, w in zip((q, k, v), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    # the plain version itself, through registry.graph_attention
    plain = registry.graph_attention(q.detach(), k.detach(), v.detach(), seg)
    assert torch.equal(plain, segment_attention_ref(q.detach(), k.detach(),
                                                    v.detach(), seg))
