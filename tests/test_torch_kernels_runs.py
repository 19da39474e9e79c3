"""The port's run variants and autograd Functions against the JAX
package, on the CPU.

* The plain versions (what `segment_pool_runs` / `edge_mpnn_runs` run on
  a CPU tensor) against the Pallas run kernels with ``interpret=True``,
  on sorted and unsorted ids with padding rows and empty segments.  fp32,
  rtol 1e-5, atol 1e-6 (sums run in another order).
* `registry.SegmentPoolFunction` / `EdgeMpnnFunction` — the route every
  kernel call takes on the card — with the plain version standing in for
  the launch (CPU tensors), against `jax.vjp` of the reference's
  `dispatch.segment_reduce` / `dispatch.edge_mpnn` with its kernels on
  (interpret mode) under ``dispatch.layout(True)``, i.e. through the
  reference's custom VJPs.  Values are random normal, so max/min have no
  ties and their gradients are unambiguous.  rtol 1e-5, atol 1e-6.
* The layout hint: per thread, read per call, passed by the ops and the
  fused conv as the reference passes it.

The CUDA kernels themselves are held to these plain versions on the
card, by chip_smoke.py and tests/test_torch_cuda.py.
"""
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as j_dispatch
from repro.kernels.edge_mpnn.kernel import edge_mpnn_runs as j_mpnn_runs
from repro.kernels.segment_pool.kernel import segment_pool_runs as j_runs

from repro_torch.core import ops as t_ops
from repro_torch.core.convolutions import SimpleConv
from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, HIDDEN_STATE,
                                           NodeSet, to_device)
from repro_torch.kernels import build, registry
from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn, edge_mpnn_runs
from repro_torch.kernels.segment_pool.kernel import (segment_pool,
                                                     segment_pool_runs)

TOL = dict(rtol=1e-5, atol=1e-6)


def pool_inputs(e, n, d, seed, sort):
    """values [e, d]; ids in [1, n + 3) (>= n: padding), segment 0 and
    n - 1 empty; sorted (padding last, as batches are) or not."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(1, n + 3, e).astype(np.int32)
    ids[ids == n - 1] = n + 1
    if sort:
        ids = np.sort(ids)
    return vals, ids


@pytest.fixture
def reference_kernels():
    """The reference's dispatch with its Pallas kernels on (interpret
    mode on the CPU), restored afterwards."""
    was = j_dispatch.enabled()
    j_dispatch.enable(True)
    try:
        yield
    finally:
        j_dispatch.enable(was)


def test_run_kernels_are_built_with_the_others():
    assert {"segment_pool_runs", "edge_mpnn_runs"} <= set(build.SOURCES)
    assert all(p.is_file() for p in build.SOURCES.values())
    assert {p.name for p in build.HEADERS} == {"cuda_common.cuh",
                                               "edge_tile.cuh", "pool.cuh"}


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("e,n,d", [(64, 16, 8), (257, 40, 32)])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_segment_pool_runs_plain_matches_pallas(sort, e, n, d, reduce):
    vals, ids = pool_inputs(e, n, d, e + n + d, sort)
    got = segment_pool_runs(torch.from_numpy(vals), torch.from_numpy(ids),
                            n_segments=n, reduce=reduce)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    kernel = j_runs(jnp.asarray(vals), jnp.asarray(ids), n_segments=n,
                    reduce=reduce, e_block=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    assert not got[0].any() and not got[n - 1].any()  # empty -> 0
    assert segment_pool_runs.launches == 0  # CPU: no kernel launched


@pytest.mark.parametrize("sort", [True, False])
def test_segment_pool_runs_integer_sums_are_bit_identical(sort):
    rng = np.random.default_rng(1)
    vals = rng.integers(-8, 8, (300, 16)).astype(np.float32)
    ids = rng.integers(0, 40, 300).astype(np.int32)
    if sort:
        ids = np.sort(ids)
    got = segment_pool_runs(torch.from_numpy(vals), torch.from_numpy(ids),
                            n_segments=36)
    kernel = j_runs(jnp.asarray(vals), jnp.asarray(ids), n_segments=36,
                    e_block=64, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))


def mpnn_inputs(n_src, n_tgt, e, ds, dt, m, seed, sort):
    rng = np.random.default_rng(seed)
    h_src = rng.standard_normal((n_src, ds)).astype(np.float32)
    h_tgt = rng.standard_normal((n_tgt, dt)).astype(np.float32)
    src = rng.integers(0, n_src, e).astype(np.int32)
    tgt = rng.integers(0, n_tgt + 2, e).astype(np.int32)  # >= n_tgt: pad
    if sort:
        order = np.argsort(tgt, kind="stable")
        src, tgt = src[order], tgt[order]
    w = (rng.standard_normal((ds + dt, m)) / np.sqrt(ds + dt)) \
        .astype(np.float32)
    b = (0.1 * rng.standard_normal(m)).astype(np.float32)
    return h_src, h_tgt, src, tgt, w, b


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("activation", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("shape", [(12, 10, 40, 8, 8, 16),
                                   (7, 19, 33, 16, 8, 12)])
def test_edge_mpnn_runs_plain_matches_pallas(sort, activation, shape):
    n_src, n_tgt, e, ds, dt, m = shape
    arrays = mpnn_inputs(*shape, seed=sum(shape), sort=sort)
    got = edge_mpnn_runs(*map(torch.from_numpy, arrays), n_src=n_src,
                         n_tgt=n_tgt, activation=activation)
    assert got.dtype == torch.float32 and got.shape == (n_tgt, m)
    kernel = j_mpnn_runs(*map(jnp.asarray, arrays), n_src=n_src,
                         n_tgt=n_tgt, e_block=16, activation=activation,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    assert edge_mpnn_runs.launches == 0


# ---------------------------------------------------------------------------
# autograd Functions vs the reference's custom VJPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_segment_pool_function_matches_reference_vjp(reference_kernels,
                                                     sort, reduce):
    vals, ids = pool_inputs(48, 9, 6, 11, sort)
    cot = np.random.default_rng(12).standard_normal((9, 6)) \
        .astype(np.float32)
    with j_dispatch.layout(sorted_by_target=True):
        dec = j_dispatch.segment_reduce_decision(vals.shape, jnp.float32,
                                                 9, reduce)
        assert dec.use_kernel and dec.variant == "runs"
        want, vjp = jax.vjp(lambda v: j_dispatch.segment_reduce(
            v, jnp.asarray(ids), 9, reduce), jnp.asarray(vals))
        (want_grad,) = vjp(jnp.asarray(cot))
    for kernel in (segment_pool_runs, segment_pool):
        v = torch.from_numpy(vals).requires_grad_(True)
        out = registry.SegmentPoolFunction.apply(
            v, torch.from_numpy(ids), 9, reduce, kernel)
        out.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad),
                                   **TOL)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_edge_mpnn_function_matches_reference_vjp(reference_kernels, sort,
                                                  activation):
    n_src, n_tgt, e, d, m = 12, 10, 40, 8, 16
    arrays = mpnn_inputs(n_src, n_tgt, e, d, d, m, seed=5, sort=sort)
    h_src, h_tgt, src, tgt, w, b = arrays
    cot = np.random.default_rng(13).standard_normal((n_tgt, m)) \
        .astype(np.float32)
    with j_dispatch.layout(sorted_by_target=True):
        dec = j_dispatch.edge_mpnn_decision(n_src, n_tgt, d, d, m,
                                            jnp.float32, activation,
                                            n_edges=e)
        assert dec.use_kernel and dec.variant == "runs"
        want, vjp = jax.vjp(
            lambda hs, ht, ww, bb: j_dispatch.edge_mpnn(
                hs, ht, jnp.asarray(src), jnp.asarray(tgt), ww, bb,
                n_src=n_src, n_tgt=n_tgt, activation=activation),
            *map(jnp.asarray, (h_src, h_tgt, w, b)))
        want_grads = vjp(jnp.asarray(cot))
    for kernel in (edge_mpnn_runs, edge_mpnn):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (h_src, h_tgt, w, b)]
        out = registry.EdgeMpnnFunction.apply(
            *leaves, torch.from_numpy(src), torch.from_numpy(tgt), n_src,
            n_tgt, activation, kernel)
        out.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **TOL)
        for leaf, g in zip(leaves, want_grads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-5)


def test_functions_pass_no_gradient_to_ids_and_skip_unneeded_inputs():
    vals, ids = pool_inputs(20, 5, 3, 1, True)
    v = torch.from_numpy(vals).requires_grad_(True)
    out = registry.SegmentPoolFunction.apply(v, torch.from_numpy(ids), 5,
                                             "sum", segment_pool_runs)
    assert out.grad_fn is not None
    out.sum().backward()
    assert v.grad.shape == v.shape
    h_src, h_tgt, src, tgt, w, b = mpnn_inputs(6, 5, 12, 4, 4, 8, 2, True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = registry.EdgeMpnnFunction.apply(
        torch.from_numpy(h_src), torch.from_numpy(h_tgt), ww,
        torch.from_numpy(b), torch.from_numpy(src), torch.from_numpy(tgt),
        6, 5, "relu", edge_mpnn_runs)
    (g,) = torch.autograd.grad(out.sum(), [ww])
    assert g.shape == ww.shape
    with torch.inference_mode():  # serving takes the same route
        out = registry.SegmentPoolFunction.apply(
            torch.from_numpy(vals), torch.from_numpy(ids), 5, "max",
            segment_pool_runs)
    assert out.shape == (5, 3)


# ---------------------------------------------------------------------------
# the layout hint
# ---------------------------------------------------------------------------

CUDA_LIKE = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda"))


def test_layout_picks_the_run_variant_on_the_card_only():
    """The decision on a CUDA tensor (a stand-in here: the rule reads
    `is_cuda` alone): run kernel on sorted ids, any-order kernel
    otherwise; `sorted_ids` wins over the layout; CPU tensors stay on
    the plain version either way."""
    dec = registry.segment_reduce_decision(CUDA_LIKE)
    assert dec.use_kernel and dec.kernel == "segment_pool"
    assert dec.reason == "kernel:segment_pool[unsorted]"
    with registry.layout(sorted_by_target=True):
        dec = registry.edge_mpnn_decision(CUDA_LIKE, "relu")
        assert dec.kernel == "edge_mpnn_runs"
        assert dec.reason == "kernel:edge_mpnn_runs[sorted]"
        assert registry.segment_reduce_decision(
            CUDA_LIKE, sorted_ids=False).kernel == "segment_pool"
        assert not registry.segment_reduce_decision(
            torch.zeros(3, 2)).use_kernel
        with registry.plain_versions():
            assert not registry.edge_mpnn_decision(CUDA_LIKE).use_kernel
    assert registry.segment_reduce_decision(
        CUDA_LIKE, sorted_ids=True).kernel == "segment_pool_runs"
    entries = registry.registry()
    assert set(entries["segment_pool"].kernels) == {"segment_pool",
                                                    "segment_pool_runs"}
    assert set(entries["edge_mpnn"].kernels) == {"edge_mpnn",
                                                 "edge_mpnn_runs"}


def test_layout_is_per_thread_and_restored():
    seen = {}

    def other():
        seen["other"] = registry.layout_sorted_by_target()

    assert not registry.layout_sorted_by_target()
    with registry.layout(sorted_by_target=True):
        with registry.layout(sorted_by_target=False):
            assert not registry.layout_sorted_by_target()
        assert registry.layout_sorted_by_target()
        t = threading.Thread(target=other, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == {"other": False}
    assert not registry.layout_sorted_by_target()


def _small_graph():
    """Two node sets, one edge set with a padding edge, on the CPU."""
    rng = np.random.default_rng(0)
    return to_device(GraphTensor(
        Context(np.asarray([1, 0], np.int32), {}),
        {"a": NodeSet(np.asarray([3, 0], np.int32), {
            HIDDEN_STATE: rng.standard_normal((3, 4)).astype(np.float32)},
            3),
         "b": NodeSet(np.asarray([3, 1], np.int32), {
             HIDDEN_STATE: rng.standard_normal((4, 4)).astype(np.float32)},
             4)},
        {"ab": EdgeSet(np.asarray([4, 1], np.int32), Adjacency(
            np.asarray([0, 1, 2, 2, 0], np.int32),
            np.asarray([0, 0, 1, 2, 3], np.int32), "a", "b"), {}, 5)}),
        "cpu")


def test_ops_and_fused_conv_pass_the_reference_hints(monkeypatch):
    """None for TARGET (the thread's layout), False for SOURCE, True for
    context pools — core/ops.py:126-128,141,189-190 and
    convolutions.py:192-195 of the reference."""
    calls = []
    real = registry.segment_reduce

    def spy(values, seg_ids, n_segments, reduce="sum", *, sorted_ids=None):
        calls.append(sorted_ids)
        return real(values, seg_ids, n_segments, reduce,
                    sorted_ids=sorted_ids)

    monkeypatch.setattr(registry, "segment_reduce", spy)
    g = _small_graph()
    value = torch.ones(5, 2)
    t_ops.pool_edges_to_node(g, "ab", "target", feature_value=value)
    t_ops.pool_edges_to_node(g, "ab", "source", feature_value=value)
    t_ops.segment_softmax(g, "ab", "target", feature_value=value)
    t_ops.pool_nodes_to_context(g, "a", feature_name=HIDDEN_STATE)
    assert calls == [None, False, None, None, True]

    hints = []
    monkeypatch.setattr(registry, "edge_mpnn_decision",
                        lambda *a, **k: registry.Decision(True, "forced"))
    monkeypatch.setattr(registry, "edge_mpnn",
                        lambda *a, sorted_ids, **k: hints.append(sorted_ids))
    for tag in ("target", "source"):
        SimpleConv(3, 8, receiver_tag=tag)(g, "ab")
    assert hints == [None, False]
