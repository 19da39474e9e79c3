"""The arithmetic of the edge kernels' fp32 product, on the CPU.

`edge_mpnn.cu` and `edge_mpnn_runs.cu` (`edge_mpnn/edge_mma.cuh`) run
bf16/fp16 inputs on the tensor cores and fp32 inputs as an fp32 FMA chain
over k = 0, 1, ..., K - 1 per output: the plain version's order.  The
CUDA kernels cannot run here, so this file emulates that product with
numpy (an FMA is one rounding of an exact fp64 sum) and holds the whole
function built on it (gather, product, bias, activation, scatter)
against the port's plain version and the JAX reference, on the same
numpy inputs, under the tolerance the card holds the fp32 kernels to at
each shape: rtol/atol 1e-5 (served, ragged), and at the trained shape
chip_smoke.py's rule for sums of many terms.  It also pins that the
trained rule's absolute 1e-6 is below the plain fp32 version's own
error: the exact (fp64) result misses it (relu, identity), so a product
that sums in another order than the plain version cannot be held to it.

Shapes: the served `has_topic` conv (`chip_smoke.served_inputs`' draw and
scales), the trained one (n_src 1461, n_tgt 1409, E 5175, targets sorted,
one 2697-edge run), and Ds 100 + Dt 28, where a 32-wide K chunk
straddles Ds.

Also pinned here: the attention modules on a node set of capacity 0
raise in the JAX package and in the port alike.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convolutions as j_convs
from repro.core import graph_tensor as j_gt
from repro.kernels.edge_mpnn.ref import edge_mpnn_ref as j_edge_mpnn_ref
from repro.nn import graph_attention as j_attention
from repro.nn.module import split_params

from repro_torch.core import convolutions as t_convs
from repro_torch.core import graph_tensor as t_gt
from repro_torch.kernels.edge_mpnn.ref import activate, edge_mpnn_ref
from repro_torch.nn import graph_attention as t_attention
from repro_torch.nn.layers import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)  # the fp32 kernels' on the card


def fma_chain(x: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """x @ w as the kernels' fp32 product computes it: per output,
    acc = fma(x[k], w[k], acc) for k = 0, 1, ... (each FMA one rounding to
    fp32 of the exact fp64 sum)."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    xd, wd = x.astype(np.float64), w.astype(np.float64)
    for k in range(x.shape[1]):
        acc = (acc + xd[:, k:k + 1] * wd[k]).astype(np.float32)
    return torch.from_numpy(acc)


def emulated_edge_mpnn(h_src, h_tgt, src, tgt, w, b, *, n_src, n_tgt,
                       activation):
    """The kernels' function on the emulated fp32 product: clamped gathers,
    bias and activation in fp32, edges with tgt outside [0, n_tgt)
    dropped, fp32 sums per target."""
    x = np.concatenate([h_src[np.clip(src, 0, n_src - 1)],
                        h_tgt[np.clip(tgt, 0, n_tgt - 1)]], axis=1)
    msg = activate(fma_chain(x, w) + torch.from_numpy(b), activation)
    valid = torch.from_numpy((tgt >= 0) & (tgt < n_tgt))
    msg = torch.where(valid[:, None], msg, 0.0)
    rows = torch.where(valid, torch.from_numpy(tgt).long(), n_tgt)
    return torch.zeros(n_tgt + 1, w.shape[1]).index_add_(0, rows, msg)[:n_tgt]


def fp64_edge_mpnn(h_src, h_tgt, src, tgt, w, b, *, n_src, n_tgt,
                   activation, absolute=False):
    """The same function in fp64 throughout (of |message| when
    `absolute`)."""
    x = np.concatenate([h_src[np.clip(src, 0, n_src - 1)],
                        h_tgt[np.clip(tgt, 0, n_tgt - 1)]], axis=1)
    msg = activate(torch.from_numpy(x.astype(np.float64))
                   @ torch.from_numpy(w.astype(np.float64))
                   + torch.from_numpy(b.astype(np.float64)), activation)
    if absolute:
        msg = msg.abs()
    valid = torch.from_numpy((tgt >= 0) & (tgt < n_tgt))
    msg = torch.where(valid[:, None], msg, 0.0)
    rows = torch.where(valid, torch.from_numpy(tgt).long(), n_tgt)
    return torch.zeros(n_tgt + 1, w.shape[1], dtype=torch.float64
                       ).index_add_(0, rows, msg)[:n_tgt]


def assert_close_sums(got, want, arrays, *, n_src, n_tgt, activation):
    """chip_smoke.py's rule for fp32 sums of many terms (`_close_sum`,
    which holds edge_mpnn_runs at the trained shape): a row of n terms
    whose absolute values sum to S is held to (1e-5 + 2 n 2^-24) S +
    1e-6."""
    _, _, _, tgt, _, _ = arrays
    valid = (tgt >= 0) & (tgt < n_tgt)
    counts = torch.from_numpy(np.bincount(tgt[valid], minlength=n_tgt))
    abs_sum = fp64_edge_mpnn(*arrays, n_src=n_src, n_tgt=n_tgt,
                             activation=activation, absolute=True)
    tol = (1e-5 + 2 * counts[:, None].double() * 2.0 ** -24) * abs_sum + 1e-6
    err = (got.double() - want.double()).abs()
    assert bool((err <= tol).all()), (err - tol).max().item()


def served():
    """chip_smoke.served_inputs' draw: the has_topic conv at rung 8."""
    n_src, n_tgt, e, d = 1224, 4896, 4896, 128
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_src, e).astype(np.int32)
    tgt = rng.integers(0, n_tgt, e).astype(np.int32)
    tgt[rng.random(e) < 0.05] = n_tgt + 7  # padding edges
    h_src = rng.standard_normal((n_src, d)).astype(np.float32)
    h_tgt = rng.standard_normal((n_tgt, d)).astype(np.float32)
    w = ((2 * d) ** -0.5 * rng.standard_normal((2 * d, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (h_src, h_tgt, src, tgt, w, b), n_src, n_tgt


def trained():
    """The trained has_topic conv's shape: targets sorted, 1052-odd runs
    over the real fields and one 2697-edge run into the last node."""
    n_src, n_tgt, e, d, long_run = 1461, 1409, 5175, 128, 2697
    rng = np.random.default_rng(4)
    src = rng.integers(0, n_src, e).astype(np.int32)
    tgt = np.sort(np.concatenate([
        rng.integers(0, n_tgt - 1, e - long_run),
        np.full(long_run, n_tgt - 1)])).astype(np.int32)
    h_src = rng.standard_normal((n_src, d)).astype(np.float32)
    h_tgt = rng.standard_normal((n_tgt, d)).astype(np.float32)
    w = ((2 * d) ** -0.5 * rng.standard_normal((2 * d, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (h_src, h_tgt, src, tgt, w, b), n_src, n_tgt


def ragged():
    """Ds 100 + Dt 28 -> M 128: K chunk 3 of 4 straddles Ds."""
    n_src, n_tgt, e, ds, dt, m = 300, 400, 2000, 100, 28, 128
    rng = np.random.default_rng(7)
    src = rng.integers(0, n_src, e).astype(np.int32)
    tgt = rng.integers(0, n_tgt + 5, e).astype(np.int32)  # >= n_tgt: pad
    h_src = rng.standard_normal((n_src, ds)).astype(np.float32)
    h_tgt = rng.standard_normal((n_tgt, dt)).astype(np.float32)
    w = ((ds + dt) ** -0.5
         * rng.standard_normal((ds + dt, m))).astype(np.float32)
    b = (0.1 * rng.standard_normal(m)).astype(np.float32)
    return (h_src, h_tgt, src, tgt, w, b), n_src, n_tgt


SHAPES = {"served": served, "trained": trained, "ragged": ragged}
ACTS = ["relu", "gelu", "identity"]


@functools.cache
def make_case(name):
    """(shape name, numpy inputs, n_src, n_tgt), built once per shape."""
    arrays, n_src, n_tgt = SHAPES[name]()
    return name, arrays, n_src, n_tgt


def results(case, activation):
    """The plain version, the emulated kernel and the keyword arguments."""
    _, arrays, n_src, n_tgt = case
    kw = dict(n_src=n_src, n_tgt=n_tgt, activation=activation)
    plain = edge_mpnn_ref(*map(torch.from_numpy, arrays), **kw)
    return plain, emulated_edge_mpnn(*arrays, **kw), kw


def assert_kernel_tolerance(case, got, want, kw):
    """The fp32 tolerance the card holds the kernels to at this shape:
    rtol/atol 1e-5 (served, ragged; chip_smoke.py's `_close`), and the
    many-term sum rule at the trained shape (`_close_sum`), whose
    2697-edge run shares one target row."""
    name, arrays, _, _ = case
    if name == "trained":
        assert_close_sums(got, want, arrays, **kw)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fma_chain_meets_every_rule(shape, activation):
    """The shipped fp32 product, k in order, against the plain version
    and the JAX reference under the card's rule at each shape."""
    case = make_case(shape)
    _, arrays, _, _ = case
    plain, fma, kw = results(case, activation)
    assert_kernel_tolerance(case, fma, plain, kw)
    want = j_edge_mpnn_ref(*map(jnp.asarray, arrays), **kw)
    assert_kernel_tolerance(case, fma, torch.from_numpy(np.asarray(want)),
                            kw)


@pytest.mark.parametrize("activation", ["relu", "identity"])
def test_exact_result_misses_the_trained_rule(activation):
    """At the trained shape, the fp64 result itself is further from the
    plain fp32 version than chip_smoke.py's many-term rule allows (its
    absolute 1e-6 on rows whose messages nearly cancel): only a product
    that repeats the plain version's roundings can be held to it."""
    arrays, n_src, n_tgt = trained()
    kw = dict(n_src=n_src, n_tgt=n_tgt, activation=activation)
    plain = edge_mpnn_ref(*map(torch.from_numpy, arrays), **kw)
    exact = fp64_edge_mpnn(*arrays, **kw)
    with pytest.raises(AssertionError):
        assert_close_sums(exact, plain, arrays, **kw)


# ---------------------------------------------------------------------------
# a node set of capacity 0 under the attention modules
# ---------------------------------------------------------------------------

HEADS, PER_HEAD, DIM = 2, 4, 8


def empty_receiver_graphs():
    """(JAX graph, port graph): node set "a" of 3 nodes and node set "z"
    of capacity 0, edge set "e" a -> z of capacity 0, states 8 wide."""
    rng = np.random.default_rng(0)
    x_a = rng.standard_normal((3, DIM)).astype(np.float32)
    x_z = np.zeros((0, DIM), np.float32)
    no_edges = np.zeros(0, np.int32)

    def build(m, arr, to):
        return m.GraphTensor(
            m.Context(arr(np.ones(1, np.int32)), {}),
            {"a": m.NodeSet(arr(np.array([3], np.int32)),
                            {"hidden_state": to(x_a)}, 3),
             "z": m.NodeSet(arr(np.array([0], np.int32)),
                            {"hidden_state": to(x_z)}, 0)},
            {"e": m.EdgeSet(arr(np.array([0], np.int32)), m.Adjacency(
                arr(no_edges), arr(no_edges), "a", "z"), {}, 0)})

    jg = build(j_gt, jnp.asarray, jnp.asarray)
    tg = t_gt.to_device(build(t_gt, np.asarray, np.asarray), "cpu")
    return jg, tg


# (module, where it is applied, what the JAX package raises, what the
# port raises and a fragment of its message)
MODULES = {
    # both stop at the attention reference's max over zero keys, before
    # the reshape (repro and repro_torch kernels/flash_attention/ref.py)
    "graph_self_attention": (
        lambda m: m.GraphSelfAttention(HEADS, PER_HEAD, DIM), "z",
        ValueError, IndexError, "non-zero size"),
    # both stop at `pooled.reshape(..., -1)` on zero rows
    "gatv2": (lambda m: m.GATv2Conv(HEADS, PER_HEAD, DIM), "e",
              ZeroDivisionError, RuntimeError, "cannot reshape"),
    "multi_head_attention": (
        lambda m: m.MultiHeadAttentionConv(HEADS, PER_HEAD, DIM), "e",
        ZeroDivisionError, RuntimeError, "cannot reshape"),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_attention_on_a_node_set_of_capacity_0_raises_in_both(name):
    """A receiver node set of capacity 0: the JAX package raises, and so
    does the port, at the same step, on the same graph and parameters (a
    trait of the reference, to be fixed on both sides together)."""
    make, where, j_error, t_error, t_message = MODULES[name]
    j_mod_src = j_attention if name == "graph_self_attention" else j_convs
    t_mod_src = t_attention if name == "graph_self_attention" else t_convs
    j_mod, t_mod = make(j_mod_src), make(t_mod_src)
    params = split_params(j_mod.init(jax.random.PRNGKey(0)))[0]
    load_jax_params(t_mod, jax.tree_util.tree_map(np.asarray, params))
    jg, tg = empty_receiver_graphs()
    with pytest.raises(j_error):
        j_mod(params, jg, where)
    with pytest.raises(t_error, match=t_message):
        t_mod(tg, where)
