"""The port's kernel modules against the JAX kernels, on the CPU.

Each port wrapper takes its plain PyTorch version on a CPU tensor; those
are held here to the Pallas kernels (run with ``interpret=True``, as
tests/test_kernels.py runs them) and to the reference's jnp oracles, on
the same numpy inputs with padding ids and empty segments.  fp32,
rtol 1e-5, atol 1e-6 (sums run in another order).  The CUDA kernels
themselves are held to these plain versions on the card, by
chip_smoke.py and tests/test_torch_cuda.py.

Also pinned here: the parity traps of the port (gelu's tanh form, the
max identity and its map to 0, the cast back to the input dtype, the
bf16 default of Embedding, the registry's reasons on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as j_dispatch
from repro.kernels.edge_mpnn.kernel import edge_mpnn as j_edge_mpnn
from repro.kernels.edge_mpnn.ref import edge_mpnn_ref as j_edge_mpnn_ref
from repro.kernels.segment_pool.kernel import segment_pool as j_segment_pool
from repro.kernels.segment_pool.ref import segment_pool_ref as j_pool_ref
from repro.nn.layers import ACTIVATIONS as J_ACTIVATIONS

from repro_torch.kernels import build, registry
from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
from repro_torch.kernels.segment_pool.kernel import segment_pool
from repro_torch.kernels.segment_pool.ref import NEG_INF
from repro_torch.nn.layers import ACTIVATIONS, Embedding

TOL = dict(rtol=1e-5, atol=1e-6)


def pool_inputs(e, n, d, seed):
    """values [e, d]; ids in [0, n + 3) (>= n: padding) with segment 0
    and the last segment guaranteed empty."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(1, n + 3, e).astype(np.int32)
    ids[ids == n - 1] = n + 1
    return vals, ids


@pytest.mark.parametrize("e,n,d", [(64, 16, 8), (33, 7, 16), (257, 40, 32)])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_segment_pool_plain_matches_pallas_and_oracle(e, n, d, reduce):
    vals, ids = pool_inputs(e, n, d, e + n + d)
    got = segment_pool(torch.from_numpy(vals), torch.from_numpy(ids),
                       n_segments=n, reduce=reduce)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    kernel = j_segment_pool(jnp.asarray(vals), jnp.asarray(ids),
                            n_segments=n, reduce=reduce, e_block=128,
                            interpret=True)
    oracle = j_pool_ref(jnp.asarray(vals), jnp.asarray(ids), n_segments=n,
                        reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    assert not got[0].any() and not got[n - 1].any()  # empty -> 0


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_segment_reduce_matches_reference_dispatch(reduce):
    """The registry's entry point (mean = fp32 sum / exact count) against
    the reference's dispatch, on [E, 2, 3] features."""
    vals, ids = pool_inputs(48, 9, 6, 5)
    vals = vals.reshape(48, 2, 3)
    got = registry.segment_reduce(torch.from_numpy(vals),
                                  torch.from_numpy(ids), 9, reduce)
    want = j_dispatch.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 9,
                                     reduce)
    assert got.shape == (9, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("e,n", [(0, 5), (10, 0), (37, 9), (300, 64)])
def test_segment_count_matches_reference_mean_and_degree(e, n):
    """The count behind mean pooling and node_degree (a fixed-size
    index_add_, no host sync on the card) against the reference's
    segment_count and mean, with padding ids (>= n), negative ids and
    empty segments: counts exact in int32 (node_degree's dtype) and
    fp32, means within TOL."""
    rng = np.random.default_rng(e + n)
    ids = rng.integers(-3, n + 3, e).astype(np.int32)
    ids[ids == n // 2] = n + 1  # one more empty segment
    vals = rng.standard_normal((e, 4)).astype(np.float32)
    for dtype, j_dtype in ((torch.int32, jnp.int32),
                           (torch.float32, jnp.float32)):
        got = registry.segment_count(torch.from_numpy(ids), n, dtype=dtype)
        want = j_dispatch.segment_count(jnp.asarray(ids), n, dtype=j_dtype)
        assert got.dtype == dtype and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = registry.segment_reduce(torch.from_numpy(vals),
                                  torch.from_numpy(ids), n, "mean")
    want = j_dispatch.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), n,
                                     "mean")
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_pool_integer_sums_are_bit_identical():
    rng = np.random.default_rng(0)
    vals = rng.integers(-8, 8, (512, 32)).astype(np.float32)
    ids = rng.integers(0, 70, 512).astype(np.int32)
    got = segment_pool(torch.from_numpy(vals), torch.from_numpy(ids),
                       n_segments=64)
    kernel = j_segment_pool(jnp.asarray(vals), jnp.asarray(ids),
                            n_segments=64, e_block=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))


def test_segment_pool_max_identity_and_map_to_zero():
    """Max starts from -1e30 and maps a result <= -5e29 to 0, as the
    Pallas kernel does: a segment whose only value is below the identity
    reads 0, and min of an empty segment reads (-)0."""
    vals = np.asarray([[-3e30], [-2.0], [5.0], [1.0]], np.float32)
    ids = np.asarray([0, 1, 1, 9], np.int32)
    for reduce, want in (("max", [0.0, 5.0, 0.0]),
                         ("min", [-3e30, -2.0, 0.0])):
        got = segment_pool(torch.from_numpy(vals), torch.from_numpy(ids),
                           n_segments=3, reduce=reduce)[:, 0].numpy()
        kernel = j_segment_pool(jnp.asarray(vals), jnp.asarray(ids),
                                n_segments=3, reduce=reduce, e_block=8,
                                interpret=True)[:, 0]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        np.testing.assert_array_equal(got, np.asarray(kernel))
    assert NEG_INF == -1e30


def mpnn_inputs(n_src, n_tgt, e, ds, dt, m, seed):
    rng = np.random.default_rng(seed)
    h_src = rng.standard_normal((n_src, ds)).astype(np.float32)
    h_tgt = rng.standard_normal((n_tgt, dt)).astype(np.float32)
    src = rng.integers(0, n_src, e).astype(np.int32)
    tgt = rng.integers(0, n_tgt + 2, e).astype(np.int32)  # >= n_tgt: pad
    w = (rng.standard_normal((ds + dt, m)) / np.sqrt(ds + dt)) \
        .astype(np.float32)
    b = (0.1 * rng.standard_normal(m)).astype(np.float32)
    return h_src, h_tgt, src, tgt, w, b


@pytest.mark.parametrize("activation", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("shape", [(12, 10, 40, 8, 8, 16),
                                   (7, 19, 33, 16, 8, 12)])
def test_edge_mpnn_plain_matches_pallas_and_oracle(activation, shape):
    n_src, n_tgt, e, ds, dt, m = shape
    arrays = mpnn_inputs(*shape, seed=sum(shape))
    got = edge_mpnn(*map(torch.from_numpy, arrays), n_src=n_src,
                    n_tgt=n_tgt, activation=activation)
    assert got.dtype == torch.float32 and got.shape == (n_tgt, m)
    jarrays = [jnp.asarray(a) for a in arrays]
    kernel = j_edge_mpnn(*jarrays, n_src=n_src, n_tgt=n_tgt, e_block=16,
                         activation=activation, interpret=True)
    oracle = j_edge_mpnn_ref(*jarrays, n_src=n_src, n_tgt=n_tgt,
                             activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    via_registry = registry.edge_mpnn(*map(torch.from_numpy, arrays),
                                      n_src=n_src, n_tgt=n_tgt,
                                      activation=activation)
    np.testing.assert_array_equal(via_registry.numpy(), got.numpy())


@pytest.mark.parametrize("kernel_name", ["segment_pool", "edge_mpnn"])
def test_bfloat16_is_cast_back_and_matches_pallas(kernel_name):
    """bf16 in, fp32 accumulation, bf16 out — like the Pallas kernels."""
    if kernel_name == "segment_pool":
        vals, ids = pool_inputs(64, 16, 8, 1)
        args = (jnp.asarray(vals, jnp.bfloat16), jnp.asarray(ids))
        got = segment_pool(torch.from_numpy(vals).bfloat16(),
                           torch.from_numpy(ids), n_segments=16)
        want = j_segment_pool(*args, n_segments=16, e_block=64,
                              interpret=True)
    else:
        arrays = mpnn_inputs(12, 10, 40, 8, 8, 16, seed=2)
        bf = [torch.from_numpy(a) for a in arrays]
        bf = [t.bfloat16() if t.is_floating_point() else t for t in bf]
        got = edge_mpnn(*bf, n_src=12, n_tgt=10)
        jargs = [jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
                 else jnp.asarray(a) for a in arrays]
        want = j_edge_mpnn(*jargs, n_src=12, n_tgt=10, e_block=16,
                           interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(J_ACTIVATIONS["gelu"](
        jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    erf_form = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf_form).max() > 1e-4  # torch's default differs


def test_embedding_defaults_to_bfloat16():
    emb = Embedding(8, 4)
    ids = torch.tensor([0, 3])
    assert emb(ids).dtype == torch.bfloat16  # reference default (:109)
    assert emb(ids, dtype=torch.float32).dtype == torch.float32


def test_registry_decisions_on_the_cpu():
    """The device alone decides: tensors off the card take the plain
    versions and say so, at any width (no cap survives from the TPU's
    VMEM model); on the card the kernels run or raise."""
    for x in (torch.zeros(5, 4), torch.zeros(5, 1024)):
        dec = registry.segment_reduce_decision(x)
        assert not dec.use_kernel and "cpu tensor" in dec.reason
        dec = registry.edge_mpnn_decision(x, "relu")
        assert not dec.use_kernel and "cpu tensor" in dec.reason
    x = torch.zeros(5, 4)
    assert "meta tensor" in registry.segment_reduce_decision(
        torch.zeros(5, 4, device="meta")).reason
    with registry.plain_versions():
        assert "plain versions requested" in \
            registry.segment_reduce_decision(x).reason
    assert "unsupported" in registry.edge_mpnn_decision(x, "tanh").reason
    assert set(registry.registry()) == {"segment_pool", "edge_mpnn",
                                        "graph_attention"}
    counts = registry.segment_count(torch.tensor([0, 2, 2, 7, -1]), 3,
                                    dtype=torch.int32)
    assert counts.tolist() == [1, 0, 2] and counts.dtype == torch.int32


def test_kernel_build_location_and_key():
    """Kernels build into a git-ignored directory under the repository,
    keyed by a hash of their sources."""
    path = build.library_path("edge_mpnn")
    assert path.parent == build.REPO_ROOT / "build" / "repro_torch_ext"
    assert path.name.startswith("edge_mpnn-") and path.suffix == ".so"
    assert path != build.library_path("segment_pool")
    for source in build.SOURCES.values():
        assert source.is_file() and source.suffix == ".cu"
    ignored = (build.REPO_ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in ignored
    assert build.DTYPE_CODES == {"float32": 0, "bfloat16": 1, "float16": 2}
    with pytest.raises(TypeError):
        build.dtype_code(torch.zeros(1, dtype=torch.int32))
    build.check_int32("segment_pool", n_segments=build.INT32_MAX)
    with pytest.raises(ValueError, match="n_segments"):
        build.check_int32("segment_pool", n_segments=build.INT32_MAX + 1)
