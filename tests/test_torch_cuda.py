"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test asks for the `cuda_device` fixture, which skips
where there is no CUDA device (the kernels have no CPU mode).  On a
machine with a card and no JAX, run ``PYTHONPATH=src python -m pytest -q
--noconftest tests/test_torch_cuda.py`` (tests/conftest.py imports jax);
chip_smoke.py makes the same checks at the served and trained shapes.
Tolerances: fp32 rtol/atol 1e-5 (atomic sums run in varying order; the
flash kernel's online softmax reorders its sums), bf16 2e-2; max/min and
integer-valued sums exact; gradients of the autograd Functions against
the plain versions' rtol 1e-5 (pooling) and 1e-4 (edge_mpnn and flash
attention, whose backwards recompute a product).
"""
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
from repro_torch.kernels.segment_pool.kernel import segment_pool
from repro_torch.kernels.segment_pool.ref import segment_pool_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 600])
def test_segment_pool_kernel_matches_plain(cuda_device, reduce, dtype, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.randn(300, d, generator=g, device=cuda_device).to(dtype)
    ids = torch.randint(0, 70, (300,), generator=g, device=cuda_device,
                        dtype=torch.int32)  # >= 64: padding
    got = segment_pool(vals, ids, n_segments=64, reduce=reduce)
    want = segment_pool_ref(vals, ids, n_segments=64, reduce=reduce)
    assert got.dtype == dtype
    if reduce == "sum":
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("activation", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("shape", [(50, 70, 333, 24, 40, 96),
                                   (40, 60, 200, 256, 256, 300)])
def test_edge_mpnn_kernel_matches_plain(cuda_device, activation, shape):
    """96 wide is one column tile; 300 wide is one full and one partial."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n_src, n_tgt, e, ds, dt, m = shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=cuda_device)

    src = torch.randint(0, n_src, (e,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    tgt = torch.randint(0, n_tgt + 5, (e,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    args = (rand(n_src, ds), rand(n_tgt, dt), src, tgt,
            rand(ds + dt, m, scale=0.1), rand(m, scale=0.1))
    got = edge_mpnn(*args, n_src=n_src, n_tgt=n_tgt, activation=activation)
    want = edge_mpnn_ref(*args, n_src=n_src, n_tgt=n_tgt,
                         activation=activation)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert registry.edge_mpnn_decision(args[0], activation).use_kernel


def test_kernels_raise_on_integer_values(cuda_device):
    """On the card a non-float dtype raises; nothing falls back to the
    plain version."""
    ids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        registry.segment_reduce(torch.ones(4, 3, dtype=torch.int32,
                                           device=cuda_device), ids, 2)


# ---------------------------------------------------------------------------
# the run variants (training slice) and the autograd Functions
# ---------------------------------------------------------------------------

def _ids(g, e, n, sort, device):
    """[e] int32 ids in [0, n + 4) (>= n: padding), sorted or not."""
    ids = torch.randint(0, n + 4, (e,), generator=g, device=device,
                        dtype=torch.int32)
    return torch.sort(ids).values if sort else ids


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 600])
def test_segment_pool_runs_kernel_matches_plain(cuda_device, sort, reduce,
                                                dtype, d):
    """600 wide is three column tiles; 300 rows sorted into 70 ids give
    runs that cross the 32-row tiles."""
    from repro_torch.kernels.segment_pool.kernel import segment_pool_runs
    g = torch.Generator(device=cuda_device).manual_seed(2)
    vals = torch.randn(300, d, generator=g, device=cuda_device).to(dtype)
    ids = _ids(g, 300, 64, sort, cuda_device)
    before = segment_pool_runs.launches
    got = segment_pool_runs(vals, ids, n_segments=64, reduce=reduce)
    want = segment_pool_ref(vals, ids, n_segments=64, reduce=reduce)
    assert segment_pool_runs.launches == before + 1
    assert got.dtype == dtype
    if reduce == "sum":
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        ints = torch.randint(-8, 8, (300, d), generator=g,
                             device=cuda_device).to(torch.float32)
        assert torch.equal(
            segment_pool_runs(ints, ids, n_segments=64),
            segment_pool_ref(ints, ids, n_segments=64))  # bit-exact
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("activation", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("shape", [(50, 70, 333, 24, 40, 96),
                                   (40, 60, 200, 256, 256, 300)])
def test_edge_mpnn_runs_kernel_matches_plain(cuda_device, sort, activation,
                                             shape):
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn_runs
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n_src, n_tgt, e, ds, dt, m = shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=cuda_device)

    src = torch.randint(0, n_src, (e,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    args = (rand(n_src, ds), rand(n_tgt, dt), src,
            _ids(g, e, n_tgt, sort, cuda_device),
            rand(ds + dt, m, scale=0.1), rand(m, scale=0.1))
    got = edge_mpnn_runs(*args, n_src=n_src, n_tgt=n_tgt,
                         activation=activation)
    want = edge_mpnn_ref(*args, n_src=n_src, n_tgt=n_tgt,
                         activation=activation)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _grads(out, inputs, seed):
    """Gradients of a fixed random projection of `out`."""
    g = torch.Generator(device=out.device).manual_seed(seed)
    cot = torch.randn(out.shape, generator=g, device=out.device)
    return torch.autograd.grad(out, inputs, cot)


@pytest.mark.parametrize("variant", ["segment_pool", "segment_pool_runs"])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_segment_pool_function_gradient_is_the_plain_one(cuda_device,
                                                         variant, reduce):
    """Random normal values have no ties, so the max/min gradient is
    unambiguous.  The kernel forward must agree too."""
    from repro_torch.kernels.segment_pool import kernel as seg_kernel
    g = torch.Generator(device=cuda_device).manual_seed(4)
    vals = torch.randn(200, 24, generator=g, device=cuda_device,
                       requires_grad=True)
    ids = _ids(g, 200, 30, variant.endswith("runs"), cuda_device)
    got = registry.SegmentPoolFunction.apply(
        vals, ids, 30, reduce, getattr(seg_kernel, variant))
    want = segment_pool_ref(vals, ids, n_segments=30, reduce=reduce)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    (g_got,) = _grads(got, [vals], 5)
    (g_want,) = _grads(want, [vals], 5)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["edge_mpnn", "edge_mpnn_runs"])
def test_edge_mpnn_function_gradient_is_the_plain_one(cuda_device, variant):
    from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n_src, n_tgt, e, d = 40, 50, 160, 16

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=cuda_device)
                ).requires_grad_(True)

    h_src, h_tgt = leaf(n_src, d), leaf(n_tgt, d)
    w, b = leaf(2 * d, d, scale=0.2), leaf(d, scale=0.1)
    src = torch.randint(0, n_src, (e,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    tgt = _ids(g, e, n_tgt, variant.endswith("runs"), cuda_device)
    got = registry.EdgeMpnnFunction.apply(
        h_src, h_tgt, w, b, src, tgt, n_src, n_tgt, "gelu",
        getattr(mpnn_kernel, variant))
    want = edge_mpnn_ref(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                         n_tgt=n_tgt, activation="gelu")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, c in zip(_grads(got, [h_src, h_tgt, w, b], 7),
                    _grads(want, [h_src, h_tgt, w, b], 7)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reduce_type", ["sum", "mean"])
def test_cuda_forward_gives_every_parameter_a_gradient(cuda_device,
                                                       reduce_type):
    """A 2-round model on a target-sorted batch, inside the training
    layout: every conv runs a run kernel, and the loss reaches every
    parameter (slice 1's kernels returned tensors with no grad_fn)."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE, to_device
    from repro_torch.core.models import vanilla_mpnn
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import (SamplingSpecBuilder,
                                           sample_subgraph, seed_rng)
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.nn.layers import init_params
    from repro_torch.serve.gnn import spec_size_bounds, build_ladder
    from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
    from repro_torch.kernels.segment_pool import kernel as seg_kernel

    store, _ = synthetic_mag(n_papers=60, n_authors=30, n_institutions=6,
                             n_fields=10, n_classes=4, feat_dim=8)
    b = SamplingSpecBuilder(store.schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(3, "cites")
    authors = cited.join([seed_op]).sample(2, "written")
    authors.sample(2, "writes")
    authors.sample(2, "affiliated_with")
    cited.sample(2, "has_topic")
    spec = seed_op.build()
    sizes = build_ladder(spec_size_bounds(spec, store.schema), 4).sizes[4]
    graph = to_device(merge_and_pad(
        [sample_subgraph(store, spec, r, seed_rng(0, r)) for r in range(4)],
        sizes, sort_by_target=True), cuda_device)
    edges = {k: (v.source, v.target)
             for k, v in store.schema.edge_sets.items()}
    dims = {n: 16 for n in store.schema.node_sets}
    gnn = init_params(vanilla_mpnn(edges, dims, message_dim=16,
                                   hidden_dim=16, num_rounds=2,
                                   reduce_type=reduce_type), 0).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    states = {n: {HIDDEN_STATE: torch.randn(ns.capacity, 16, generator=g,
                                            device=cuda_device)}
              for n, ns in graph.node_sets.items()}
    kernels = (mpnn_kernel.edge_mpnn_runs if reduce_type == "sum"
               else seg_kernel.segment_pool_runs)
    before = kernels.launches
    with registry.layout(sorted_by_target=True):
        out = gnn(graph.replace_features(node_sets=states))
    assert kernels.launches - before == 5 * 2
    loss = sum(ns[HIDDEN_STATE].square().sum()
               for ns in out.node_sets.values())
    loss.backward()
    for name, p in gnn.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name


# ---------------------------------------------------------------------------
# flash_attention (graph attention slice)
# ---------------------------------------------------------------------------

def _qkv(g, b, sq, skv, h, kh, d, dtype, device):
    q = torch.randn(b, sq, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, skv, kh, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, skv, kh, d, generator=g, device=device).to(dtype)
    return q, k, v


def _flash_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("b,s,h,kh,d", [(1, 128, 4, 4, 32),
                                        (2, 256, 8, 2, 64),
                                        (1, 64, 2, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, b, s, h, kh, d, causal,
                                    dtype):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = _qkv(g, b, s, s, h, kh, d, dtype, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype
    tol = _flash_tol(dtype)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 65, 1461])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ragged_lengths_and_segments(cuda_device, s, causal):
    """No length needs to be a tile multiple; segment and causal masks
    apply together; queries whose id no key has are exact zeros."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v = _qkv(g, 2, s, s, 4, 2, 32, torch.float32, cuda_device)
    seg = torch.sort(torch.randint(0, 5, (2, s), generator=g,
                                   device=cuda_device,
                                   dtype=torch.int32)).values
    kv_seg = seg.clone()
    kv_seg[:, -(s // 4 + 1):] = -2   # these keys match no query
    q_seg = seg.clone()
    q_seg[:, -(s // 8 + 1):] = -1    # these queries match no key
    got = flash_attention(q, k, v, q_seg, kv_seg, causal=causal)
    want = attention_ref(q, k, v, q_seg, kv_seg, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, -(s // 8 + 1):].any()  # exact zeros


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 257])
def test_flash_kernel_head_widths(cuda_device, d):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = _qkv(g, 1, 100, 100, 2, 1, d, torch.float32, cuda_device)
    if d > 256:
        with pytest.raises(ValueError, match="head width"):
            flash_attention(q, k, v, causal=False)
        return
    torch.testing.assert_close(flash_attention(q, k, v, causal=False),
                               attention_ref(q, k, v, causal=False),
                               rtol=1e-5, atol=1e-5)


def test_flash_kernel_repeats_are_bit_identical_and_checks_inputs(
        cuda_device):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = _qkv(g, 1, 300, 300, 8, 2, 128, torch.float32, cuda_device)
    seg = torch.sort(torch.randint(0, 3, (1, 300), generator=g,
                                   device=cuda_device,
                                   dtype=torch.int32)).values
    first = flash_attention(q, k, v, seg, causal=False)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, seg, causal=False),
                           first)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q[:, :10], k, v, causal=True)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3].contiguous(), k, v, causal=False)
    with pytest.raises(TypeError):
        flash_attention(q, k, v, seg.long(), causal=False)
    with pytest.raises(TypeError):
        flash_attention(q.to(torch.int32), k.to(torch.int32),
                        v.to(torch.int32), causal=False)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v, causal=False)


def test_flash_attention_function_gradient_is_the_plain_one(cuda_device):
    """registry.graph_attention on the card: one launch forward, none
    backward, and the plain version's gradients."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import segment_attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(13)
    n, h, d = 200, 4, 32
    leaves = [torch.randn(n, h, d, generator=g, device=cuda_device
                          ).requires_grad_(True) for _ in range(3)]
    seg = torch.repeat_interleave(
        torch.arange(5, device=cuda_device),
        torch.tensor([50, 30, 70, 40, 10], device=cuda_device))
    assert registry.graph_attention_decision(leaves[0]).use_kernel
    before = flash_attention.launches
    got = registry.graph_attention(*leaves, seg)
    assert flash_attention.launches == before + 1
    want = segment_attention_ref(*leaves, seg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got_grads = _grads(got, leaves, 14)
    assert flash_attention.launches == before + 1  # backward: no launch
    for a, c in zip(got_grads, _grads(want, leaves, 14)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
