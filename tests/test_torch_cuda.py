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
attention, whose backwards recompute a product).  The sampler-fleet
path's two tests are exact: `device_prefetch`'s pinned side-stream
copies against a blocking `to_device`, and a thread-fleet
`runner.run(sampler="service")` against itself.  Every tile height the
autotuner may pick is held to the plain version by the same rules, and
`kernels/autotune.py`'s records drive the registry's decisions.  The
LM's `ServeEngine` on the card gives the CPU's greedy tokens (fp32, TF32
off), for the dense decoder and for the MoE, RWKV6 and Zamba2 families
(whose forward logits also agree with the CPU's within 1e-4), Whisper's
prefill -> decode_step loop likewise, and flash through the LM's `Attention(use_flash=True)` makes one
launch and agrees with the chunked path at bf16's 2e-2.
"""
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn, edge_mpnn_runs
from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
from repro_torch.kernels.segment_pool.kernel import (segment_pool,
                                                     segment_pool_runs)
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
    """40 wide is one partial 128-column slice and 600 wide five; 300 rows
    sorted into 70 ids give runs that cross the 16-row tiles (D >= 32)."""
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


def _small_batch(device):
    """(a 4-root target-sorted batch of a small synthetic MAG on `device`,
    its store)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import (SamplingSpecBuilder,
                                           sample_subgraph, seed_rng)
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.serve.gnn import spec_size_bounds, build_ladder

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
        sizes, sort_by_target=True), device)
    return graph, store


@pytest.mark.parametrize("reduce_type", ["sum", "mean"])
def test_cuda_forward_gives_every_parameter_a_gradient(cuda_device,
                                                       reduce_type):
    """A 2-round model on a target-sorted batch, inside the training
    layout: every conv runs a run kernel, and the loss reaches every
    parameter (slice 1's kernels returned tensors with no grad_fn)."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE
    from repro_torch.core.models import vanilla_mpnn
    from repro_torch.nn.layers import init_params
    from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
    from repro_torch.kernels.segment_pool import kernel as seg_kernel

    graph, store = _small_batch(cuda_device)
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
# the pooling kernels' paths: scalar and 16-byte columns, rows per lane
# (D < 32) and warp tiles, unaligned values, long runs, empty shapes, the
# launch budget, and a count that does not sync the host
# ---------------------------------------------------------------------------

POOL_VARIANTS = ["segment_pool", "segment_pool_runs"]


def _pool_kernel(variant):
    from repro_torch.kernels.segment_pool import kernel as seg_kernel
    return getattr(seg_kernel, variant)


def _check_pool(kernel, vals, ids, n, reduce, tile=0):
    """kernel (at tile height `tile`) vs plain: max/min exact; bf16 sums
    within 2e-2 (the cast back); fp32 sums within rtol/atol 1e-5 plus the
    summation-order bound 2 k 2**-24 sum|terms| of a segment of k rows
    (atomics and index_add_ add in different orders, which shows on runs
    of hundreds of rows).  The dtype is kept."""
    got = kernel(vals, ids, n_segments=n, reduce=reduce, tile=tile)
    want = segment_pool_ref(vals, ids, n_segments=n, reduce=reduce)
    assert got.dtype == vals.dtype and got.shape == want.shape
    if reduce != "sum":
        assert torch.equal(got, want)
    elif vals.dtype != torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    else:
        abs_sum = segment_pool_ref(vals.abs(), ids, n_segments=n)
        rows = registry.segment_count(ids, n)[:, None]
        tol = 1e-5 * (1 + want.abs()) + 2 * rows * 2.0 ** -24 * abs_sum
        assert bool(((got - want).abs() <= tol).all()), \
            (got - want).abs().max().item()


@pytest.mark.parametrize("variant", POOL_VARIANTS)
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 4, 128, 640])
def test_pool_kernels_every_width(cuda_device, variant, sort, dtype, d):
    """D 1 and 3: the scalar path; 4: one vector per row (one row per
    lane in the run kernel); 128: one vector per lane over a warp; 640:
    five 128-column slices.  Integer-valued fp32 sums are bit-equal to
    the plain version."""
    kernel = _pool_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(20 + d)
    vals = torch.randn(500, d, generator=g, device=cuda_device).to(dtype)
    ids = _ids(g, 500, 90, sort, cuda_device)
    for reduce in ("sum", "max", "min"):
        _check_pool(kernel, vals, ids, 90, reduce)
    ints = torch.randint(-8, 8, (500, d), generator=g, device=cuda_device
                         ).to(torch.float32)
    assert torch.equal(kernel(ints, ids, n_segments=90),
                       segment_pool_ref(ints, ids, n_segments=90))


@pytest.mark.parametrize("variant", POOL_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 128])
def test_pool_kernels_unaligned_values(cuda_device, variant, dtype, d):
    """A contiguous view at storage offset 1: its rows start off the
    16-byte (8-byte for bf16) vector boundary, so the kernel takes its
    scalar path."""
    kernel = _pool_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(30 + d)
    flat = torch.randn(300 * d + 1, generator=g, device=cuda_device)
    vals = flat.to(dtype)[1:].view(300, d)
    assert vals.is_contiguous() and vals.storage_offset() == 1
    ids = _ids(g, 300, 40, True, cuda_device)
    for reduce in ("sum", "max", "min"):
        _check_pool(kernel, vals, ids, 40, reduce)


@pytest.mark.parametrize("variant", POOL_VARIANTS)
@pytest.mark.parametrize("d", [4, 128])
def test_pool_kernels_runs_over_many_tiles(cuda_device, variant, d):
    """Sorted runs of 200 and 700 rows cross 3 and more 16-row tiles at D
    128 and 32-row warp groups at D 4 (D < 32), and meet again in the
    accumulator; the padding rows form a long run of their own at the
    end."""
    kernel = _pool_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(40 + d)
    lengths = torch.tensor([200, 1, 31, 700, 33, 64, 5, 300],
                           device=cuda_device)
    ids = torch.repeat_interleave(
        torch.tensor([0, 1, 2, 4, 5, 7, 8, 9], device=cuda_device),
        lengths).to(torch.int32)  # 9: padding (n = 9); 3 and 6 empty
    e = ids.numel()
    vals = torch.randn(e, d, generator=g, device=cuda_device)
    for reduce in ("sum", "max", "min"):
        _check_pool(kernel, vals, ids, 9, reduce)
    ints = torch.randint(-8, 8, (e, d), generator=g, device=cuda_device
                         ).to(torch.float32)
    assert torch.equal(kernel(ints, ids, n_segments=9),
                       segment_pool_ref(ints, ids, n_segments=9))


@pytest.mark.parametrize("variant", POOL_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernels_empty_shapes(cuda_device, variant, dtype):
    """E = 0 gives zeros (and still counts as a launch: the call fills the
    output on the card); N = 0 gives [0, D] and launches nothing; rows
    that are all padding (ids >= N and < 0) give zeros; segments with no
    row read 0 under max and min too."""
    kernel = _pool_kernel(variant)
    d = 8
    for reduce in ("sum", "max", "min"):
        before = kernel.launches
        out = kernel(torch.empty(0, d, device=cuda_device, dtype=dtype),
                     torch.empty(0, dtype=torch.int32, device=cuda_device),
                     n_segments=5, reduce=reduce)
        assert kernel.launches == before + 1
        assert out.shape == (5, d) and out.dtype == dtype
        assert not out.any()
        vals = torch.randn(6, d, device=cuda_device).to(dtype)
        out = kernel(vals, torch.arange(6, dtype=torch.int32,
                                        device=cuda_device),
                     n_segments=0, reduce=reduce)
        assert out.shape == (0, d) and kernel.launches == before + 1
        pad = torch.tensor([5, 9, -1, -7, 5, 6], dtype=torch.int32,
                           device=cuda_device)
        assert not kernel(vals, pad, n_segments=5, reduce=reduce).any()
        ids = torch.tensor([0, 0, 3, 3, 3, 9], dtype=torch.int32,
                           device=cuda_device)
        got = kernel(-vals.abs() - 1, ids, n_segments=5, reduce=reduce)
        _check_pool(kernel, -vals.abs() - 1, ids, 5, reduce)
        assert not got[[1, 2, 4]].any()


# device kernels per call: an fp32 sum is the scatter (segment_pool) or
# the scatter and its carry fold (segment_pool_runs, carry.cuh); max and
# min add a finalize pass, a bf16 sum its cast
POOL_BUDGET = {"segment_pool": (1, 2, 2, 2),
               "segment_pool_runs": (2, 2, 2, 3)}


@pytest.mark.parametrize("variant", POOL_VARIANTS)
def test_pool_kernels_launch_budget(cuda_device, variant):
    """Device kernels per call from torch.profiler, exactly POOL_BUDGET
    (fp32 sum, max, min, bf16 sum), each after at most one memset."""
    kernel = _pool_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(50)
    vals = torch.randn(400, 128, generator=g, device=cuda_device)
    ids = _ids(g, 400, 60, True, cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for (reduce, dtype), want in zip((("sum", torch.float32),
                                      ("max", torch.float32),
                                      ("min", torch.float32),
                                      ("sum", torch.bfloat16)),
                                     POOL_BUDGET[variant]):
        x = vals.to(dtype)
        kernel(x, ids, n_segments=60, reduce=reduce)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            kernel(x, ids, n_segments=60, reduce=reduce)
            torch.cuda.synchronize()
        device = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        memsets = sum(ev.count for ev in device
                      if "memset" in ev.key.lower())
        kernels = sum(ev.count for ev in device) - memsets
        assert kernels == want, (reduce, dtype, device)
        assert memsets <= 1, (reduce, dtype, device)


def test_mean_pool_and_degree_do_not_sync_the_host(cuda_device):
    """The count of the mean and node_degree is a fixed-size index_add_:
    under set_sync_debug_mode("error") neither mean pooling (either
    kernel) nor node_degree makes the host wait on the card."""
    from repro_torch.core import ops
    from repro_torch.core.graph_tensor import SOURCE, TARGET
    graph, _ = _small_batch(cuda_device)
    feat = torch.ones(graph.edge_sets["has_topic"].capacity, 16,
                      device=cuda_device)

    def run():
        outs = [ops.node_degree(graph, "has_topic", tag)
                for tag in (SOURCE, TARGET)]
        for hint in (True, False):
            with registry.layout(sorted_by_target=hint):
                outs.append(ops.pool_edges_to_node(
                    graph, "has_topic", TARGET, "mean", feature_value=feat))
        return outs

    want = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_unsorted_segments(cuda_device, causal, dtype):
    """Unsorted ids: every kv tile's id range spans the q tile's, so the
    skip rule skips nothing and the element mask does the work."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(15)
    q, k, v = _qkv(g, 2, 300, 300, 4, 2, 32, dtype, cuda_device)
    seg = torch.randint(0, 5, (2, 300), generator=g, device=cuda_device,
                        dtype=torch.int32)
    got = flash_attention(q, k, v, seg, causal=causal)
    tol = _flash_tol(dtype)
    torch.testing.assert_close(got, attention_ref(q, k, v, seg,
                                                  causal=causal),
                               rtol=tol, atol=tol)


def test_flash_kernel_tile_range_straddles_with_no_match(cuda_device):
    """A kv tile whose ids (4 and 6) span the q tile's one id (5) without
    holding it is visited and masked to nothing; with no key of id 5 at
    all, every query emits an exact 0."""
    from repro_torch.kernels.flash_attention.kernel import (BLOCK_K,
                                                            flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(16)
    q, k, v = _qkv(g, 1, 64, 4 * BLOCK_K, 2, 2, 64, torch.float32,
                   cuda_device)
    q_seg = torch.full((1, 64), 5, dtype=torch.int32, device=cuda_device)
    kv_seg = torch.tensor([4, 6] * (BLOCK_K // 2) + [5] * BLOCK_K
                          + [7] * BLOCK_K + [4, 6] * (BLOCK_K // 2),
                          dtype=torch.int32, device=cuda_device)[None]
    got = flash_attention(q, k, v, q_seg, kv_seg, causal=False)
    torch.testing.assert_close(
        got, attention_ref(q, k, v, q_seg, kv_seg, causal=False),
        rtol=1e-5, atol=1e-5)
    none = torch.where(kv_seg == 5, 6, kv_seg).to(torch.int32)
    assert not flash_attention(q, k, v, q_seg, none, causal=False).any()


@pytest.mark.parametrize("d", [1, 20, 100, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_any_head_width(cuda_device, d, dtype):
    """Widths that are not multiples of 8 (zero padding in shared memory,
    and the scalar copy for rows not 16-byte aligned), segmented and
    causal."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(17 + d)
    q, k, v = _qkv(g, 1, 150, 150, 2, 1, d, dtype, cuda_device)
    seg = torch.sort(torch.randint(0, 3, (1, 150), generator=g,
                                   device=cuda_device,
                                   dtype=torch.int32)).values
    tol = _flash_tol(dtype)
    for causal in (True, False):
        torch.testing.assert_close(
            flash_attention(q, k, v, seg, causal=causal),
            attention_ref(q, k, v, seg, causal=causal), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_gqa_causal_d128(cuda_device, dtype):
    """GQA with G = 5 query heads per kv head, 128 wide, causal: the LM
    prefill's form at a ragged length."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(18)
    q, k, v = _qkv(g, 2, 333, 333, 10, 2, 128, dtype, cuda_device)
    tol = _flash_tol(dtype)
    torch.testing.assert_close(flash_attention(q, k, v, causal=True),
                               attention_ref(q, k, v, causal=True),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bit_identical_segmented_and_causal(
        cuda_device, dtype):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    g = torch.Generator(device=cuda_device).manual_seed(19)
    q, k, v = _qkv(g, 1, 1000, 1000, 8, 8, 128, dtype, cuda_device)
    seg = torch.clamp(torch.arange(1000, device=cuda_device) // 240,
                      max=3).to(torch.int32)[None]
    for args, kw in (((q, k, v, seg), dict(causal=False)),
                     ((q, k, v), dict(causal=True))):
        first = flash_attention(*args, **kw)
        for _ in range(3):
            assert torch.equal(flash_attention(*args, **kw), first)


def _sq_for_rows(rows, sms):
    """An Sq whose grid, at b = 2 and h = 4, gives CTAs of `rows` row
    groups on a card of `sms` SMs: the most of 4, 2 and 1 whose
    b * h * ceil(Sq / (16 rows)) CTAs still give every SM two."""
    n = 2 * sms
    return {1: 32 * ((n - 1) // 8) - 7, 2: 64 * ((n - 1) // 8) - 7,
            4: 64 * -(-n // 8) + 3}[rows]


@pytest.mark.parametrize("dtype,d,cta", [
    (torch.float32, 64, (4, 1)), (torch.float32, 64, (2, 2)),
    (torch.float32, 256, (2, 1)), (torch.float32, 64, (1, 4)),
    (torch.float32, 128, (1, 2)), (torch.float32, 256, (1, 1)),
    (torch.bfloat16, 64, (4, 1)), (torch.bfloat16, 256, (2, 2)),
    (torch.bfloat16, 128, (1, 4)), (torch.bfloat16, 256, (1, 2))])
def test_flash_kernel_every_cta_shape(cuda_device, dtype, d, cta):
    """Each CTA of row groups x kv splits the C entry chooses, reached by
    the grid's size (the row groups) and the head width (the kv splits
    that fit in shared memory), on a segmented and a causal call whose
    rows visit many kv tiles (the splits' merge), against the plain
    version; the entry reports the CTA it chose."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            last_cta)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    sq = _sq_for_rows(cta[0], sms)
    g = torch.Generator(device=cuda_device).manual_seed(20)
    q, k, v = _qkv(g, 2, sq, sq, 4, 2, d, dtype, cuda_device)
    seg = torch.sort(torch.randint(0, 3, (2, sq), generator=g,
                                   device=cuda_device,
                                   dtype=torch.int32)).values
    tol = _flash_tol(dtype)
    for ids, causal in ((seg, False), (None, True)):
        got = flash_attention(q, k, v, ids, causal=causal)
        assert last_cta() == cta
        torch.testing.assert_close(
            got, attention_ref(q, k, v, ids, causal=causal), rtol=tol,
            atol=tol)


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


# ---------------------------------------------------------------------------
# the edge kernels' tile product (edge_mpnn/edge_mma.cuh): ragged K and M,
# the scalar-copy form, empty and padding-only edge sets, 16-bit inputs on
# the tensor cores, W streamed past shared memory, the persistent grid,
# runs across many tiles, and the launch budget
# ---------------------------------------------------------------------------

EDGE_VARIANTS = ["edge_mpnn", "edge_mpnn_runs"]


def _edge_kernel(variant):
    from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
    return getattr(mpnn_kernel, variant)


def _edge_inputs(g, device, n_src, n_tgt, ds, dt, m, src, tgt,
                 dtype=torch.float32, offset=0):
    """(h_src, h_tgt, src, tgt, w, b) in `dtype`; with `offset`, every
    float tensor is a contiguous view at that storage offset."""
    def rand(*shape, scale=1.0):
        n = 1
        for s in shape:
            n *= s
        flat = scale * torch.randn(n + offset, generator=g, device=device)
        return flat.to(dtype)[offset:].view(*shape)

    return (rand(n_src, ds), rand(n_tgt, dt), src.to(torch.int32),
            tgt.to(torch.int32), rand(ds + dt, m, scale=(ds + dt) ** -0.5),
            rand(m, scale=0.1))


def _check_edge(kernel, args, n_src, n_tgt, activation="relu", tile=0):
    """kernel (at tile height `tile`) vs plain: fp32 within rtol/atol 1e-5
    plus the summation-order bound 2 k 2**-24 sum|terms| of a row of k
    edges (atomics, runs and index_add_ add in different orders); 16-bit
    within 2e-2 (the cast back).  The dtype and shape are kept, and the
    launch is counted."""
    before = kernel.launches
    got = kernel(*args, n_src=n_src, n_tgt=n_tgt, activation=activation,
                 tile=tile)
    want = edge_mpnn_ref(*args, n_src=n_src, n_tgt=n_tgt,
                         activation=activation)
    assert got.dtype == args[0].dtype and got.shape == want.shape
    assert kernel.launches == before + (got.numel() > 0)
    if got.dtype != torch.float32:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        return got
    h_src, h_tgt, src, tgt, w, b = args
    # per row, sum over its edges of |x| @ |W| + |b|: bounds the messages
    # and the size of their products' terms
    abs_sum = edge_mpnn_ref(h_src.abs(), h_tgt.abs(), src, tgt, w.abs(),
                            b.abs(), n_src=n_src, n_tgt=n_tgt,
                            activation="identity")
    valid = (tgt >= 0) & (tgt < n_tgt)
    rows = torch.zeros(n_tgt + 1, device=got.device).index_add_(
        0, torch.where(valid, tgt, n_tgt).long(),
        torch.ones_like(tgt, dtype=torch.float32))[:n_tgt, None]
    tol = 1e-5 * (1 + want.abs()) + 2 * rows * 2.0 ** -24 * abs_sum
    assert bool(((got - want).abs() <= tol).all()), \
        (got - want).abs().max().item()
    return got


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("ds,dt", [(100, 28), (5, 3)])
@pytest.mark.parametrize("m", [8, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_kernels_ragged_k_and_m(cuda_device, variant, ds, dt, m,
                                     dtype):
    """Ds 100 + Dt 28: the K chunk 96..127 straddles Ds (fp32 16-byte
    copies; bf16 takes the scalar form, 100 % 8 != 0); Ds 5 + Dt 3: one
    partial chunk, scalar form.  M 8: one column tile mostly masked; M 130:
    three, the last 2 wide (and odd groups for the vector atomics)."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(60 + ds + m)
    src = torch.randint(0, 50, (333,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 75, (333,), generator=g, device=cuda_device)
    args = _edge_inputs(g, cuda_device, 50, 70, ds, dt, m, src,
                        torch.sort(tgt).values, dtype)
    for activation in ("relu", "gelu", "identity"):
        _check_edge(kernel, args, 50, 70, activation)


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_edge_kernels_storage_offset_takes_the_scalar_form(
        cuda_device, variant, dtype):
    """Every float input a contiguous view at storage offset 1: rows off
    the 16-byte boundary, so the kernel copies element by element; same
    result as the plain version."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(70)
    src = torch.randint(0, 40, (300,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 64, (300,), generator=g, device=cuda_device)
    args = _edge_inputs(g, cuda_device, 40, 60, 128, 128, 96, src, tgt,
                        dtype, offset=1)
    assert args[0].storage_offset() == 1 and args[0].is_contiguous()
    _check_edge(kernel, args, 40, 60)


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_edge_kernels_empty_single_and_padding_edges(cuda_device, variant,
                                                     dtype):
    """E = 0 gives zeros (and counts a launch: the call zeroes the output
    on the card); E = 1 one row; every edge padding (tgt >= n_tgt or < 0)
    gives zeros."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(80)
    none = torch.empty(0, dtype=torch.int64, device=cuda_device)
    out = _check_edge(kernel, _edge_inputs(g, cuda_device, 5, 7, 16, 16,
                                           32, none, none, dtype), 5, 7)
    assert not out.any()
    one = torch.tensor([3], device=cuda_device)
    out = _check_edge(kernel, _edge_inputs(g, cuda_device, 5, 7, 16, 16, 32,
                                           one, one, dtype), 5, 7)
    assert out[3].any() and not out[[0, 1, 2, 4, 5, 6]].any()
    pad = torch.tensor([7, 9, -1, -5, 7, 100], device=cuda_device)
    out = _check_edge(kernel, _edge_inputs(g, cuda_device, 5, 7, 16, 16, 32,
                                           pad.abs() % 5, pad, dtype), 5, 7)
    assert not out.any()


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_kernels_stream_w_past_shared_memory(cuda_device, variant,
                                                  dtype):
    """K = 2048: W's column slice no longer fits shared memory, so the
    kernel streams it through the ring with the gathered rows."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(90)
    src = torch.randint(0, 200, (700,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 310, (700,), generator=g, device=cuda_device)
    args = _edge_inputs(g, cuda_device, 200, 300, 1024, 1024, 96, src, tgt,
                        dtype)
    _check_edge(kernel, args, 200, 300, "gelu")


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
def test_edge_kernels_persistent_grid(cuda_device, variant):
    """60000 edges in fp32 tiles of 32 x 2 column tiles = 3750 tiles, more
    than 2 CTAs per SM: each CTA walks several edge tiles with its W slice
    loaded once."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(100)
    src = torch.randint(0, 20000, (60000,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 20100, (60000,), generator=g, device=cuda_device)
    args = _edge_inputs(g, cuda_device, 20000, 20000, 128, 128, 128, src,
                        torch.sort(tgt).values)
    _check_edge(kernel, args, 20000, 20000)


def test_edge_mpnn_runs_across_many_tiles(cuda_device):
    """Sorted runs of 200, 700 and 300 edges cross several edge tiles (32
    edges fp32, 64 bf16) and walker quarters and meet again in the
    accumulator; the padding edges form a long run of their own at the
    end."""
    kernel = _edge_kernel("edge_mpnn_runs")
    g = torch.Generator(device=cuda_device).manual_seed(110)
    lengths = torch.tensor([200, 1, 31, 700, 33, 64, 5, 300],
                           device=cuda_device)
    tgt = torch.repeat_interleave(
        torch.tensor([0, 1, 2, 4, 5, 7, 8, 9], device=cuda_device),
        lengths)  # 9: padding (n_tgt = 9); 3 and 6 receive nothing
    src = torch.randint(0, 30, (tgt.numel(),), generator=g,
                        device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        args = _edge_inputs(g, cuda_device, 30, 9, 64, 64, 64, src, tgt,
                            dtype)
        out = _check_edge(kernel, args, 30, 9, "identity")
        assert not out[[3, 6]].any()


# device kernels per call (fp32, bf16, fp16): the edge kernel (the fp32
# output is its own accumulator), edge_mpnn_runs' carry fold (carry.cuh),
# and the cast back of a 16-bit output
EDGE_BUDGET = {"edge_mpnn": (1, 2, 2), "edge_mpnn_runs": (2, 3, 3)}


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
def test_edge_kernels_launch_budget(cuda_device, variant):
    """Device work per call from torch.profiler: exactly EDGE_BUDGET
    kernels after at most one memset."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(120)
    src = torch.randint(0, 100, (500,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 130, (500,), generator=g, device=cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for dtype, want in zip((torch.float32, torch.bfloat16, torch.float16),
                           EDGE_BUDGET[variant]):
        args = _edge_inputs(g, cuda_device, 100, 120, 64, 64, 128, src, tgt,
                            dtype)
        kernel(*args, n_src=100, n_tgt=120)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            kernel(*args, n_src=100, n_tgt=120)
            torch.cuda.synchronize()
        device = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        memsets = sum(ev.count for ev in device
                      if "memset" in ev.key.lower())
        kernels = sum(ev.count for ev in device) - memsets
        assert memsets <= 1, (dtype, device)
        assert kernels == want, (dtype, device)


# ---------------------------------------------------------------------------
# the run kernels fold in a fixed order on sorted ids (carry.cuh)
# ---------------------------------------------------------------------------

REPEATS = 20


def trained_like_ids(device, seed=0):
    """(ids, n): the trained batch's has_topic shape — E 5175 sorted
    targets into n 1409 rows, 1051 short runs then one 2697-row run into
    a valid id (the padding node)."""
    rng = torch.Generator().manual_seed(seed)
    # 2478 rows before the long run, at least one a run
    short = 1 + torch.bincount(torch.randint(0, 1051, (2478 - 1051,),
                                             generator=rng), minlength=1051)
    rows = torch.sort(torch.randperm(1408, generator=rng)[:1051]).values
    ids = torch.cat([torch.repeat_interleave(rows, short),
                     torch.full((2697,), 1408)])
    return ids.to(torch.int32).to(device), 1409


def drawn_ids(lengths, device, pad=0):
    """Sorted ids: run i of lengths[i] rows has id 2 i (odd ids stay
    empty), then `pad` padding rows (id n)."""
    n = 2 * len(lengths)
    ids = torch.repeat_interleave(torch.arange(0, n, 2),
                                  torch.tensor(lengths))
    ids = torch.cat([ids, torch.full((pad,), n)])
    return ids.to(torch.int32).to(device), n


def _repeats(fn):
    first = fn()
    torch.cuda.synchronize()
    for _ in range(REPEATS - 1):
        assert torch.equal(fn(), first)
    return first


def _edge_args(g, n_src, n_tgt, e, width, device):
    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)

    src = torch.randint(0, n_src, (e,), generator=g, device=device,
                        dtype=torch.int32)
    return (rand(n_src, width), rand(n_tgt, width), src,
            rand(2 * width, width, scale=(2 * width) ** -0.5),
            rand(width, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 128])
def test_segment_pool_runs_repeats_at_the_trained_shape(cuda_device, dtype,
                                                        d):
    """Real-valued sums over sorted ids, the 2697-row run included: 20
    calls give the same bits, and they match the plain version; shuffled
    ids still give the right sums."""
    ids, n = trained_like_ids(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(60 + d)
    vals = torch.randn(ids.numel(), d, generator=g,
                       device=cuda_device).to(dtype)
    got = _repeats(lambda: segment_pool_runs(vals, ids, n_segments=n))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = segment_pool_ref(vals, ids, n_segments=n)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    perm = torch.randperm(ids.numel(), generator=g, device=cuda_device)
    torch.testing.assert_close(
        segment_pool_runs(vals[perm], ids[perm], n_segments=n), want,
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_mpnn_runs_repeats_at_the_trained_shape(cuda_device, dtype):
    """The trained conv's shape (1461 sources, 1409 targets, E 5175, 128
    wide, the 2697-edge run): 20 calls give the same bits and match the
    plain version; shuffled edges still give the right result."""
    ids, n = trained_like_ids(cuda_device, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(61)
    h_src, h_tgt, src, w, b = _edge_args(g, 1461, n, ids.numel(), 128,
                                         cuda_device)
    args = [t.to(dtype) for t in (h_src, h_tgt, w, b)]
    kw = dict(n_src=1461, n_tgt=n)
    got = _repeats(lambda: edge_mpnn_runs(args[0], args[1], src, ids,
                                          args[2], args[3], **kw))
    want = edge_mpnn_ref(args[0], args[1], src, ids, args[2], args[3], **kw)
    # the long run sums 2697 messages: hold it relative to its magnitude
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scale = want.abs().amax(1, keepdim=True).float().clamp(min=1.0)
    torch.testing.assert_close((got.float() / scale), want.float() / scale,
                               rtol=tol, atol=tol)
    perm = torch.randperm(ids.numel(), generator=g, device=cuda_device)
    shuffled = edge_mpnn_runs(args[0], args[1], src[perm], ids[perm],
                              args[2], args[3], **kw)
    torch.testing.assert_close(shuffled.float() / scale,
                               want.float() / scale, rtol=tol, atol=tol)


try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # the card's machine has hypothesis; the sweep
    hypothesis = None  # below covers its absence

RUN_LENGTHS = st.lists(st.integers(1, 3000), min_size=1, max_size=10) \
    if hypothesis is not None else None


def _check_drawn_runs(device, lengths, pad, d):
    ids, n = drawn_ids(lengths, device, pad)
    g = torch.Generator(device=device).manual_seed(sum(lengths) % 1000)
    vals = torch.randn(ids.numel(), d, generator=g, device=device)
    got = _repeats(lambda: segment_pool_runs(vals, ids, n_segments=n))
    want = segment_pool_ref(vals, ids, n_segments=n)
    scale = segment_pool_ref(vals.abs(), ids, n_segments=n).clamp(min=1.0)
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-5,
                               atol=1e-5)
    h_src, h_tgt, src, w, b = _edge_args(g, 97, n, ids.numel(), 64, device)
    kw = dict(n_src=97, n_tgt=n)
    got = _repeats(lambda: edge_mpnn_runs(h_src, h_tgt, src, ids, w, b,
                                          **kw))
    want = edge_mpnn_ref(h_src, h_tgt, src, ids, w, b, **kw)
    scale = want.abs().amax(1, keepdim=True).clamp(min=1.0)
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", range(6))
def test_run_kernels_repeat_on_drawn_runs_sweep(cuda_device, case):
    """Seeded sorted run lengths of 1 to 3000 rows (and padding rows),
    D 4 and 128 for the pool, 64 wide for the edge kernel."""
    rng = torch.Generator().manual_seed(case)
    lengths = torch.randint(1, 3001, (int(torch.randint(
        1, 11, (1,), generator=rng)),), generator=rng).tolist()
    _check_drawn_runs(cuda_device, lengths, 7 * case, 4 if case % 2
                      else 128)


if hypothesis is not None:
    @hypothesis.given(RUN_LENGTHS, st.integers(0, 40),
                      st.sampled_from([4, 128]))
    @hypothesis.settings(max_examples=15, deadline=None,
                         suppress_health_check=[
                             hypothesis.HealthCheck.function_scoped_fixture])
    def test_run_kernels_repeat_on_hypothesis_runs(cuda_device, lengths,
                                                   pad, d):
        """Hypothesis-drawn sorted run lengths of 1 to 3000 rows."""
        _check_drawn_runs(cuda_device, lengths, pad, d)


# ---------------------------------------------------------------------------
# the sampler-fleet path: pinned double-buffered placement, and the
# service runner on the card
# ---------------------------------------------------------------------------

def _fleet_problem():
    """A small synthetic MAG, the cites/written spec, 64 roots and the
    size constraints of an 8-root batch (all host-side numpy)."""
    from repro_torch.core.schema import mag_schema
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.sampling import (InMemorySampler,
                                           SamplingSpecBuilder)
    from repro_torch.data.synthetic import synthetic_mag
    store, _ = synthetic_mag(n_papers=400, n_authors=100, n_institutions=8,
                             n_fields=24, n_classes=8, feat_dim=32)
    b = SamplingSpecBuilder(mag_schema())
    seed_op = b.seed("paper")
    seed_op.sample(8, "cites").join([seed_op]).sample(4, "written")
    spec = seed_op.build()
    roots = list(range(64))
    graphs = InMemorySampler(store, spec, seed=0).sample(roots)
    return store, spec, roots, graphs, find_size_constraints(graphs, 8)


def _assert_placed_equal(got, want):
    from repro_torch.train.train_loop import _tensors
    got, want = list(_tensors(got)), list(_tensors(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_device_prefetch_equals_to_device_over_epochs(cuda_device):
    """Two epochs at depth 2 through pinned buffers and the side stream,
    with a slow consumer (the copies run ahead, pinned and device blocks
    are freed and handed out again): every batch bit-identical to a
    blocking `to_device`, when it arrives and again after the epochs."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.pipeline import GraphBatcher
    from repro_torch.orchestration.tasks import (
        RootNodeMulticlassClassification)
    from repro_torch.train.train_loop import device_prefetch
    _, _, _, graphs, sizes = _fleet_problem()
    batcher = GraphBatcher(graphs, 8, sizes, seed=0)
    task = RootNodeMulticlassClassification("paper", 8, 16)
    calls = []

    def place(graph, labels, non_blocking=False):
        calls.append(non_blocking)
        lab = torch.as_tensor(labels).pin_memory()
        return (to_device(graph, cuda_device, non_blocking=non_blocking),
                lab.to(cuda_device, non_blocking=non_blocking))

    kept, spin = [], torch.randn(2048, 2048, device=cuda_device)
    for epoch in (0, 1):
        pairs = [(g, task.labels(g)) for g in batcher.epoch(epoch)]
        for (graph, labels), placed in zip(pairs, device_prefetch(
                iter(pairs), place, depth=2, device=cuda_device)):
            for _ in range(20):  # keep the consumer's stream busy
                spin = torch.tanh(spin @ spin * 1e-3)
            want = (to_device(graph, cuda_device),
                    torch.as_tensor(labels).to(cuda_device))
            _assert_placed_equal(placed, want)
            kept.append((placed, want))
    torch.cuda.synchronize()
    assert calls and all(calls) and len(kept) == 2 * batcher.num_steps
    for placed, want in kept:
        _assert_placed_equal(placed, want)


def test_runner_service_thread_fleet_repeats_bit_for_bit(cuda_device):
    """runner.run(sampler="service") over a thread fleet on the card,
    twice from the same draw: the same losses, bit for bit (the batches
    are target-sorted, and the run kernels fold in a fixed order)."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE
    from repro_torch.core.models import vanilla_mpnn
    from repro_torch.nn.layers import Embedding, Linear
    from repro_torch.orchestration import runner
    from repro_torch.orchestration.tasks import (
        RootNodeMulticlassClassification)
    from repro_torch.sampling_service import SamplingService
    store, spec, roots, _, sizes = _fleet_problem()
    dim = 16

    class Init(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.paper = Linear(32, dim)
            self.author = Embedding(128, dim)

        def forward(self, graph):
            ids = graph.node_sets["author"]["id"] % 128
            return graph.replace_features(node_sets={
                "paper": {HIDDEN_STATE: torch.relu(self.paper(
                    graph.node_sets["paper"]["feat"]))},
                "author": {HIDDEN_STATE: self.author(
                    ids, dtype=torch.float32)}})

    def model_fn():
        return Init(), vanilla_mpnn(
            {"cites": ("paper", "paper"), "written": ("paper", "author")},
            {"paper": dim, "author": dim}, message_dim=dim, hidden_dim=dim,
            num_rounds=2)

    task = RootNodeMulticlassClassification("paper", 8, dim)
    runs = []
    for _ in range(2):
        with SamplingService(store, spec, roots, batch_size=8, sizes=sizes,
                             num_workers=2, seed=0,
                             backend="thread") as svc:
            runs.append(runner.run(
                model_fn=model_fn, task=task, epochs=2, learning_rate=3e-3,
                total_steps=100, log_every=10 ** 6, max_steps=12,
                sampler="service", service=svc, label_fn=task.labels,
                device=cuda_device))
    assert runs[0].step == 12
    losses = runs[0].metrics["train_losses"]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses == runs[1].metrics["train_losses"]


# ---------------------------------------------------------------------------
# the tile heights kernels/autotune.py picks among, a tile that is not
# built, and tuned records through the registry's consult
# ---------------------------------------------------------------------------

EDGE_TILES = [(torch.float32, 32), (torch.float32, 64),
              (torch.float32, 128), (torch.bfloat16, 64),
              (torch.float16, 64)]


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("dtype,tile", EDGE_TILES)
@pytest.mark.parametrize("sort", [True, False])
def test_edge_kernels_every_tile(cuda_device, variant, dtype, tile, sort):
    """E 1001 (a ragged last tile at every height) with a 300-edge run
    into one target, 128 + 128 -> 130 (a partial column tile): each
    height against the plain version; on sorted targets the run kernel
    repeats bit for bit at every height."""
    kernel = _edge_kernel(variant)
    g = torch.Generator(device=cuda_device).manual_seed(110 + tile)
    src = torch.randint(0, 300, (1001,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 210, (1001,), generator=g, device=cuda_device)
    tgt[:300] = 17
    if sort:
        tgt = torch.sort(tgt).values
    args = _edge_inputs(g, cuda_device, 300, 200, 128, 128, 130, src, tgt,
                        dtype)
    got = _check_edge(kernel, args, 300, 200, "gelu", tile)
    if sort and variant == "edge_mpnn_runs":
        for _ in range(4):
            assert torch.equal(kernel(*args, n_src=300, n_tgt=200,
                                      activation="gelu", tile=tile), got)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 640])
def test_pool_run_kernel_every_tile(cuda_device, tile, sort, dtype, d):
    """segment_pool_runs at 16- and 32-row tiles, from one 32-column slice
    to five 128-column ones, with a 900-row run: sum, max and min against
    the plain version; sorted sums repeat bit for bit."""
    from repro_torch.kernels.segment_pool.kernel import segment_pool_runs
    g = torch.Generator(device=cuda_device).manual_seed(120 + d)
    vals = torch.randn(2001, d, generator=g, device=cuda_device).to(dtype)
    ids = torch.randint(0, 95, (2001,), generator=g, device=cuda_device)
    ids[100:1000] = 40
    if sort:
        ids = torch.sort(ids).values
    ids = ids.to(torch.int32)
    for reduce in ("sum", "max", "min"):
        _check_pool(segment_pool_runs, vals, ids, 90, reduce, tile)
    if sort:
        first = segment_pool_runs(vals, ids, n_segments=90, tile=tile)
        for _ in range(4):
            assert torch.equal(
                segment_pool_runs(vals, ids, n_segments=90, tile=tile), first)


def test_a_tile_that_is_not_built_is_refused(cuda_device, monkeypatch):
    """The wrappers raise on a tile their kernel is not built for; with
    that check lifted, the C entries refuse it themselves
    (cudaErrorInvalidValue, nothing launched) and the wrapper raises."""
    from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
    from repro_torch.kernels.segment_pool import kernel as seg_kernel
    g = torch.Generator(device=cuda_device).manual_seed(130)
    idx = torch.randint(0, 40, (100,), generator=g, device=cuda_device)
    args = _edge_inputs(g, cuda_device, 40, 40, 64, 64, 64, idx, idx)
    vals = torch.randn(100, 64, device=cuda_device)
    narrow = torch.randn(100, 4, device=cuda_device)
    ids = idx.to(torch.int32)
    with pytest.raises(ValueError, match="tile"):
        mpnn_kernel.edge_mpnn(*args, n_src=40, n_tgt=40, tile=48)
    with pytest.raises(ValueError, match="tile"):
        seg_kernel.segment_pool_runs(narrow, ids, n_segments=40, tile=16)
    monkeypatch.setattr(mpnn_kernel, "tiles", lambda *a: (48,))
    monkeypatch.setattr(seg_kernel, "tiles", lambda *a: (16, 48))
    for variant in EDGE_VARIANTS:
        kernel = getattr(mpnn_kernel, variant)
        before = kernel.launches
        with pytest.raises(RuntimeError, match="error 1"):
            kernel(*args, n_src=40, n_tgt=40, tile=48)
        assert kernel.launches == before
    for x, tile in ((vals, 48), (narrow, 16)):
        before = seg_kernel.segment_pool_runs.launches
        with pytest.raises(RuntimeError, match="error 1"):
            seg_kernel.segment_pool_runs(x, ids, n_segments=40, tile=tile)
        assert seg_kernel.segment_pool_runs.launches == before


def test_autotune_records_drive_the_registry(cuda_device, tmp_path,
                                             monkeypatch):
    """tune_segment_pool / tune_edge_mpnn on the card into a temporary
    file: each record names a built tile and its candidates; under the
    consult the decisions at those shapes read it, and the registry's
    outputs match the plain versions; off, the reasons are the layout
    rule's."""
    from repro_torch.kernels import autotune
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH",
                        tmp_path / "autotune_cache_cuda.json")
    autotune._LOADED.clear()
    pool = autotune.tune_segment_pool(64, 128, sorted_ids=True,
                                      n_edges=1000, iters=3)
    assert pool["variant"] == "segment_pool_runs" and pool["tile"] in (16, 32)
    assert set(pool["candidates"]) == {"segment_pool/0",
                                       "segment_pool_runs/16",
                                       "segment_pool_runs/32"}
    assert pool["default_us"] == pool["candidates"]["segment_pool_runs/16"]
    edge = autotune.tune_edge_mpnn(50, 70, 64, 64, 96, sorted_ids=False,
                                   n_edges=700, iters=3)
    assert len(edge["candidates"]) == 6
    assert edge["default_us"] == edge["candidates"]["edge_mpnn/32"]
    assert edge["us"] == min(edge["candidates"].values())
    g = torch.Generator(device=cuda_device).manual_seed(140)
    vals = torch.randn(1000, 128, generator=g, device=cuda_device)
    ids = torch.sort(torch.randint(0, 64, (1000,), generator=g,
                                   device=cuda_device)).values
    src = torch.randint(0, 50, (700,), generator=g, device=cuda_device)
    tgt = torch.randint(0, 70, (700,), generator=g, device=cuda_device)
    h_src, h_tgt, src, tgt, w, b = _edge_inputs(g, cuda_device, 50, 70, 64,
                                                64, 96, src, tgt)
    registry.use_autotune(True)
    try:
        dec = registry.segment_reduce_decision(vals, True, n_segments=64)
        assert dec.reason == (f"autotuned:segment_pool_runs/{pool['tile']}"
                              "[sorted]")
        got = registry.segment_reduce(vals, ids, 64, sorted_ids=True)
        dec = registry.edge_mpnn_decision(h_src, "relu", False, h_tgt=h_tgt,
                                          w=w, n_edges=700)
        assert dec.reason == (f"autotuned:{edge['variant']}/{edge['tile']}"
                              "[unsorted]")
        got_edge = registry.edge_mpnn(h_src, h_tgt, src, tgt, w, b,
                                      n_src=50, n_tgt=70, sorted_ids=False)
    finally:
        registry.use_autotune(False)
    torch.testing.assert_close(got, segment_pool_ref(vals, ids,
                                                     n_segments=64),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_edge, edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=50, n_tgt=70),
        rtol=1e-5, atol=1e-5)
    assert registry.segment_reduce_decision(
        vals, True, n_segments=64).reason == "kernel:segment_pool_runs[sorted]"
    autotune._LOADED.clear()


def test_lm_engine_on_the_card_equals_the_cpu(cuda_device):
    import numpy as np

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.layers import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("qwen1.5-4b-smoke")
    cpu = init_params(build_model(cfg, "cpu"), 0)
    card = build_model(cfg, cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(5)]

    def run(model):
        return [r.generated for r in ServeEngine(
            cfg, model, n_slots=3, max_len=64).run(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]
    assert run(card) == run(cpu)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m-smoke",
                                  "rwkv6-3b-smoke", "zamba2-1.2b-smoke",
                                  "whisper-medium-smoke"])
def test_lm_family_on_the_card_equals_the_cpu(cuda_device, arch):
    import numpy as np

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.layers import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(arch)
    cpu = init_params(build_model(cfg, "cpu"), 0)
    card = build_model(cfg, cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(5)]
    audio = torch.from_numpy(rng.standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32))

    def forward(model):
        dev = model.embed.table.device
        extra = ({"audio_embeds": audio.to(dev)} if cfg.family == "audio"
                 else {})
        with torch.inference_mode():
            logits = model(torch.as_tensor(prompts[0][None].astype(np.int64),
                                           device=dev), **extra).logits
            if cfg.family != "audio":
                return logits.cpu(), [r.generated for r in ServeEngine(
                    cfg, model, n_slots=3, max_len=64).run(
                    [Request(prompt=p, max_new_tokens=6) for p in prompts])]
            out, cache = model.prefill(
                torch.as_tensor(prompts[0][None].astype(np.int64),
                                device=dev), max_len=16, **extra)
            toks = []
            for _ in range(6):
                toks.append(int(torch.argmax(out.logits[0, -1])))
                out, cache = model.decode_step(
                    torch.tensor([[toks[-1]]], device=dev), cache)
            return logits.cpu(), [toks]
    got, got_tokens = forward(card)
    want, want_tokens = forward(cpu)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert got_tokens == want_tokens


def test_flash_through_the_lm_attention(cuda_device):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.layers import init_params
    with torch.device(cuda_device):
        attn = init_params(Attention(256, 4, 2, 64, qkv_bias=True,
                                     use_flash=True), 0)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1, 1024, 256, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    before = flash_attention.launches
    with torch.inference_mode():
        got = attn(x)
        assert flash_attention.launches == before + 1
        attn.use_flash = False
        want = attn(x)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
