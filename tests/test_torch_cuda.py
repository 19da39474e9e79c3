"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test asks for the `cuda_device` fixture, which skips
where there is no CUDA device (the kernels have no CPU mode).  On a
machine with a card and no JAX, run ``PYTHONPATH=src python -m pytest -q
--noconftest tests/test_torch_cuda.py`` (tests/conftest.py imports jax);
chip_smoke.py makes the same checks at the served shapes.  Tolerances:
fp32 rtol/atol 1e-5 (atomic sums run in varying order), bf16 2e-2;
max/min exact.
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
