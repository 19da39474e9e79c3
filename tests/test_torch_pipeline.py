"""`repro_torch.distributed.pipeline_parallel.pipeline_apply` on 4 gloo
ranks of a "stage" mesh, on the CPU, against the reference's pipeline
test (`tests/test_serve.py` `PP_SCRIPT`: L 8, D 16, a batch of 8 in 4
microbatches, a ``tanh(h @ w)`` layer): one JAX subprocess (4 host
devices) draws the weights and input with `jax.random` and runs the
reference's `pipeline_apply`; the port's output on every rank is held
to it at rtol 2e-4 (the reference's own tolerance against the layers in
sequence), and so is the gradient of ``sum(out * ct)`` for a seeded
cotangent, ``jax.grad`` through the reference's GPipe loop: each rank's
stage slice of the weights' gradient, and the whole input gradient on
every rank.  The same world runs one qwen1.5-4b-smoke `DecoderBlock` a
stage over 4 microbatches against the 4 blocks in sequence (rtol 1e-5,
fp32), its gradient in the input and in each stage's block against the
sequence's (rtol 1e-4 / atol 1e-6), the forward alone under
`torch.no_grad()`, and checks the stage mesh's axes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_mesh_ranks as R  # noqa: E402 — its directory is on the path

from repro_torch.distributed.launch import run_ranks  # noqa: E402

JAX_PIPELINE = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.distributed.pipeline_parallel import pipeline_apply

    mesh = Mesh(np.array(jax.devices()).reshape(4,), ("stage",))
    L, D = 8, 16
    ws = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.2
    x = jax.random.normal(jax.random.PRNGKey(1), (8, D))

    def body(w, h):
        return jnp.tanh(h @ w)

    ct = jax.random.normal(jax.random.PRNGKey(2), (8, D))
    fn = pipeline_apply(body, mesh, n_microbatches=4)
    with mesh:
        out = jax.jit(fn)(ws, x)
        g_ws, g_x = jax.jit(jax.grad(lambda w, v: jnp.sum(fn(w, v) * ct),
                                     argnums=(0, 1)))(ws, x)
    np.savez({out!r}, ws=np.asarray(ws), x=np.asarray(x),
             out=np.asarray(out), ct=np.asarray(ct), g_ws=np.asarray(g_ws),
             g_x=np.asarray(g_x))
    print("JAX_PIPELINE", json.dumps(list(out.shape)))
""")


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pipeline") / "run.npz"
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c",
                          JAX_PIPELINE.format(out=str(out))], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "JAX_PIPELINE" in res.stdout, (res.stdout[-2000:],
                                          res.stderr[-3000:])
    assert json.loads(res.stdout.split("JAX_PIPELINE", 1)[1]) == [8, 16]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def port_pipeline(jax_pipeline):
    return run_ranks(R.pipeline_rank, 4,
                     args=(jax_pipeline["ws"], jax_pipeline["x"], 4, 4,
                           jax_pipeline["ct"]),
                     threads=1, timeout_s=180)


def test_pipeline_matches_reference(jax_pipeline, port_pipeline):
    for rank, res in enumerate(port_pipeline):
        np.testing.assert_allclose(res["out"], jax_pipeline["out"],
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {rank}")


def test_pipeline_gradient_matches_reference(jax_pipeline, port_pipeline):
    """``jax.grad`` through the reference's loop: each stage's slice of
    the weights' gradient (the rest of it zero on that rank) and the
    whole input gradient on every rank."""
    width = len(jax_pipeline["ws"]) // len(port_pipeline)
    for rank, res in enumerate(port_pipeline):
        got = res["grads"]
        want = jax_pipeline["g_ws"][rank * width:(rank + 1) * width]
        np.testing.assert_allclose(got["ws"], want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {rank}")
        assert got["ws_rest"] == 0.0
        np.testing.assert_allclose(got["x"], jax_pipeline["g_x"],
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {rank}")
    assert np.abs(jax_pipeline["g_x"]).max() > 1e-2


def test_pipeline_of_decoder_blocks_matches_sequence(port_pipeline):
    for rank, res in enumerate(port_pipeline):
        got, want = res["blocks"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {rank}")
        # the output carries the pipeline's gradient; under no_grad the
        # forward alone runs and gives the same values
        assert res["requires_grad"]
        quiet, quiet_grad = res["quiet"]
        assert not quiet_grad
        np.testing.assert_array_equal(quiet, got)


def test_pipeline_of_decoder_blocks_gradient_matches_sequence(
        port_pipeline):
    """Each stage's block gradient and the input's against the blocks in
    sequence, in fp32: within ``1e-6 + 1e-4 |g|``, an element that
    misses judged by the sequence in float64 as
    `test_torch_lm_train_arch.check_grads` judges (at most `MAX_MISSES`
    a leaf, each where the fp32 sequence is off float64 by more than the
    rule and the pipeline no further)."""
    from test_torch_lm_train_arch import check_grads
    for rank, res in enumerate(port_pipeline):
        got, want = res["block_grads"]
        assert sorted(got) == sorted(want) and len(got) > 1
        check_grads(got, want, lambda: res["block_grads64"], f"rank {rank}")
        for k in want:
            assert np.abs(want[k]).max() > 0, (rank, k)


def test_stage_mesh_axes(port_pipeline):
    for rank, res in enumerate(port_pipeline):
        names, shape, ranks = res["mesh"]
        assert names == ("stage", "data")
        assert shape == {"stage": 4, "data": 1}
        assert ranks == (0, 1, 2, 3)


def test_pipeline_refuses_a_batch_it_cannot_split():
    import types

    import torch

    from repro_torch.distributed.collectives import Axis
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    mesh = types.SimpleNamespace(axes={"stage": Axis("stage", 1, 0)})
    fn = pipeline_apply(lambda w, h: h, mesh, n_microbatches=4)
    with pytest.raises(ValueError, match="into 4 microbatches"):
        fn([], torch.zeros(6, 2))
    with pytest.raises(ValueError, match="into 3 stages"):
        from repro_torch.distributed.pipeline_parallel import stage_layers
        stage_layers(torch.zeros(4, 2), types.SimpleNamespace(
            axes={"stage": Axis("stage", 3, 0)}))
