"""The port's mesh end to end on the CPU: checkpoint-resume over ranks,
the `ogbn_mag_train` twin against the JAX example, and the surfaces
around them.

* (data=2, ZeRO-1 on) a 2-rank run stopped at a save after step 3 and
  resumed repeats the uninterrupted run's losses and final parameters
  exactly; the checkpoint holds the full optimizer state.
* `repro_torch.orchestration.ogbn_mag_train` at ``--papers 240 --steps 3
  --num-devices 4 --model-parallel 2`` (4 spawned gloo ranks) from the
  JAX example's initial parameters reaches the example's final loss at
  the same arguments (1e-4; one JAX subprocess, 4 host devices, runs
  `examples/ogbn_mag_train.py` itself); ``--sampler service`` on one
  rank trains the in-process path's losses bit for bit (``--multihost``
  and the service over several ranks: tests/test_torch_remote.py).
* A world that does not match ``num_devices`` raises the reference's
  message; one rank needs no process group (and the 1-D surface's step
  is the plan's); `runner.run` passes the mesh through; a failing rank
  fails its world; `device_prefetch(plan=)` places what
  `put_super_batch` places.
* On the card (marked `cuda`, skipped here): 2 gloo ranks sharing the
  card at (data=1, model=2) train the mean model as one rank does.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_ranks as R  # noqa: E402 — its directory is put on the path

from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.launch import RankFailure, run_ranks  # noqa: E402
from repro_torch.orchestration import ogbn_mag_train  # noqa: E402
from repro_torch.orchestration.providers import BatcherProvider  # noqa: E402
from repro_torch.orchestration.trainer import Trainer  # noqa: E402
from repro_torch.train.train_loop import device_prefetch  # noqa: E402

FLEET_TIMEOUT_S = 150
TWIN_ARGS = ["--papers", "240", "--steps", "3", "--num-devices", "4",
             "--model-parallel", "2"]


def test_two_rank_resume_repeats_the_uninterrupted_run(tmp_path):
    ckpt = tmp_path / "ckpt"
    runs = run_ranks(R.resume_case, 2, args=(str(ckpt),), threads=1,
                     timeout_s=FLEET_TIMEOUT_S)
    for rank, res in enumerate(runs):
        whole, first, resumed = res["whole"], res["first"], res["resumed"]
        assert whole["step"] == 6 and first["step"] == 3, rank
        assert resumed["step"] == 6, rank
        assert first["losses"] == whole["losses"][:3], rank
        assert resumed["losses"] == whole["losses"][3:], rank
        for k, v in whole["params"].items():
            np.testing.assert_array_equal(resumed["params"][k], v,
                                          err_msg=k)
        # ZeRO-1 halves the moments a rank
        assert whole["opt_state_bytes"] < 0.6 * (
            2 * 4 * sum(v.size for v in whole["params"].values()))
    # rank 0 wrote one file set holding the FULL optimizer state
    steps = sorted(p.name for p in ckpt.iterdir() if p.name.startswith(
        "step_"))
    assert steps == ["step_0000000003", "step_0000000006"]
    with open(ckpt / "step_0000000003" / "manifest.json") as f:
        manifest = json.load(f)["arrays"]
    shapes = {k: v["shape"] for k, v in manifest.items()}
    name = "init.paper.w"
    full = list(runs[0]["whole"]["params"][name].shape)
    assert shapes[f"[0][{name!r}]"] == full
    assert shapes[f"[1][1][{name!r}]"] == full   # m, not a slice
    assert shapes[f"[1][2][{name!r}]"] == full   # v


def test_world_must_match_num_devices():
    gs, sizes = R.graphs()
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        Trainer(num_devices=2, device="cpu").fit(
            R.model_fn, R.task(), BatcherProvider(gs, R.BATCH, sizes,
                                                  num_replicas=2))
    with pytest.raises(ValueError, match="model_parallel 2 must divide"):
        partition.make_mesh(1, model_parallel=2)


def test_runner_run_passes_the_mesh_through():
    """`runner.run(num_devices=, model_parallel=)` trains stacked
    super-batches as `Trainer(num_devices=)` does."""
    from repro_torch.orchestration import runner
    gs, sizes = R.graphs()
    prov = BatcherProvider(gs, R.BATCH, sizes, num_replicas=2)
    kw = dict(learning_rate=R.LR, total_steps=R.TOTAL, max_steps=3,
              log_every=10 ** 6, device="cpu")
    got = runner.run(train_batches=prov.epoch, model_fn=R.model_fn,
                     task=R.task(), num_devices=1, **kw)
    want = Trainer(num_devices=1, **kw).fit(R.model_fn, R.task(), prov)
    assert got.metrics["train_losses"] == want.metrics["train_losses"]
    assert len(got.metrics["train_losses"]) == 3
    with pytest.raises(ValueError, match="needs num_devices"):
        runner.run(train_batches=prov.epoch, model_fn=R.model_fn,
                   task=R.task(), model_parallel=2, **kw)


def test_one_rank_needs_no_process_group(monkeypatch):
    """Unconfigured, or a world of one process: `initialize_distributed`
    joins nothing, and the 1-D surface's step is the plan's step."""
    from repro_torch.distributed import graph_sharding
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    from repro_torch.train.optimizer import AdamW
    for key in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert not partition.initialize_distributed()
    assert not partition.initialize_distributed("file:///nowhere", 1, 0)
    assert partition.backend_name() == "none"
    gs, sizes = R.graphs()
    host = next(iter(BatcherProvider(gs, R.BATCH, sizes,
                                     num_replicas=2).epoch(0)))
    mesh = graph_sharding.make_data_mesh(1)
    assert graph_sharding.data_spec(mesh) == ("data",)
    losses = []
    for make in (lambda fn, opt: graph_sharding.make_dp_train_step(
                     mesh, fn, opt, num_groups=2, device="cpu"),
                 lambda fn, opt: partition.make_train_step(
                     partition.make_plan(1, device="cpu"), fn, opt,
                     num_groups=2)):
        model = init_params(TrainModel(*R.model_fn(), R.task().head()), 0)
        task = R.task()
        params = dict(model.named_parameters())
        opt = AdamW(learning_rate=1e-3)
        step = make(lambda g, lab: task.loss_from_graph(
            model.head, model(g), lab), opt)
        graph, labels = graph_sharding.put_super_batch(
            host, task.labels(host), mesh, device="cpu")
        _, _, loss = step(params, opt.init(params), graph, labels)
        losses.append(float(loss))
        evaluate = graph_sharding.make_dp_eval_step(
            mesh, lambda g, lab: tuple(
                x for k in task.metric_names()
                for x in task.metrics(model.head, model(g), lab)[k]),
            device="cpu")
        assert len(evaluate(graph, labels)) == 2 * len(task.metric_names())
    assert losses[0] == losses[1]


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RankFailure, match="ranks exited"):
        run_ranks(R.train, 2, args=(3,), threads=1,
                  timeout_s=FLEET_TIMEOUT_S)


def test_device_prefetch_with_a_plan_places_as_put_super_batch():
    gs, sizes = R.graphs()
    plan = partition.make_plan(1, device="cpu")
    pairs = [(g, R.task().labels(g)) for g in
             BatcherProvider(gs, R.BATCH, sizes, num_replicas=2).epoch(0)]
    placed = list(device_prefetch(iter(pairs), plan=plan))
    assert len(placed) == len(pairs)
    for (graph, labels), (host, host_labels) in zip(placed, pairs):
        want, want_labels = plan.put_super_batch(host, host_labels)
        assert torch.equal(labels, want_labels)
        assert torch.equal(graph.node_sets["paper"]["feat"],
                           want.node_sets["paper"]["feat"])
        assert graph.node_sets["paper"]["feat"].shape[0] == 2
    with pytest.raises(ValueError, match="place= or plan="):
        device_prefetch(iter(pairs))


# ---------------------------------------------------------------------------
# the ogbn_mag_train twin against the JAX example
# ---------------------------------------------------------------------------

JAX_EXAMPLE = textwrap.dedent("""
    import json, runpy, sys
    import numpy as np
    sys.argv = ["ogbn_mag_train.py"] + {argv!r}
    g = runpy.run_path({path!r}, run_name="__main__")
    from repro.orchestration.trainer import Trainer
    init = Trainer(seed=0)._init_params(g["InitStates"](), g["gnn"],
                                        g["task"].head())

    def flat(tree, prefix=""):
        if isinstance(tree, (list, tuple)):
            tree = dict(enumerate(tree))
        if isinstance(tree, dict):
            out = {{}}
            for k, v in tree.items():
                out.update(flat(v, f"{{prefix}}.{{k}}" if prefix
                                else str(k)))
            return out
        return {{prefix: np.asarray(tree)}}

    np.savez({out!r}, **flat(init))
    res = g["result"]
    print("JAX_EXAMPLE", json.dumps({{
        "loss": float(res.train_loss),
        "accuracy": float(res.metrics["eval_accuracy"]),
        "steps": int(res.step)}}))
""")


@pytest.fixture(scope="module")
def jax_example(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_example") / "init.npz"
    script = JAX_EXAMPLE.format(argv=TWIN_ARGS, out=str(out),
                                path=os.path.abspath(
                                    "examples/ogbn_mag_train.py"))
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "JAX_EXAMPLE" in res.stdout, (res.stdout[-2000:],
                                         res.stderr[-3000:])
    return str(out), json.loads(res.stdout.split("JAX_EXAMPLE", 1)[1])


def test_twin_matches_the_jax_example_on_a_2x2_mesh(jax_example):
    init, want = jax_example
    got = ogbn_mag_train.run_twin(TWIN_ARGS + ["--device", "cpu",
                                               "--init-params", init,
                                               "--backend", "gloo"])
    assert got["steps"] == want["steps"] == 3
    assert got["backend"] == "gloo"
    assert abs(got["final_loss"] - want["loss"]) < 1e-4, (got, want)
    assert abs(got["test_accuracy"] - want["accuracy"]) < 1e-4, (got, want)


def test_twin_sampler_service_on_one_rank_repeats_in_process():
    args = ["--papers", "96", "--steps", "2", "--device", "cpu",
            "--hidden", "16"]
    inproc = ogbn_mag_train.run_twin(args)
    service = ogbn_mag_train.run_twin(args + ["--sampler", "service"])
    assert inproc["steps"] == service["steps"] == 2
    assert service["losses"] == inproc["losses"]
    assert inproc["backend"] == "none"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_on_one_card_train_as_one(cuda_device):
    """(data=1, model=2) on gloo, both ranks on the card, the mean model
    (its pools run segment_pool_runs on 8-wide chunks): per-step losses
    within 1e-4 of one rank's run of the same super-batches."""
    one = R.train_on(str(cuda_device), 1, 1)
    two = run_ranks(R.train_on, 2, args=(str(cuda_device), 2, 2),
                    threads=1, timeout_s=FLEET_TIMEOUT_S,
                    device=str(cuda_device))
    for got in two:
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0,
                                   atol=1e-4)
