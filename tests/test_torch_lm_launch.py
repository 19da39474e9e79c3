"""The port's LM training entry point `repro_torch.launch.train` (twin of
`repro.launch.train`) and `launch.specs`, on the CPU.

* The twin at ``--device cpu``: 6 steps checkpointing every 3, then a
  restart with ``--steps 8`` on the same directory (the port of
  `tests/test_distributed.py:81-93`): it restores at step 6, trains
  steps 7-8 only, and their losses equal an uninterrupted 8-step run's
  exactly (read from the train step; the log prints 4 decimals).  Both
  runs exit 0, print the reference's log lines and end with ``training
  complete at step N``; the directory holds the ``latest`` pointer and no
  ``.tmp`` leftovers.
* Without ``--device`` it needs a card (no CPU fallback); its flags are
  the reference's plus ``--device``.
* `pick_optimizer` against the reference's for every arch (kind, moment
  dtype, learning rate), and `make_train_step`'s mesh arguments: without
  a mesh ``zero1=`` and ``param_axes=`` change nothing, and a world of
  one rank through ``plan=`` or ``mesh=`` gives the plain step.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import specs as j_specs
from repro.launch import train as j_train
from repro.models import registry as j_registry

from repro_torch.distributed.fault_tolerance import latest_checkpoint
from repro_torch.launch import specs, train
from repro_torch.models import registry
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_loop

ARGS = ["--arch", "qwen1.5-4b-smoke", "--batch", "2", "--seq", "32",
        "--log-every", "1", "--device", "cpu"]


def run_twin(monkeypatch, capsys, argv) -> tuple:
    """(exit code, the loss of every step the run trained, its output
    lines)."""
    losses = []

    def spying(*a, **kw):
        step = t_loop.make_train_step(*a, **kw)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            losses.append(float(out[2]["loss"]))
            return out
        return wrapped

    monkeypatch.setattr(train, "make_train_step", spying)
    rc = train.main(ARGS + argv)
    return rc, losses, capsys.readouterr().out.splitlines()


def test_twin_restart_repeats_the_uninterrupted_losses(tmp_path, monkeypatch,
                                                       capsys):
    ck = str(tmp_path / "ck")
    rc1, first, out1 = run_twin(monkeypatch, capsys, [
        "--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3"])
    rc2, second, out2 = run_twin(monkeypatch, capsys, [
        "--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "3"])
    rc3, whole, _ = run_twin(monkeypatch, capsys, ["--steps", "8"])
    assert rc1 == rc2 == rc3 == 0
    assert len(first) == 6 and len(second) == 2 and len(whole) == 8
    assert "restored checkpoint at step 6" in out2
    assert first == whole[:6]
    assert second == whole[6:]  # exactly: the state and data resume
    assert out1[-1] == "training complete at step 6"
    assert out2[-1] == "training complete at step 8"
    assert [line.split("(")[0] for line in out2[1:3]] == [
        f"step {s:5d} loss {v:8.4f} " for s, v in zip((7, 8), second)]
    path = latest_checkpoint(ck)
    assert path is not None and path.endswith("step_0000000008")
    assert not [d for d in os.listdir(ck) if d.endswith(".tmp")]


def test_twin_flags_are_the_reference_flags_and_need_a_card(monkeypatch):
    import argparse
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["dests"] = sorted(a.dest for a in self._actions
                               if a.dest != "help")
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        j_train.main([])
    ref = seen["dests"]
    with pytest.raises(SystemExit):
        train.main([])
    assert seen["dests"] == sorted(ref + ["device"])
    monkeypatch.undo()
    assert train.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1"])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_pick_optimizer_matches_reference(arch):
    got = specs.pick_optimizer(registry.get_config(arch))
    want = j_specs.pick_optimizer(j_registry.get_config(arch))
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, t_opt.AdamW):
        assert str(got.moment_dtype).split(".")[-1] \
            == jnp.dtype(want.moment_dtype).name
    for step in (1, 100, 5000):
        np.testing.assert_allclose(
            got.learning_rate(torch.tensor(step)).item(),
            float(want.learning_rate(jnp.asarray(step))), rtol=1e-6)


def _one_rank(kind: str, model) -> dict:
    """`make_train_step`'s keywords for a case of the test below."""
    from repro_torch.distributed import partition
    from repro_torch.nn.layers import param_axes
    if kind == "zero1":
        return {"zero1": True}
    if kind == "param_axes":
        return {"param_axes": param_axes(model)}
    plan = partition.make_plan(1, device="cpu")
    return {"plan": plan, "zero1": True} if kind == "plan" \
        else {"mesh": plan.mesh, "zero1": True}


@pytest.mark.parametrize("kind", ["zero1", "param_axes", "plan", "mesh"])
def test_mesh_arguments_match_the_plain_step(kind):
    """``zero1=`` and ``param_axes=`` without a mesh change nothing, as in
    the reference; a world of one rank through ``plan=`` or ``mesh=``
    (wrapped by `plan_for`) runs the mesh program, which gives the plain
    step's numbers: two steps from the same weights, bit for bit (one
    intra-op thread, so the embedding gradient's sum has one order)."""
    from repro_torch.nn.layers import init_params, stack_groups
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = registry.get_config("qwen1.5-4b-smoke")
        runs = []
        for kw in (None, kind):
            model = init_params(registry.build_model(cfg, "cpu"), 7)
            opt = t_opt.AdamW(learning_rate=1e-3)
            step = t_loop.make_train_step(
                model, cfg, opt, n_microbatches=2,
                **(_one_rank(kw, model) if kw else {}))
            params = dict(model.named_parameters())
            state = (step.init_opt_state(params)
                     if isinstance(step, t_loop.MeshTrainStep)
                     else opt.init(params, stack_groups(params)))
            rng = np.random.default_rng(1)
            toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int64)
            batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                     "labels": torch.from_numpy(toks[:, 1:])}
            losses = []
            for _ in range(2):
                params, state, m = step(params, state, batch)
                losses.append({k: float(v) for k, v in m.items()})
            runs.append((losses, {k: p.detach().clone()
                                  for k, p in params.items()}))
    finally:
        torch.set_num_threads(threads)
    (want, want_p), (got, got_p) = runs
    assert (kind in ("plan", "mesh")) == isinstance(step,
                                                    t_loop.MeshTrainStep)
    assert got == want
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
