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
  dtype, learning rate), and `make_train_step`'s mesh arguments refused
  with `NotImplementedError` until the LM on the mesh is ported.
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


@pytest.mark.parametrize("kw", [{"plan": object()}, {"mesh": object()},
                                {"zero1": True}, {"param_axes": {}}])
def test_mesh_arguments_are_not_ported_yet(kw):
    cfg = registry.get_config("qwen1.5-4b-smoke")
    model = registry.build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="the LM on the mesh"):
        t_loop.make_train_step(model, cfg, t_opt.AdamW(), **kw)
