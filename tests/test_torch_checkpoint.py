"""The port's checkpoint layer and the Trainer's checkpoint-resume, on the
CPU (counterparts of tests/test_orchestration.py:342-443 and
tests/test_checkpoint_resume.py).

* `repro_torch.distributed.fault_tolerance`: the reference's on-disk
  layout (``step_%010d/arrays.npz`` + ``manifest.json``, the ``latest``
  and ``best`` pointers), a corrupt array detected by its sha1, `mark_best`
  surviving ``keep=`` GC, `mark_best` on an unsaved step raising, the
  async save copying the state before it returns, a writer's error
  re-raised from `wait()`, bf16 and `AdamWState` round trips, the SIGTERM
  hook;
* the Trainer: epoch evals with early stopping pin the best step, and a
  run stopped by ``max_steps`` and resumed with ``resume=True`` repeats
  the uninterrupted run's per-step losses and final parameters exactly;
* a training subprocess SIGKILLs itself mid-epoch 2; a second one resumes
  from the latest checkpoint, and its losses equal the uninterrupted
  run's exactly.
"""
import json
import os
import re
import signal
import textwrap

import numpy as np
import pytest
import torch

from multiproc import SRC, fleet_script, run_fleet

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.orchestration import graph_classification as gc
from repro_torch.orchestration.evaluation import EarlyStopping
from repro_torch.orchestration.tasks import GraphMulticlassClassification
from repro_torch.orchestration.trainer import Trainer
from repro_torch.train.optimizer import AdamW


def state():
    params = {"init.w": torch.arange(6, dtype=torch.float32).reshape(3, 2),
              "head.b": torch.tensor([0.5, -1.0]),
              "emb.table": torch.randn(4, 2).to(torch.bfloat16)}
    return params, AdamW().init(params)


def test_layout_and_round_trip(tmp_path):
    params, opt = state()
    path = ft.save_checkpoint(str(tmp_path), 7, (params, opt),
                              extra={"epoch": 1, "step_in_epoch": 3})
    assert os.path.basename(path) == "step_0000000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    assert ft.latest_checkpoint(str(tmp_path)) == path
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and manifest["extra"]["epoch"] == 1
    assert manifest["arrays"]["[0]['emb.table']"]["dtype"] == "bfloat16"
    step, (p2, o2), extra = ft.restore_checkpoint(path, (params, opt))
    assert step == 7 and extra == {"epoch": 1, "step_in_epoch": 3}
    assert list(p2) == list(params)  # the dict keeps its own order
    for k in params:
        assert p2[k].dtype == params[k].dtype
        assert torch.equal(p2[k], params[k])
    assert type(o2) is type(opt) and o2.step.dtype == torch.int32
    assert list(o2.m) == list(opt.m)


def test_corrupt_array_is_detected(tmp_path):
    params, opt = state()
    path = ft.save_checkpoint(str(tmp_path), 1, (params, opt))
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["a0"] = arrays["a0"] + 1  # same shape and dtype, new bytes
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(IOError, match="corrupt checkpoint"):
        ft.restore_checkpoint(path, (params, opt))
    ft.restore_checkpoint(path, (params, opt), verify=False)


def test_mark_best_survives_gc(tmp_path):
    """The best-pointed checkpoint is pinned: keep= GC never collects it,
    however old it gets."""
    w = {"w": torch.ones(4)}
    with ft.CheckpointManager(str(tmp_path), keep=2) as mgr:
        mgr.save_async(10, {"w": w["w"] * 10})
        mgr.wait()
        mgr.mark_best(10)
        for step in (20, 30, 40):
            mgr.save_async(step, {"w": w["w"] * step})
        mgr.wait()
        names = sorted(d for d in os.listdir(tmp_path)
                       if d.startswith("step_"))
        assert names == ["step_0000000010", "step_0000000030",
                         "step_0000000040"]
        assert ft.latest_checkpoint(str(tmp_path)).endswith(
            "step_0000000040")
        assert ft.best_checkpoint(str(tmp_path)).endswith(
            "step_0000000010")
        step, restored, _ = mgr.restore_best(w)
        assert step == 10
        torch.testing.assert_close(restored["w"], w["w"] * 10)
        assert mgr.restore_latest(w)[0] == 40


def test_mark_best_requires_saved_step(tmp_path):
    with ft.CheckpointManager(str(tmp_path), keep=2) as mgr:
        with pytest.raises(FileNotFoundError, match="wait"):
            mgr.mark_best(99)
    assert mgr.restore_best({"w": torch.ones(1)}) is None


def test_async_save_copies_the_state_before_it_returns(tmp_path):
    """The optimizer updates parameters in place right after save_async:
    the checkpoint must hold the values at the call."""
    p = torch.zeros(256, 256)
    with ft.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save_async(1, {"p": p})
        p.add_(1.0)
    _, restored, _ = ft.restore_checkpoint(
        ft.latest_checkpoint(str(tmp_path)), {"p": p})
    assert float(restored["p"].abs().max()) == 0.0


def test_writer_error_is_reraised_from_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    mgr = ft.CheckpointManager(str(blocker))
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()  # the error was surfaced once; the writer is joined
    assert mgr._thread is None


def test_preemption_hook_saves_on_sigterm(tmp_path):
    mgr = ft.CheckpointManager(str(tmp_path))
    previous = signal.getsignal(signal.SIGTERM)
    try:
        mgr.install_preemption_hook(
            lambda: (5, {"w": torch.full((3,), 2.0)}, {"epoch": 0}))
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert mgr._preempted
    step, restored, extra = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 5 and extra == {"epoch": 0}
    assert restored["w"].tolist() == [2.0, 2.0, 2.0]


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

GRAPHS = 64  # 48 train graphs, 3 steps an epoch of 16


@pytest.fixture(scope="module")
def data():
    return gc.providers(GRAPHS)


def test_trainer_epoch_eval_early_stops_and_tracks_best(data, tmp_path):
    """eval_at='epoch' + an impossible min_delta: exactly two evals run
    (patience=1), the run stops early, and the best eval's step survives
    as the `best` checkpoint."""
    train, val = data
    ckpt = str(tmp_path / "ck")
    trainer = Trainer(
        epochs=5, learning_rate=3e-3, total_steps=100, log_every=10 ** 9,
        ckpt_dir=ckpt, save_interval_steps=2, keep=1, eval_at="epoch",
        early_stopping=EarlyStopping(monitor="loss", patience=1,
                                     min_delta=100.0, mode="min"),
        device="cpu")
    result = trainer.fit(gc.model_fn, GraphMulticlassClassification(
        "atoms", gc.CLASSES, gc.HIDDEN), train, eval_provider=val)
    assert result.metrics["stopped_early"] is True
    history = result.metrics["eval_history"]
    assert len(history) == 2
    assert result.step == 2 * train.num_steps
    want_best = (int(np.argmin([m["loss"] for m in history])) + 1) \
        * train.num_steps
    assert result.metrics["best_step"] == want_best
    best = ft.best_checkpoint(ckpt)
    assert best is not None and best.endswith(f"step_{want_best:010d}")
    assert ft.latest_checkpoint(ckpt).endswith(f"step_{result.step:010d}")


@pytest.mark.parametrize("cut", [1, 4])
def test_trainer_resume_matches_uninterrupted(data, tmp_path, cut):
    """Stop with max_steps (inside epoch 0, or one step into epoch 1),
    resume=True from the checkpoint the stop saved: per-step losses and
    final parameters equal the uninterrupted run's exactly."""
    kw = dict(epochs=2, steps=None)
    full = gc.run(device="cpu", ckpt_dir=str(tmp_path / "a"), data=data,
                  **kw)
    assert full.step == 2 * data[0].num_steps
    part = gc.run(device="cpu", ckpt_dir=str(tmp_path / "b"), data=data,
                  epochs=2, steps=cut)
    assert part.step == cut
    resumed = gc.run(device="cpu", ckpt_dir=str(tmp_path / "b"), data=data,
                     resume=True, **kw)
    assert resumed.step == full.step
    assert (part.metrics["train_losses"] + resumed.metrics["train_losses"]
            == full.metrics["train_losses"])
    assert resumed.train_loss == full.train_loss
    for name, p in full.metrics["params"].items():
        assert torch.equal(resumed.metrics["params"][name], p), name


def test_resume_without_a_checkpoint_starts_from_scratch(data, tmp_path):
    a = gc.run(device="cpu", epochs=1, data=data)
    b = gc.run(device="cpu", epochs=1, data=data, resume=True,
               ckpt_dir=str(tmp_path / "empty"))
    assert a.metrics["train_losses"] == b.metrics["train_losses"]


# ---------------------------------------------------------------------------
# a real process kill
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import json, os, signal, sys
    mode, ckpt, kill_after = sys.argv[1], sys.argv[2], int(sys.argv[3])
    import torch
    from repro_torch.orchestration import graph_classification as gc
    from repro_torch.orchestration.providers import DatasetProvider
    from repro_torch.orchestration.tasks import (
        GraphMulticlassClassification)
    from repro_torch.orchestration.trainer import Trainer

    class KillSwitch(DatasetProvider):
        # dies between step `kill_after` and the next batch pull: the
        # preemption shape (mid-epoch, an async save possibly in flight)
        def __init__(self, inner, fuse):
            self.inner = inner
            self.fuse = fuse
            self.edges_sorted_by_target = inner.edges_sorted_by_target
        @property
        def num_steps(self):
            return self.inner.num_steps
        def epoch(self, epoch, *, start_step=0):
            for item in self.inner.epoch(epoch, start_step=start_step):
                if self.fuse == 0:
                    sys.stdout.flush()
                    os.kill(os.getpid(), signal.SIGKILL)
                self.fuse -= 1
                yield item

    train, _ = gc.providers(64)
    print(f"NUM_STEPS {train.num_steps}", flush=True)
    if mode == "kill":
        train = KillSwitch(train, kill_after)
    trainer = Trainer(epochs=2, learning_rate=1e-2, total_steps=50,
                      log_every=1, ckpt_dir=ckpt, save_interval_steps=2,
                      resume=(mode == "resume"), device="cpu")
    result = trainer.fit(gc.model_fn, GraphMulticlassClassification(
        "atoms", gc.CLASSES, gc.HIDDEN), train)
    print("RESULT " + json.dumps({"step": result.step,
                                  "losses": result.metrics["train_losses"]}),
          flush=True)
""")

STEP_RE = re.compile(r"epoch \d+ step (\d+) loss (\d+\.\d{4})")
KILL_AFTER = 4  # one step into epoch 2 (3 steps an epoch)


def _run(mode, ckpt):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = fleet_script(SCRIPT) + [mode, ckpt, str(KILL_AFTER)]
    return run_fleet([argv], timeout=420,
                     env_for_rank=lambda rank: env)[0]


def _result(log):
    m = re.search(r"RESULT (.*)", log)
    assert m, log[-3000:]
    return json.loads(m.group(1))


@pytest.mark.timeout(900)
def test_kill_and_resume_matches_uninterrupted(tmp_path):
    full = _run("full", str(tmp_path / "full"))
    assert full.ok, full.log[-3000:]
    assert "NUM_STEPS 3" in full.log
    want = _result(full.log)
    assert want["step"] == 6
    killed = _run("kill", str(tmp_path / "kr"))
    assert killed.returncode == -signal.SIGKILL, (killed.returncode,
                                                 killed.log[-3000:])
    k = {int(s): loss for s, loss in STEP_RE.findall(killed.log)}
    # the killed prefix is the uninterrupted sequence
    assert k and max(k) == KILL_AFTER
    assert all(f"{want['losses'][s - 1]:.4f}" == loss
               for s, loss in k.items()), (want, k)
    resumed = _run("resume", str(tmp_path / "kr"))
    assert resumed.ok, resumed.log[-3000:]
    got = _result(resumed.log)
    start = got["step"] - len(got["losses"])
    # resume picked up a periodic save near the kill point (the async
    # save at step 4 may or may not have landed before the kill)
    assert 2 <= start <= KILL_AFTER, start
    assert got["step"] == want["step"]
    assert got["losses"] == want["losses"][start:]
