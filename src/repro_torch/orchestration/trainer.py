"""Trainer — the loop-owning piece of the orchestration layer
(counterpart of `repro.orchestration.trainer`).

The Trainer owns the step functions (`train_loop.make_graph_train_step`
/ `make_graph_eval_step`), the loop around them and the checkpoint
lifecycle (`fault_tolerance.CheckpointManager`: periodic async saves
carrying the stream offset ``extra={"epoch", "step_in_epoch"}``,
``resume=True`` through `restore_latest` and the provider's
``epoch(e, start_step=s)``, and best-checkpoint tracking with
`mark_best` driven by the eval stream); the objective is the `Task`'s
and the stream the `DatasetProvider`'s.  ``Trainer.fit`` wires the three
together and `runner.run` is a thin shim over it.  It keeps the
reference's fields and defaults, and its composition: AdamW with
warmup-cosine and ``weight_decay=1e-5``, labels from the Task at the
stream's (epoch, step), the layout hint entered around the loop, eval
at "end" or after every "epoch" with `EarlyStopping` best-step
bookkeeping.  With every provider honouring ``(seed, epoch, step) ->
batch``, a resumed run's losses equal an uninterrupted run's exactly:
on the CPU, and on the card, where the kernels fold every sum in a fixed
order on the sorted training batches.

What this slice leaves out: the mesh (``num_devices`` and
``model_parallel > 1`` raise; ROADMAP queue 1 item 3).

The model runs on CUDA unless ``device`` says otherwise; without a card
and without ``device`` the Trainer raises rather than carry on on the
CPU.  Parameters are drawn with ``init_params(model, seed)``; passing
``params=`` to `fit` (a tree in the reference's layout, e.g. the numpy
leaves of the JAX ``Trainer._init_params``) loads it with
`load_jax_params` instead of the draw.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.core.graph_tensor import (resolve_device, stack_size,
                                           to_device)
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.kernels import registry
from repro_torch.nn.layers import init_params, load_jax_params
from repro_torch.orchestration.evaluation import EarlyStopping, evaluate
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.train_loop import (device_prefetch,
                                          make_graph_eval_step,
                                          make_graph_train_step)


@dataclasses.dataclass
class RunResult:
    step: int
    train_loss: float
    metrics: dict


class TrainModel(nn.Module):
    """The three trained modules under one root, named as the reference's
    parameter tree is keyed: ``init``, ``gnn``, ``head``."""

    def __init__(self, init_states: nn.Module, gnn: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.init = init_states
        self.gnn = gnn
        self.head = head

    def forward(self, graph):
        return self.gnn(self.init(graph))


@dataclasses.dataclass
class Trainer:
    """Optimization-loop configuration; `fit` runs it.

    Scheduling (``learning_rate``/``warmup_steps``/``total_steps``/
    ``weight_decay``) is the reference's AdamW + warmup-cosine recipe.
    ``eval_at`` places the validation pass: "end" (once, after all
    epochs), "epoch" (after every epoch, with best-step tracking and
    optional early stopping), or "never".

    ``ckpt_dir`` turns on checkpointing: a save every
    ``save_interval_steps`` steps and at the end, the newest ``keep``
    retained, and with ``track_best`` the best eval epoch's step pinned
    as `best`.  ``resume=True`` restores the latest checkpoint there (if
    any) and re-enters the stream at the (epoch, step) it recorded.
    """

    epochs: int = 1
    learning_rate: float = 1e-3
    total_steps: int = 1000
    warmup_steps: int = 50
    weight_decay: float = 1e-5
    seed: int = 0
    num_devices: Optional[int] = None
    model_parallel: int = 1
    max_steps: Optional[int] = None
    log_every: int = 20
    double_buffer: bool = False
    edges_sorted_by_target: Optional[bool] = None
    ckpt_dir: str = ""
    keep: int = 3
    save_interval_steps: int = 100
    resume: bool = False
    eval_at: str = "end"
    early_stopping: Optional[EarlyStopping] = None
    track_best: bool = True
    device: Optional[str] = None

    def __post_init__(self):
        if self.eval_at not in ("end", "epoch", "never"):
            raise ValueError(f"eval_at must be 'end', 'epoch' or 'never', "
                             f"got {self.eval_at!r}")
        if self.num_devices is not None or self.model_parallel > 1:
            raise ValueError("num_devices / model_parallel > 1 need the "
                             "mesh, which the port does not have yet "
                             "(ROADMAP queue 1 item 3)")

    @staticmethod
    def _labeled(stream, task, epoch: int, start_step: int):
        """Normalize a provider stream to (graph, labels) pairs: sources
        that pre-compute labels pass through; bare graphs go through the
        Task's extraction at the stream's (epoch, step) coordinates."""
        for step, item in enumerate(stream, start=start_step):
            if isinstance(item, tuple):
                yield item
            else:
                yield item, task.labels(item, epoch=epoch, step=step)

    def fit(self, model_fn: Callable, task, train_provider, *,
            eval_provider=None, params: Any = None) -> RunResult:
        """Train `task` over `train_provider`; returns the final step,
        last train loss, and a metrics dict with "params" ({name:
        tensor}), "train_losses" and "step_seconds" (one per step, host
        clock, each ending when the step's loss reached the host) and
        "batch_wait_seconds" (the part of each step spent waiting for its
        placed batch: sampling and the copy, or the prefetch queue), plus
        "eval", "eval_history", "best_step" when an eval stream ran.

        ``params``: a parameter tree ``{"init", "gnn", "head"}`` in the
        reference's layout, loaded in place of the seeded draw."""
        device = resolve_device(self.device)
        init_states, gnn = model_fn()
        model = TrainModel(init_states, gnn, task.head())
        if params is None:
            init_params(model, self.seed)
        else:
            load_jax_params(model, params)
        model.to(device)
        named = dict(model.named_parameters())
        opt = AdamW(learning_rate=warmup_cosine(
                        self.learning_rate, self.warmup_steps,
                        self.total_steps),
                    weight_decay=self.weight_decay)
        opt_state = opt.init(named)

        def loss_fn(graph, labels):
            return task.loss_from_graph(model.head, model(graph), labels)

        metric_keys = tuple(task.metric_names())

        def metric_fn(graph, labels):
            pairs = task.metrics(model.head, model(graph), labels)
            if tuple(sorted(pairs)) != metric_keys:
                raise ValueError(
                    f"{type(task).__name__}.metrics keys "
                    f"{tuple(sorted(pairs))} != metric_names() "
                    f"{metric_keys}")
            flat = []
            for k in metric_keys:
                num, den = pairs[k]
                flat += [num, den]
            return tuple(flat)

        esbt = self.edges_sorted_by_target
        if esbt is None:
            esbt = train_provider.edges_sorted_by_target
        if esbt is None:
            esbt = True  # the producers' default

        def place(graph, labels, non_blocking=False):
            """Host batch -> device batch (``non_blocking``: through
            pinned buffers, for `device_prefetch`'s side stream)."""
            if stack_size(graph) is not None:
                raise ValueError(
                    "stacked [R, ...] super-batches need the mesh; build "
                    "batches with num_replicas=None")
            labels = torch.as_tensor(labels)
            if non_blocking and device.type == "cuda":
                labels = labels.pin_memory()
            return (to_device(graph, device, non_blocking=non_blocking),
                    labels.to(device, non_blocking=non_blocking))

        train_step = make_graph_train_step(loss_fn, opt)
        eval_step = make_graph_eval_step(metric_fn)
        mgr = CheckpointManager(
            self.ckpt_dir, keep=self.keep,
            save_interval_steps=self.save_interval_steps) \
            if self.ckpt_dir else None
        step = 0
        start_epoch = 0
        epoch_start_step = 0
        if mgr is not None and self.resume:
            restored = mgr.restore_latest((named, opt_state))
            if restored is not None:
                step, (saved, opt_state), extra = restored
                with torch.no_grad():
                    for name, p in named.items():
                        p.copy_(saved[name])
                start_epoch = int(extra.get("epoch", 0))
                epoch_start_step = int(extra.get("step_in_epoch", 0))
        monitor = self.early_stopping or (
            # best-tracking without early stopping: an unreachable
            # patience makes `update` pure best bookkeeping
            EarlyStopping(monitor="loss", patience=2 ** 62, mode="min")
            if eval_provider is not None and self.eval_at == "epoch"
            else None)
        stop_early = False
        eval_history = []
        losses, step_seconds, waits = [], [], []
        last_loss = float("nan")
        cur_epoch = start_epoch
        step_in_epoch = epoch_start_step
        t0 = time.time()

        def run_eval():
            return evaluate(eval_provider, task, eval_step, place,
                            metric_keys=metric_keys)

        def save(at_step, epoch, in_epoch):
            # the state is copied to the host before save_async returns:
            # the next step updates the parameters in place
            mgr.save_async(at_step, (named, opt_state),
                           extra={"epoch": epoch, "step_in_epoch": in_epoch})

        # the layout hint is read per call by the kernel registry, on the
        # calling thread: hold it on the loop's thread for every step; the
        # manager's exit joins its writer thread, however fit ends
        with registry.layout(sorted_by_target=esbt), \
                mgr if mgr is not None else contextlib.nullcontext():
            for epoch in range(start_epoch, self.epochs):
                if self.max_steps is not None and step >= self.max_steps:
                    break
                start = epoch_start_step if epoch == start_epoch else 0
                cur_epoch = epoch
                pairs = self._labeled(
                    train_provider.epoch(epoch, start_step=start), task,
                    epoch, start)
                if self.double_buffer:
                    placed = device_prefetch(pairs, place, device=device)
                else:
                    placed = (place(g, l) for g, l in pairs)
                step_in_epoch = start
                t_step = time.perf_counter()
                for graph, labels in placed:
                    if self.max_steps is not None \
                            and step >= self.max_steps:
                        placed.close()  # joins the device_prefetch thread
                        break
                    waits.append(time.perf_counter() - t_step)
                    named, opt_state, loss = train_step(
                        named, opt_state, graph, labels)
                    step += 1
                    step_in_epoch += 1
                    last_loss = float(loss)
                    losses.append(last_loss)
                    now = time.perf_counter()
                    step_seconds.append(now - t_step)
                    t_step = now
                    if step % self.log_every == 0:
                        print(f"epoch {epoch} step {step} "
                              f"loss {last_loss:.4f} "
                              f"({self.log_every / (time.time() - t0):.1f}"
                              f" it/s)", flush=True)
                        t0 = time.time()
                    if mgr is not None and mgr.should_save(step):
                        save(step, epoch, step_in_epoch)
                if eval_provider is not None and self.eval_at == "epoch":
                    em = run_eval()
                    eval_history.append(em)
                    print(f"epoch {epoch} eval "
                          + " ".join(f"{k} {v:.4f}"
                                     for k, v in sorted(em.items())),
                          flush=True)
                    if monitor is not None:
                        is_best = monitor.update(em[monitor.monitor],
                                                 step=step)
                        if is_best and self.track_best and mgr is not None:
                            # pin this step's weights as `best` (its save
                            # must land before the pointer)
                            save(step, epoch, step_in_epoch)
                            mgr.wait()
                            mgr.mark_best(step)
                        if monitor.should_stop:
                            stop_early = True
                            break

            metrics = {}
            if eval_provider is not None and self.eval_at == "end":
                em = run_eval()
                eval_history.append(em)
                metrics["eval"] = em
            if mgr is not None:
                save(step, cur_epoch, step_in_epoch)
                mgr.wait()
        if eval_history:
            metrics.setdefault("eval", eval_history[-1])
            metrics["eval_history"] = eval_history
        if monitor is not None and monitor.best_step is not None:
            metrics["best_step"] = monitor.best_step
            metrics["best_value"] = monitor.best
        if stop_early:
            metrics["stopped_early"] = True
        metrics["params"] = {k: p.detach() for k, p in named.items()}
        metrics["train_losses"] = losses
        metrics["step_seconds"] = step_seconds
        metrics["batch_wait_seconds"] = waits
        return RunResult(step, last_loss, metrics)
