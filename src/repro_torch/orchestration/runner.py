"""API Level 4 — the Orchestrator (paper §5 / §8.4; counterpart of
`repro.orchestration.runner`).

A thin shim: `run(...)` maps its historical kwargs onto the three
orchestration pieces —

  `repro_torch.orchestration.tasks`      Task: head + labels + loss + metrics
  `repro_torch.orchestration.providers`  DatasetProvider: the batch stream
  `repro_torch.orchestration.trainer`    Trainer: steps, loop, eval

— and delegates to `Trainer.fit`, kwarg for kwarg as the reference
composes them.  This slice runs ``sampler="in_process"``; the sampling
service (``sampler="service"``) comes with its port and raises here.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.orchestration.providers import IteratorProvider
# re-exports, as the reference's runner makes them: `from
# repro_torch.orchestration.runner import <task>` keeps working
from repro_torch.orchestration.tasks import (  # noqa: F401
    DeepGraphInfomax, GraphBinaryClassification,
    GraphMulticlassClassification, LinkPrediction,
    RootNodeMulticlassClassification, Task)
from repro_torch.orchestration.trainer import RunResult, Trainer


def run(*, train_batches: Optional[Callable[[int],
                                            Iterator[tuple[GraphTensor,
                                                           np.ndarray]]]]
        = None,
        model_fn: Callable,
        task: Task,
        epochs: int = 1,
        learning_rate: float = 1e-3,
        total_steps: int = 1000,
        eval_batches: Optional[Callable[[], Iterator]] = None,
        ckpt_dir: str = "",
        log_every: int = 20,
        seed: int = 0,
        num_devices: Optional[int] = None,
        model_parallel: int = 1,
        max_steps: Optional[int] = None,
        sampler: str = "in_process",
        service=None,
        label_fn: Optional[Callable[[GraphTensor], np.ndarray]] = None,
        double_buffer: Optional[bool] = None,
        edges_sorted_by_target: Optional[bool] = None,
        device: Optional[str] = None,
        params: Any = None) -> RunResult:
    """The paper's runner.run(): wires data, model, task, trainer.

    model_fn() -> (init_states_module, gnn_module); both take and return
    GraphTensors.  train_batches(epoch) yields (padded GraphTensor,
    labels[C]) or bare graphs (labels then come from ``task.labels``).
    ``device`` and ``params`` go to the Trainer (CUDA by default; a
    reference parameter tree instead of the seeded draw)."""
    if sampler != "in_process":
        raise ValueError(f"sampler {sampler!r} is not ported yet (the "
                         "sampling-service slice); use 'in_process'")
    if service is not None or label_fn is not None:
        raise ValueError("service= and label_fn= belong to "
                         "sampler='service', which is not ported yet")
    if train_batches is None:
        raise ValueError("sampler='in_process' needs train_batches=")
    provider = IteratorProvider(train_batches)
    if edges_sorted_by_target is None:
        # GraphBatcher sorts by (component, target) by default
        edges_sorted_by_target = True
    if double_buffer is None:
        double_buffer = False

    eval_provider = (IteratorProvider(lambda epoch: eval_batches())
                     if eval_batches is not None else None)
    trainer = Trainer(
        epochs=epochs, learning_rate=learning_rate,
        total_steps=total_steps, seed=seed, num_devices=num_devices,
        model_parallel=model_parallel, max_steps=max_steps,
        log_every=log_every, double_buffer=double_buffer,
        edges_sorted_by_target=edges_sorted_by_target, ckpt_dir=ckpt_dir,
        eval_at="end" if eval_provider is not None else "never",
        device=device)
    result = trainer.fit(model_fn, task, provider,
                         eval_provider=eval_provider, params=params)

    # legacy metrics surface
    metrics = {}
    if eval_provider is not None:
        metrics["eval_accuracy"] = result.metrics["eval"]["accuracy"]
    metrics["params"] = result.metrics["params"]
    metrics["train_losses"] = result.metrics["train_losses"]
    return RunResult(result.step, result.train_loss, metrics)
