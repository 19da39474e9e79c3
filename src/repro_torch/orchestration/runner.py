"""API Level 4 — the Orchestrator (paper §5 / §8.4; counterpart of
`repro.orchestration.runner`).

A thin shim: `run(...)` maps its historical kwargs onto the three
orchestration pieces —

  `repro_torch.orchestration.tasks`      Task: head + labels + loss + metrics
  `repro_torch.orchestration.providers`  DatasetProvider: the batch stream
  `repro_torch.orchestration.trainer`    Trainer: steps, loop, eval

— and delegates to `Trainer.fit`, kwarg for kwarg as the reference
composes them: ``sampler="in_process"`` over ``train_batches``, or
``sampler="service"`` over a `repro_torch.sampling_service` fleet.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.core.graph_tensor import GraphTensor
from repro_torch.orchestration.providers import (IteratorProvider,
                                                 ServiceProvider)
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
    ``sampler="service"`` instead streams from ``service`` (a
    `repro_torch.sampling_service.SamplingService`) with
    ``label_fn(graph)`` extracting labels host-side, and places batches
    on the device a step ahead by default (``double_buffer``: pinned
    host copies on a side CUDA stream, `train_loop.device_prefetch`).
    ``device`` and ``params`` go to the Trainer (CUDA by default; a
    reference parameter tree instead of the seeded draw), and so do
    ``num_devices`` / ``model_parallel``: the mesh over the world's
    ranks, which then trains stacked ``[R, ...]`` super-batches."""
    if sampler == "service":
        if service is None or label_fn is None:
            raise ValueError("sampler='service' needs service= (a "
                             "SamplingService) and label_fn=")
        provider = ServiceProvider(service, label_fn=label_fn)
        if edges_sorted_by_target is None:
            # trust the plan's layout bit when the handle exposes it; a
            # wrong hint costs kernel speed, never correctness
            edges_sorted_by_target = bool(getattr(
                getattr(service, "plan", None), "edges_sorted_by_target",
                True))
    elif sampler == "in_process":
        if train_batches is None:
            raise ValueError("sampler='in_process' needs train_batches=")
        provider = IteratorProvider(train_batches)
        if edges_sorted_by_target is None:
            # GraphBatcher sorts by (component, target) by default
            edges_sorted_by_target = True
    else:
        raise ValueError(f"unknown sampler {sampler!r} "
                         "(want 'in_process' or 'service')")
    if double_buffer is None:
        double_buffer = sampler == "service"

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
    for key in ("train_losses", "step_seconds", "batch_wait_seconds"):
        metrics[key] = result.metrics[key]
    return RunResult(result.step, result.train_loss, metrics)
