"""Validation/eval streams and early stopping — a copy of
`repro.orchestration.evaluation` (pure Python).

`evaluate` runs one deterministic pass over a validation
`DatasetProvider`, accumulating each task metric as an exact
``(numerator, denominator)`` pair across batches — dividing ONCE at the
end, so the result is independent of batch boundaries and pass order.

`EarlyStopping` is the classic patience/min-delta monitor the Trainer
composes with best-step tracking.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

PAD_EVAL_EPOCH = 0  # eval streams always run epoch 0's permutation


@dataclasses.dataclass
class EarlyStopping:
    """Stop when the monitored metric stops improving.

    * ``monitor`` — metric name (as produced by `Task.metrics`, e.g.
      "loss" or "accuracy").
    * ``mode`` — "min" (improvement = decrease) or "max".
    * ``min_delta`` — an improvement smaller than this does not reset
      patience (but a new best IS still recorded as best: min_delta
      gates *stopping*, not *best tracking* — the standard Keras
      semantics for best-checkpoint + patience).
    * ``patience`` — consecutive non-improving evaluations tolerated
      before `should_stop` turns True.
    """

    monitor: str = "loss"
    patience: int = 3
    min_delta: float = 0.0
    mode: str = "min"

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', "
                             f"got {self.mode!r}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        self.best: Optional[float] = None
        self.best_step: Optional[int] = None
        self.bad_evals: int = 0

    def _better(self, value: float, reference: float,
                delta: float) -> bool:
        if self.mode == "min":
            return value < reference - delta
        return value > reference + delta

    def update(self, value: float, *, step: int = 0) -> bool:
        """Record one evaluation; returns True when `value` is a new best."""
        value = float(value)
        is_best = self.best is None or self._better(value, self.best, 0.0)
        significant = self.best is None or self._better(value, self.best,
                                                        self.min_delta)
        if significant:
            self.bad_evals = 0
        else:
            self.bad_evals += 1
        if is_best:
            self.best = value
            self.best_step = step
        return is_best

    @property
    def should_stop(self) -> bool:
        return self.bad_evals >= self.patience


def merge_metric_sums(totals: Optional[dict], batch_pairs: dict) -> dict:
    """Accumulate one batch's {name: (num, den)} pairs into the running
    float sums."""
    if totals is None:
        totals = {k: (0.0, 0.0) for k in batch_pairs}
    return {k: (totals[k][0] + float(n), totals[k][1] + float(d))
            for k, (n, d) in batch_pairs.items()}


def finalize_metrics(totals: Optional[dict]) -> dict:
    """(num, den) sums -> {name: num/den} (den 0 -> 0.0)."""
    if totals is None:
        return {}
    return {k: (n / d if d else 0.0) for k, (n, d) in totals.items()}


def evaluate(provider, task, eval_step: Callable, place: Callable, *,
             metric_keys: tuple, start_step: int = 0) -> dict:
    """One pass over `provider` -> {metric_name: value}.

    ``eval_step``: a callable ``(graph, labels) -> flat tuple`` of the
    task's (num, den) pairs in ``metric_keys`` order (the parameters are
    the modules' own).  ``place`` is the host->device placement.  Labels
    come from the provider when it yields pairs, else from `task.labels`
    at ``epoch=PAD_EVAL_EPOCH`` — both pure functions of (stream, step),
    so repeated passes are identical."""
    totals = None
    for step, item in enumerate(provider.epoch(PAD_EVAL_EPOCH,
                                               start_step=start_step),
                                start=start_step):
        if isinstance(item, tuple):
            graph, labels = item
        else:
            graph = item
            labels = task.labels(graph, epoch=PAD_EVAL_EPOCH, step=step)
        graph, labels = place(graph, labels)
        flat = eval_step(graph, labels)
        pairs = {k: (flat[2 * i], flat[2 * i + 1])
                 for i, k in enumerate(metric_keys)}
        totals = merge_metric_sums(totals, pairs)
    return finalize_metrics(totals)
