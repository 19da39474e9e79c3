"""AdamW, its schedules and gradient clipping — a line-for-line port of
`repro.train.optimizer` (`:24-175`), without the ZeRO-1 arguments (the
mesh comes with the parallelism slice).

It is not `torch.optim.AdamW`, whose defaults and order differ: b2 is
0.95 and eps 1e-8; the gradient is clipped to global norm 1.0 (with
``norm + 1e-9``) in fp32 inside `update`; weight decay is added to the
Adam step inside the lr-scaled delta; the schedule is read at
``step + 1``; and `warmup_cosine` decays to ``final_frac = 0.1`` of the
peak.  Trees are dicts ``{name: tensor}`` (a module's named parameters);
`update` is pure — it returns new tensors and a new state, and the train
step writes them into the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

Tree = dict  # {name: torch.Tensor}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------

def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over a gradient tree, each leaf squared and summed in
    fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    # multiply in each leaf's own dtype, as the reference does
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    m: Tree
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32
    max_grad_norm: float = 1.0

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=step.device)

    def init(self, params: Tree) -> AdamWState:
        device = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=self.moment_dtype,
                                device=p.device) for k, p in params.items()}
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros,
                          {k: z.clone() for k, z in zeros.items()})

    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> tuple[Tree, AdamWState, dict]:
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        lr = self._lr(step)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            delta = delta + self.weight_decay * p.to(torch.float32)
            new_p = p.to(torch.float32) - lr * delta
            return (new_p.to(p.dtype), m32.to(self.moment_dtype),
                    v32.to(self.moment_dtype))

        out = {k: upd(params[k], grads[k], state.m[k], state.v[k])
               for k in params}
        return ({k: o[0] for k, o in out.items()},
                AdamWState(step, {k: o[1] for k, o in out.items()},
                           {k: o[2] for k, o in out.items()}),
                {"grad_norm": gnorm, "learning_rate": lr})
