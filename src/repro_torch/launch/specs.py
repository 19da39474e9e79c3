"""Step specs by architecture (counterpart of `repro.launch.specs`).

For now the optimizer policy by model scale, `pick_optimizer`
(`repro/launch/specs.py:56-65`); the input specs and step factories of
the dry-run come with `launch/{dryrun,roofline,mesh}` (ROADMAP.md queue
1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.train.optimizer import make_optimizer


def pick_optimizer(cfg: ArchConfig):
    """Optimizer policy by model scale: under 20 B parameters AdamW with
    fp32 moments; 20-100 B AdamW with bf16 moments; 100 B and up
    Adafactor (factored second moment).  The reference sized these
    classes for its TPU's memory; the policy is kept as it is."""
    n = cfg.param_count_estimate()
    if n >= 100e9:
        return make_optimizer("adafactor", 1e-4)
    if n >= 20e9:
        return make_optimizer("adamw", 3e-4, moment_dtype=torch.bfloat16)
    return make_optimizer("adamw", 3e-4)
