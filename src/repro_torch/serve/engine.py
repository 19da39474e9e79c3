"""Batched LM serving engine: a continuous-batching prefill/decode
scheduler (counterpart of `repro.serve.engine`).

  * a fixed decode batch of `n_slots` sequences (left-aligned KV cache);
  * prefill admits a request into a free slot, and its one-sequence cache
    is spliced into the batch cache at that slot: every cache tensor whose
    axis 1 is the slot axis (``ndim >= 2`` and ``shape[1] == n_slots``),
    cast to the batch tensor's dtype, the reference's rule
    (`repro/serve/engine.py:67-72`), so RWKV's states and Zamba's states
    and K/V are spliced as the dense K/V are;
  * one decode step advances every slot a tick;
  * greedy or temperature sampling.

The bookkeeping is the reference's line for line, its gap included:
`admit` records ``len(prompt) + 1`` as the slot's length and `step` sets
the cache's length to the longest slot, so the first decode writes its
K/V at position P + 1 and position P stays a zero row inside the length
mask (`repro/serve/engine.py:77,92-94`; ROADMAP.md queue 3).  The
reference jits its step functions; here they run eagerly under
`torch.inference_mode`.  Temperature sampling takes the Gumbel maximum,
as `jax.random.categorical` does, with noise from a seeded
`torch.Generator` on the engine's device (other bits than the
reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph_tensor import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.nn.layers import load_jax_lm_params


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-device engine.  `params_or_model` is a model built for
    `cfg` (used as it is, on its own device) or a reference parameter
    tree of numpy leaves (loaded into a model built on `device`, by
    default the card)."""

    def __init__(self, cfg: ArchConfig, params_or_model, *,
                 n_slots: int = 4, max_len: int = 512, rng_seed: int = 0,
                 device=None):
        self.cfg = cfg
        if isinstance(params_or_model, nn.Module):
            self.model = params_or_model
            self.device = self.model.embed.table.device
        else:
            self.device = resolve_device(device)
            self.model = load_jax_lm_params(build_model(cfg, self.device),
                                            params_or_model)
        self.n_slots = n_slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(rng_seed))
        self.cache = self.model.init_cache(n_slots, max_len)
        self.slot_busy = np.zeros(n_slots, bool)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int32)

    # -- request admission ---------------------------------------------------

    @torch.inference_mode()
    def admit(self, req: Request) -> bool:
        free = np.where(~self.slot_busy)[0]
        if len(free) == 0:
            return False
        slot = int(free[0])
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        out, cache1 = self.model.prefill(tokens, max_len=self.max_len)
        self._splice(cache1, slot)
        first = int(torch.argmax(out.logits[0, -1]))
        req.generated.append(first)
        self.slot_busy[slot] = True
        self.slot_req[slot] = req
        self.slot_len[slot] = len(req.prompt) + 1
        return True

    def _splice(self, one, slot: int) -> None:
        """Write the one-sequence cache `one` into the batch cache at
        `slot`, in place: each tensor field whose axis 1 is the slot
        axis."""
        for field in dataclasses.fields(self.cache):
            batch = getattr(self.cache, field.name)
            if (isinstance(batch, torch.Tensor) and batch.ndim >= 2
                    and batch.shape[1] == self.n_slots):
                batch[:, slot:slot + 1] = getattr(one, field.name).to(
                    batch.dtype)

    # -- decode tick ---------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> list:
        """One token a slot: argmax, or for a slot at temperature T > 0
        the argmax of ``logits / T`` plus Gumbel noise.  One host sync."""
        temps = [req.temperature if req is not None else 0.0
                 for req in self.slot_req]
        toks = torch.argmax(logits, dim=-1)
        hot = [s for s, t in enumerate(temps) if t > 0]
        if hot:
            rows = torch.tensor(hot, device=self.device)
            t = torch.tensor([temps[s] for s in hot], dtype=torch.float32,
                             device=self.device)
            u = torch.rand((len(hot), logits.shape[-1]),
                           generator=self.generator, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            toks[rows] = torch.argmax(logits[rows] / t[:, None] + gumbel,
                                      dim=-1)
        return toks.tolist()

    @torch.inference_mode()
    def step(self) -> int:
        """One decode step across all slots; returns the number still
        active."""
        if not self.slot_busy.any():
            return 0
        toks = np.zeros((self.n_slots, 1), np.int64)
        for s, req in enumerate(self.slot_req):
            if req is not None and req.generated:
                toks[s, 0] = req.generated[-1]
        # the batch cache's length, where it has one: the longest slot
        # (the reference's documented simplification)
        if hasattr(self.cache, "length"):
            self.cache.length = int(self.slot_len.max())
        out, self.cache = self.model.decode_step(
            torch.as_tensor(toks, device=self.device), self.cache)
        sampled = self._sample(out.logits[:, -1])
        active = 0
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.generated.append(sampled[s])
            self.slot_len[s] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or self.slot_len[s] >= self.max_len - 1):
                req.done = True
                self.slot_busy[s] = False
                self.slot_req[s] = None
            else:
                active += 1
        return active

    def run(self, requests: list[Request]) -> list[Request]:
        pending = list(requests)
        done: list[Request] = []
        while pending or self.slot_busy.any():
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step()
            done = [r for r in requests if r.done]
        return done
