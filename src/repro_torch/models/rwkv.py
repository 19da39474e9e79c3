"""RWKV6 ("Finch") language model: attention-free, O(1)-state decode
(counterpart of `repro.models.rwkv`).

The reference stacks its blocks and scans them; here they are an
`nn.ModuleList` named ``blocks`` run by a Python loop
(`layers.load_jax_lm_params` splits the stack), each under
`maybe_remat` outside decode, as the reference's scan body.  The cache
holds each layer's token shifts and wkv state, stacked ``[L, B, ...]``
in fp32.  The state has no sequence dim, so the ``"seq": "model"``
rule cuts nothing of it; the residual stream cut by sequence in
training, which the reference does under that rule, is not ported:
`backbone` raises under it (prefill keeps the residual whole).

On a mesh `split_` splits the model over its "model" axis: each block's
channel mix by its hidden width and its time mix by heads where the axis
divides them (`repro_torch.nn.ssm`; rwkv6-3b's 40 heads compute whole at
model 16, their r, k, v, g and o cut at rest by the fused columns and
gathered at use, the wkv state whole: the reference cuts it by value
columns there, a follow-up in ROADMAP.md), the embedding table and the
untied head by vocabulary.  The head then gives this rank's logits for
the split cross-entropy (`vocab_shard`), serving all-gathers them, and
the cache holds this rank's heads of the wkv state.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import Axis, copy_to
from repro_torch.distributed.sharding import seq_axis, shard_activation
from repro_torch.distributed import fsdp
from repro_torch.nn.layers import Embedding, LayerNorm, Linear, splits
from repro_torch.nn.ssm import RWKV6ChannelMix, RWKV6TimeMix
from repro_torch.nn.transformer import (LMOutput, maybe_remat, torch_dtype,
                                        vocab_shard, whole_vocab, zero_aux)


@dataclasses.dataclass
class RWKVCache:
    shift_tm: torch.Tensor  # [L, B, d]
    wkv: torch.Tensor       # [L, B, H, dk, dk]
    shift_cm: torch.Tensor  # [L, B, d]
    length: int


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.tm = RWKV6TimeMix(cfg.d_model, head_dim=cfg.ssm_head_dim)
        self.cm = RWKV6ChannelMix(cfg.d_model, cfg.d_ff)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)

    def forward(self, x, shift_tm, wkv, shift_cm):
        y, shift_tm, wkv = self.tm(self.ln1(x), shift_tm, wkv)
        x = x + y
        y, shift_cm = self.cm(self.ln2(x), shift_cm)
        return (shard_activation(x + y, ("batch", "seq", None)), shift_tm,
                wkv, shift_cm)

    def decode(self, x, shift_tm, wkv, shift_cm):
        y, shift_tm, wkv = self.tm.decode_step(self.ln1(x), shift_tm, wkv)
        x = x + y
        y, shift_cm = self.cm(self.ln2(x), shift_cm)
        return x + y, shift_tm, wkv, shift_cm


class RWKV6LM(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(RWKVBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_in = LayerNorm(cfg.d_model)
        self.ln_out = LayerNorm(cfg.d_model)
        self.head = (None if cfg.tie_embeddings else
                     Linear(cfg.d_model, cfg.vocab_size, use_bias=False,
                            kernel_axes=("embed", "vocab")))

    def split_(self, axis: Axis) -> None:
        """Tensor parallelism over `axis` (module docstring), each part
        where the axis divides its count; the parameters become this
        rank's slices in place."""
        for block in self.blocks:
            block.tm.split_(axis)
            block.cm.split_(axis)
        self.embed.split_(axis)
        if self.head is not None and splits(self.cfg.vocab_size, axis):
            self.head.split_("column", axis)

    def vocab_shard(self) -> tuple | None:
        """(axis, first id) of this rank's logits, or None when whole."""
        return vocab_shard(self.embed, self.head)

    def _logits(self, x, whole: bool = False):
        """fp32 logits of this rank's vocabulary slice; with `whole`, all
        of them (serving)."""
        head = self.head if self.head is not None else self.embed
        with fsdp.gathered(self.ln_out, head):
            x = self.ln_out(x)
            logits = (self.head(copy_to(x, self.head.axis))
                      if self.head is not None else self.embed.attend(x))
        if whole:
            logits = whole_vocab(logits, self.vocab_shard())
        return logits.to(torch.float32)

    def init_cache(self, batch: int, max_len: int = 0) -> RWKVCache:
        """Zero states (this rank's heads of the wkv state where the time
        mix is split); `max_len` is unused (the state is O(1))."""
        del max_len
        cfg = self.cfg
        l, d, p = cfg.num_layers, cfg.d_model, cfg.ssm_head_dim
        h = self.blocks[0].tm.n_heads
        dev = self.embed.table.device
        f32 = torch.float32
        return RWKVCache(
            torch.zeros((l, batch, d), dtype=f32, device=dev),
            torch.zeros((l, batch, h, p, p), dtype=f32, device=dev),
            torch.zeros((l, batch, d), dtype=f32, device=dev), 0)

    def cache_axes(self) -> RWKVCache:
        """The state's logical axes (the reference's `cache_axes`)."""
        return RWKVCache(("layers", "batch", None),
                         ("layers", "batch", "heads", None, "mlp"),
                         ("layers", "batch", None), ())

    def _embed(self, tokens):
        with fsdp.gathered(self.embed, self.ln_in):
            x = self.embed(tokens, dtype=torch_dtype(self.cfg.compute_dtype))
            return self.ln_in(x)

    def _run(self, x, cache: RWKVCache, decode: bool, n_new: int):
        s_tm, wkv, s_cm = [], [], []
        for i, block in enumerate(self.blocks):
            run = (fsdp.gathering(block.decode, block) if decode
                   else maybe_remat(block, self.cfg))
            x, a, b, c = run(x, cache.shift_tm[i], cache.wkv[i],
                             cache.shift_cm[i])
            s_tm.append(a)
            wkv.append(b)
            s_cm.append(c)
        return x, RWKVCache(torch.stack(s_tm), torch.stack(wkv),
                            torch.stack(s_cm), cache.length + n_new)

    def backbone(self, tokens, **_):
        if seq_axis(tokens.shape[1]) is not None:
            raise NotImplementedError(
                "rwkv6: the residual stream cut by sequence (the "
                '"seq": "model" rule) in training is not ported '
                "(ROADMAP.md, follow-ups: sequence parallelism for rwkv6 "
                "and whisper)")
        x = shard_activation(self._embed(tokens), ("batch", "seq", None))
        x, _ = self._run(x,
                         self.init_cache(tokens.shape[0]), False,
                         tokens.shape[1])
        return x, zero_aux(x.device)

    def apply_head(self, x):
        return self._logits(x)

    def forward(self, tokens, **_) -> LMOutput:
        x, aux = self.backbone(tokens)
        return LMOutput(self._logits(x, whole=True), aux)

    def prefill(self, tokens, max_len: int | None = None, **_):
        """Logits of the last position and the states after the prompt
        (`max_len` is unused)."""
        del max_len
        x, cache = self._run(self._embed(tokens),
                             self.init_cache(tokens.shape[0]), False,
                             tokens.shape[1])
        return (LMOutput(self._logits(x[:, -1:], whole=True),
                         zero_aux(x.device)), cache)

    def decode_step(self, tokens, cache: RWKVCache):
        x, cache = self._run(self._embed(tokens), cache, True,
                             tokens.shape[1])
        return LMOutput(self._logits(x, whole=True), zero_aux(x.device)), cache
