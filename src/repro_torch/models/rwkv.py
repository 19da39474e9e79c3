"""RWKV6 ("Finch") language model: attention-free, O(1)-state decode
(counterpart of `repro.models.rwkv`).

The reference stacks its blocks and scans them; here they are an
`nn.ModuleList` named ``blocks`` run by a Python loop
(`layers.load_jax_lm_params` splits the stack), each under
`maybe_remat` outside decode, as the reference's scan body.  The cache
holds each layer's token shifts and wkv state, stacked ``[L, B, ...]``
in fp32.

On a mesh `split_` splits the model over its "model" axis: each block's
channel mix by its hidden width and its time mix by heads where the axis
divides them, else by value columns (`repro_torch.nn.ssm`; rwkv6-3b's 40
heads of 64 at model 16: 4 value columns of every head a rank, r, k, v,
g and o cut at rest by the fused columns and gathered at use, as the
reference's resolver places them and cuts the wkv state), the embedding
table and the untied head by vocabulary.  The head then gives this
rank's logits for the split cross-entropy (`vocab_shard`), serving
all-gathers them, and the cache holds this rank's heads of the wkv
state, or its value columns of every head.

Under the ``"seq": "model"`` rule (`sharding.seq_axis`) the family is
sequence parallel in training and prefill, as `DecoderLM` is: between
blocks the residual stream is this rank's contiguous slice of the
sequence (the embedding's vocabulary-split sum reduce-scattered, the
input norm on the slice).  Each block norms its slice and gathers the
normed sequence (inside its checkpointed region), so both token shifts
and the wkv recurrence see every earlier position, as the reference's
scan over the whole sequence does; the time mix's ``o`` (split by
heads) reduce-scatters its parts along the sequence, and a part whole
over "model" (the channel mix, whose channel gather then reduce-scatters
its gradient; a time mix computed whole) keeps the rank's slice of its
output; a time mix cut by value columns reduce-scatters its ``o`` parts
as one cut by heads does.  The final norm runs on the slice and the
normed sequence is gathered for the head (``head_seq``).  The states a
prefill returns are the whole sequence's last (every rank computes them
from the gathered sequence), so every rank's cache holds them.  The
state has no sequence dim, so the rule cuts nothing of the cache.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import (Axis, all_gather, copy_to,
                                                 gather_seq, grad_share)
from repro_torch.distributed.sharding import seq_axis, shard_activation
from repro_torch.distributed import fsdp
from repro_torch.nn.layers import Embedding, LayerNorm, Linear, splits
from repro_torch.nn.ssm import RWKV6ChannelMix, RWKV6TimeMix
from repro_torch.nn.transformer import (LMOutput, gather_block_input,
                                        maybe_remat, seq_sum, slice_embedded,
                                        torch_dtype, vocab_shard, whole_vocab,
                                        zero_aux)


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

    def forward(self, x, shift_tm, wkv, shift_cm, seq: Axis | None = None):
        """``seq``: `x` is this rank's slice of a sequence cut over that
        axis, and so is the output; the states are the whole
        sequence's (module docstring)."""
        if seq is not None:
            return self._seq_forward(x, shift_tm, wkv, shift_cm, seq)
        y, shift_tm, wkv = self.tm(self.ln1(x), shift_tm, wkv)
        x = x + y
        y, shift_cm = self.cm(self.ln2(x), shift_cm)
        return (shard_activation(x + y, ("batch", "seq", None)), shift_tm,
                wkv, shift_cm)

    def _seq_forward(self, x, shift_tm, wkv, shift_cm, seq: Axis):
        with fsdp.saving_slices() as scope:
            h = gather_block_input(self.ln1(x), seq, scope)
            y, shift_tm, wkv = self.tm(h, shift_tm, wkv, reduce=False)
            x = x + seq_sum([(y, self.tm.axis is not None)], seq)
            h = gather_block_input(self.ln2(x), seq, scope)
            y, shift_cm = self.cm(h, shift_cm, reduce=False)
            x = x + seq_sum([(y, False)], seq)
        # the last positions as copies: a view would keep the gathered
        # sequence alive
        return (shard_activation(x, ("batch", "seq", None)),
                shift_tm.clone(), wkv, shift_cm.clone())

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
        # the axis the last `backbone`'s sequence was cut over (its output
        # is then normed already), read by `apply_head`
        self.head_seq: Axis | None = None

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

    def _logits(self, x, whole: bool = False, seq: Axis | None = None):
        """fp32 logits of this rank's vocabulary slice; with `whole`, all
        of them (serving).  `seq`: `x` is normed and gathered over that
        axis (`backbone`): a split head reads it as it is, and a whole
        one, which every rank computes alike, carries 1/M of its
        gradient."""
        head = self.head if self.head is not None else self.embed
        with fsdp.gathered(self.ln_out, head):
            if seq is None:
                x = self.ln_out(x)
            if self.head is not None:
                h = x if seq is not None else copy_to(x, self.head.axis)
                logits = self.head(h)
            else:
                logits = self.embed.attend(x, reduce=seq is None)
        if seq is not None and self.vocab_shard() is None:
            logits = grad_share(logits, seq)
        if whole:
            logits = whole_vocab(logits, self.vocab_shard())
        return logits.to(torch.float32)

    def init_cache(self, batch: int, max_len: int = 0) -> RWKVCache:
        """Zero states (this rank's heads of the wkv state where the time
        mix is split by heads, its value columns of every head where it
        is cut by them); `max_len` is unused (the state is O(1))."""
        del max_len
        cfg = self.cfg
        l, d, p = cfg.num_layers, cfg.d_model, cfg.ssm_head_dim
        tm = self.blocks[0].tm
        dev = self.embed.table.device
        f32 = torch.float32
        return RWKVCache(
            torch.zeros((l, batch, d), dtype=f32, device=dev),
            torch.zeros((l, batch, tm.n_heads, p, tm.value_dim), dtype=f32,
                        device=dev),
            torch.zeros((l, batch, d), dtype=f32, device=dev), 0)

    def cache_axes(self) -> RWKVCache:
        """The state's logical axes (the reference's `cache_axes`)."""
        return RWKVCache(("layers", "batch", None),
                         ("layers", "batch", "heads", None, "mlp"),
                         ("layers", "batch", None), ())

    def _embed(self, tokens, seq: Axis | None = None):
        """The embedded, normed tokens; with `seq`, this rank's slice of
        them (a split table's parts reduce-scattered)."""
        with fsdp.gathered(self.embed, self.ln_in):
            x = self.embed(tokens, dtype=torch_dtype(self.cfg.compute_dtype),
                           reduce=seq is None)
            if seq is not None:
                x = slice_embedded(x, self.embed, seq)
            return self.ln_in(x)

    def _run(self, x, cache: RWKVCache, decode: bool, n_new: int,
             seq: Axis | None = None):
        s_tm, wkv, s_cm = [], [], []
        for i, block in enumerate(self.blocks):
            if decode:
                x, a, b, c = fsdp.gathering(block.decode, block)(
                    x, cache.shift_tm[i], cache.wkv[i], cache.shift_cm[i])
            else:
                x, a, b, c = maybe_remat(block, self.cfg)(
                    x, cache.shift_tm[i], cache.wkv[i], cache.shift_cm[i],
                    seq=seq)
            s_tm.append(a)
            wkv.append(b)
            s_cm.append(c)
        return x, RWKVCache(torch.stack(s_tm), torch.stack(wkv),
                            torch.stack(s_cm), cache.length + n_new)

    def backbone(self, tokens, **_):
        """([B, S, d], aux); under sequence parallelism the final norm
        runs on this rank's slice and the normed sequence is gathered
        (``head_seq`` says so to `apply_head`)."""
        seq = seq_axis(tokens.shape[1])
        x = shard_activation(self._embed(tokens, seq), ("batch", "seq", None))
        x, _ = self._run(x, self.init_cache(tokens.shape[0]), False,
                         tokens.shape[1], seq)
        if seq is not None:
            with fsdp.gathered(self.ln_out):
                x = gather_seq(self.ln_out(x), seq)
        self.head_seq = seq
        return x, zero_aux(x.device)

    def apply_head(self, x):
        return self._logits(x, seq=self.head_seq)

    def forward(self, tokens, **_) -> LMOutput:
        x, aux = self.backbone(tokens)
        return LMOutput(self._logits(x, whole=True, seq=self.head_seq), aux)

    def prefill(self, tokens, max_len: int | None = None, **_):
        """Logits of the last position and the states after the prompt
        (`max_len` is unused); under sequence parallelism the residual
        is this rank's slice and the states the whole prompt's."""
        del max_len
        seq = seq_axis(tokens.shape[1])
        x, cache = self._run(self._embed(tokens, seq),
                             self.init_cache(tokens.shape[0]), False,
                             tokens.shape[1], seq)
        last = x[:, -1:]
        if seq is not None:  # the last position is the last rank's
            last = all_gather(last, seq, 1)[:, -1:]
        return (LMOutput(self._logits(last, whole=True),
                         zero_aux(x.device)), cache)

    def decode_step(self, tokens, cache: RWKVCache):
        x, cache = self._run(self._embed(tokens), cache, True,
                             tokens.shape[1])
        return LMOutput(self._logits(x, whole=True), zero_aux(x.device)), cache
