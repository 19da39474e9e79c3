"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention +
MLP block applied after each group of layers (counterpart of
`repro.models.zamba`).

One parameter set, ``shared``, serves every application, each with its
own KV cache; the port holds it once, as the reference does.  The Mamba2
layers are an `nn.ModuleList` named ``mamba`` (the reference's stacked
``mamba`` tree, split by `layers.load_jax_lm_params`); in training each
runs under `maybe_remat`, and the shared block does not, as in the
reference.  The KV cache is ``[G, B, max_len, K, D]`` in the compute
dtype; its ``length`` is set by the serving engine as the dense
decoder's is, so the reference engine's KV gap applies here too.

On a mesh `split_` splits the model over its "model" axis: each Mamba2
layer by SSM heads (`repro_torch.nn.ssm`), the shared block as
`DecoderBlock.split_` does, and the tied embedding table by vocabulary
(the head then gives this rank's logits, `vocab_shard`; serving
all-gathers them).  The SSM states are cut by heads, and the shared
attention's caches by kv heads.

Under the ``"seq": "model"`` rule (`sharding.seq_axis`) the family is
sequence parallel as `DecoderLM` is: the residual stream is this rank's
slice of the sequence; each Mamba2 layer norms its slice, gathers the
normed sequence at its entry (inside its checkpointed region in
training), scans it with this rank's heads and reduce-scatters
``out_proj``'s parts along the sequence (a whole layer keeps its slice
of its output); each application of the shared block runs as
`DecoderBlock` does under the rule, and the shared attention's caches
are cut by sequence (`KVCache.seq`; the SSM states have no sequence dim
and stay cut by heads).  The head reads the gathered, normed sequence:
a split table gives its vocabulary slice, a whole one carries 1/M of its
gradient.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed.collectives import (Axis, all_gather,
                                                 gather_seq, grad_share)
from repro_torch.distributed.sharding import seq_axis, shard_activation
from repro_torch.nn.attention import KVCache, cut_by, write_positions
from repro_torch.nn.layers import Embedding, RMSNorm
from repro_torch.nn.ssm import Mamba2, Mamba2State
from repro_torch.nn.transformer import (DecoderBlock, LMOutput,
                                        gather_block_input, maybe_remat,
                                        seq_sum, slice_embedded, sum_aux,
                                        torch_dtype, whole_vocab)


@dataclasses.dataclass
class ZambaCache:
    ssm: torch.Tensor   # [L, B, H, P, N]
    conv: torch.Tensor  # [L, B, K-1, conv_dim]
    k: torch.Tensor     # [G, B, S, Kh, Dh]: one cache an application
    v: torch.Tensor
    length: int
    # k / v cut by sequence over it (`attention.cut_by`, as KVCache.seq)
    seq: ClassVar[Axis | None] = None


class MambaResidualBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model)
        self.mamba = Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand)

    def forward(self, x, state: Mamba2State, seq: Axis | None = None):
        """``seq``: `x` is this rank's slice of a sequence cut over that
        axis: the layer norms it, gathers the normed whole, scans it and
        gives the slice of its output's sum (module docstring; the state
        is the whole sequence's)."""
        if seq is None:
            y, state = self.mamba(self.norm(x), state)
            return x + y, state
        with fsdp.saving_slices() as scope:
            h = gather_block_input(self.norm(x), seq, scope)
            y, state = self.mamba(h, state, reduce=False)
            return (x + seq_sum([(y, self.mamba.axis is not None)], seq),
                    state)

    def decode(self, x, state: Mamba2State):
        y, state = self.mamba.decode_step(self.norm(x), state)
        return x + y, state


class Zamba2LM(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model)
        self.mamba = nn.ModuleList(MambaResidualBlock(cfg)
                                   for _ in range(cfg.num_layers))
        # the shared attention + MLP block: one parameter set, G uses
        self.shared = DecoderBlock(cfg)
        self.final_norm = RMSNorm(cfg.d_model)
        self.n_groups = max(1, cfg.num_layers // cfg.hybrid_attn_every)
        # the axis the last `backbone`'s sequence was cut over (its output
        # is then normed already), read by `apply_head`
        self.head_seq: Axis | None = None

    def split_(self, axis: Axis) -> None:
        """Tensor parallelism over `axis` (module docstring), each part
        where the axis divides its count; the parameters become this
        rank's slices in place."""
        for block in self.mamba:
            block.mamba.split_(axis)
        self.shared.split_(axis)
        self.embed.split_(axis)

    def vocab_shard(self) -> tuple | None:
        """(axis, first id) of this rank's logits, or None when whole."""
        return self.embed.vocab_shard()

    def group_sizes(self) -> list[int]:
        l, g = self.cfg.num_layers, self.n_groups
        base = l // g
        rem = l - base * g
        return [base + (1 if i < rem else 0) for i in range(g)]

    def init_cache(self, batch: int, max_len: int) -> ZambaCache:
        """Zero states (this rank's heads) and K/V of `max_len` positions:
        this rank's kv heads, or under sequence parallelism every kv head
        of this rank's positions."""
        cfg = self.cfg
        m = self.mamba[0].mamba
        dev = self.embed.table.device
        f32 = torch.float32
        seq = seq_axis(max_len) if max_len else None
        held = max_len // seq.size if seq is not None else max_len
        n_kv = cfg.n_kv_heads if seq is not None else self.shared.attn.n_kv
        kv = (self.n_groups, batch, held, n_kv, cfg.resolved_head_dim)
        dtype = torch_dtype(cfg.compute_dtype)
        return cut_by(ZambaCache(
            ssm=torch.zeros((cfg.num_layers, batch, m.n_heads, m.head_dim,
                             m.d_state), dtype=f32, device=dev),
            conv=torch.zeros((cfg.num_layers, batch, m.conv_kernel - 1,
                              m.conv_dim), dtype=f32, device=dev),
            k=torch.zeros(kv, dtype=dtype, device=dev),
            v=torch.zeros(kv, dtype=dtype, device=dev), length=0), seq=seq)

    def cache_axes(self) -> ZambaCache:
        """The cache's logical axes (the reference's `cache_axes`)."""
        kv = (None, "batch", "seq", "kv_heads", None)
        return ZambaCache(("layers", "batch", "heads", None, None),
                          ("layers", "batch", None, "mlp"), kv, kv, ())

    def _logits(self, x, seq: Axis | None = None, whole: bool = False):
        """fp32 logits of this rank's vocabulary slice; with `whole`, all
        of them (serving).  `seq`: `x` is normed and gathered over that
        axis (`backbone`): a split table reads it as it is, and a whole
        one, which every rank computes alike, carries 1/M of its
        gradient."""
        with fsdp.gathered(self.final_norm, self.embed):
            if seq is None:
                x = self.final_norm(x)
            logits = self.embed.attend(x, reduce=seq is None)
        if self.vocab_shard() is None:
            logits = grad_share(logits, seq)
        elif whole:
            logits = whole_vocab(logits, self.vocab_shard())
        return logits.to(torch.float32)

    def _run_groups(self, x, cache: ZambaCache, mode: str,
                    seq: Axis | None = None):
        """mode: "train", "prefill" or "decode"; `seq`: `x` is this
        rank's slice of a sequence cut over it.  Returns (x, the new
        ssm and conv states stacked [L, ...], the prefill's per-group
        (k, v), the summed aux)."""
        ssm, conv, kvs, auxes = [], [], [], []
        layer = 0
        for g, size in enumerate(self.group_sizes()):
            for block in self.mamba[layer:layer + size]:
                state = Mamba2State(cache.ssm[layer], cache.conv[layer])
                if mode == "decode":
                    with fsdp.gathered(block):
                        x, state = block.decode(x, state)
                elif mode == "train":
                    x, state = maybe_remat(block, self.cfg)(x, state,
                                                            seq=seq)
                else:
                    with fsdp.gathered(block):
                        x, state = block(x, state, seq=seq)
                ssm.append(state.ssm)
                conv.append(state.conv)
                layer += 1
            # shared attention block, application g (gathered for each)
            with fsdp.gathered(self.shared):
                if mode == "train":
                    x, aux = self.shared(x, seq=seq)
                elif mode == "prefill":
                    x, kv, aux = self.shared.prefill(x, seq=seq)
                    kvs.append(kv)
                else:
                    x, _, aux = self.shared.decode(
                        x, cut_by(KVCache(cache.k[g], cache.v[g],
                                          cache.length), seq=cache.seq))
            auxes.append(aux)
        return (x, torch.stack(ssm), torch.stack(conv), kvs,
                sum_aux(auxes))

    def _embed(self, tokens, seq: Axis | None = None):
        """The embedded tokens; with `seq`, this rank's slice of them (a
        split table's parts reduce-scattered)."""
        with fsdp.gathered(self.embed):
            x = self.embed(tokens, dtype=torch_dtype(self.cfg.compute_dtype),
                           reduce=seq is None)
        return x if seq is None else slice_embedded(x, self.embed, seq)

    def backbone(self, tokens, **_):
        """([B, S, d], aux); under sequence parallelism the final norm
        runs on this rank's slice and the normed sequence is gathered
        (``head_seq`` says so to `apply_head`)."""
        seq = seq_axis(tokens.shape[1])
        cache = self.init_cache(tokens.shape[0], max_len=0)
        x = shard_activation(self._embed(tokens, seq),
                             ("batch", "seq", None))
        x, _, _, _, aux = self._run_groups(x, cache, "train", seq)
        if seq is not None:
            with fsdp.gathered(self.final_norm):
                x = gather_seq(self.final_norm(x), seq)
        self.head_seq = seq
        return x, aux

    def apply_head(self, x):
        return self._logits(x, self.head_seq)

    def forward(self, tokens, **_) -> LMOutput:
        x, aux = self.backbone(tokens)
        return LMOutput(self._logits(x, self.head_seq, whole=True), aux)

    def prefill(self, tokens, max_len: int | None = None, **_):
        """Logits of the last position and the cache: the states after
        the prompt and each application's K/V, cast to the compute dtype
        and padded with zeros to `max_len` (never cut below the
        prompt)."""
        b, s = tokens.shape
        seq = seq_axis(s)
        x, ssm, conv, kvs, aux = self._run_groups(
            self._embed(tokens, seq), self.init_cache(b, max_len=0),
            "prefill", seq)
        cache = self.init_cache(b, max(max_len or s, s))
        for g, (k, v) in enumerate(kvs):
            if cache.seq is not None:  # every kv head of its positions
                k, v = self.shared.attn.all_heads(k, v)
            write_positions(cache.k[g], k, 0, cache.seq)
            write_positions(cache.v[g], v, 0, cache.seq)
        cache.ssm, cache.conv, cache.length = ssm, conv, s
        last = x[:, -1:]
        if seq is not None:  # the last position is the last rank's
            last = all_gather(last, seq, 1)[:, -1:]
        return LMOutput(self._logits(last, whole=True), aux), cache

    def decode_step(self, tokens, cache: ZambaCache):
        """Writes the new K/V into `cache`'s tensors in place and returns
        the cache with the new states, one token longer."""
        x, ssm, conv, _, aux = self._run_groups(self._embed(tokens), cache,
                                                "decode")
        return (LMOutput(self._logits(x, whole=True), aux),
                cut_by(ZambaCache(ssm, conv, cache.k, cache.v,
                                  cache.length + tokens.shape[1]),
                       seq=cache.seq))
