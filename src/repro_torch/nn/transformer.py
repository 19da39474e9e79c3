"""Decoder-only LM assembly: dense, MoE and parallel-block variants
(counterpart of `repro.nn.transformer`).

The reference stacks its layers and runs them with `jax.lax.scan`; here
the blocks are an `nn.ModuleList` run by a Python loop, so parameter
names are ``blocks.{i}.…`` (`layers.load_jax_lm_params` splits the
reference's stack).  The training forward (`backbone`) runs each block
under `maybe_remat`, as the reference's scan body.

The reference also passes each scanned layer's parameters through a
gradient-dtype barrier (`constrain_layer_params`, `repro/nn/
transformer.py:43-76`) so that the stacked gradient of a bf16-param
model is not carried at fp32 width.  Nothing here needs it: a PyTorch
leaf's ``.grad`` always has the leaf's dtype (autograd casts the
cotangent of the per-call ``w.to(compute dtype)`` back), and the port's
leaves are per layer.  The KV cache is stacked ``[L, B, T, K, D]``;
decode writes each layer's slice in place.

On a mesh, `DecoderLM.split_` splits the model over its "model" axis
(tensor parallelism, the leaves the reference's rules put on "model"):
attention by whole heads, the MLP by its hidden width, the MoE experts
(each expert by its hidden width where the axis does not divide their
count), the embedding table and the head by vocabulary.  Attention whose
heads the axis does not divide computes whole on every rank, its
weights cut at rest by the fused heads x head_dim columns and gathered
at use (`repro_torch.nn.attention`), as the reference's resolver falls
through to them; a table whose vocabulary the axis does not divide
stays whole.  The head then gives
this rank's logits (`vocab_shard`), and the loss reduces over the axis
without gathering them (`repro_torch.train.train_loop`).  A split model
also serves: `prefill` and `init_cache` size the KV cache by the rank's
kv heads (a whole layer's count where attention stayed whole), and
`forward`, `prefill` and `decode_step` all-gather the vocabulary slices
over the axis, so they return whole logits.

Where the act rule of "seq" names the model axis (the reference's
``"seq": "model"`` override, `sharding.seq_axis`), the model is also
sequence parallel (Megatron's scheme, `repro_torch.distributed.
collectives`): between blocks the residual stream is this rank's
contiguous slice of the sequence.  The embedding's vocabulary-split sum
is reduce-scattered along the sequence; a block runs its norms on the
slice, gathers the normed sequence (`gather_seq`, inside the
checkpointed function, so the saved carry is the slice), and its
row-parallel outputs reduce-scatter instead of all-reducing (the
parallel block sums both branches' parts in one); a part whole over
"model" computes on the whole sequence and keeps the rank's slice.  The
final norm runs on the slice, and the normed sequence is gathered again
for the head and the loss (RoPE positions are the whole sequence's
throughout).  Every leaf whole over "model" then sees only this rank's
slice in some of its uses: `MeshTrainStep` sums its gradient over the
axis.  Under the same rule the KV cache is cut by sequence (every kv
head of this rank's positions; `attention.merged_gqa_attention` in
decode), as the reference's cache axes resolve: a sequence the axis
does not divide stays whole.

Placed by `MeshPlan.place_params_` (FSDP), the leaves are also cut over
"data": each block gathers its own at its entry (`maybe_remat`, or
`fsdp.gathered` around a prefill or decode step), the embedding table,
the final norm and the head at their use (`repro_torch.distributed.
fsdp`).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (Axis, all_gather, copy_to,
                                                 gather_seq, grad_share,
                                                 reduce_scatter_seq,
                                                 split_chunk)
from repro_torch.distributed.sharding import seq_axis, shard_activation
from repro_torch.nn.attention import (Attention, KVCache, causal_mask,
                                      chunked_gqa_attention, cut_by,
                                      gqa_attention, write_positions)
from repro_torch.nn.layers import (MLP, Embedding, LayerNorm, Linear,
                                   RMSNorm, splits)
from repro_torch.nn.moe import MoELayer


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16",
    "float8_e4m3fn", ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


# the matmuls the "dots" policy saves: what `F.linear` and `torch.matmul`
# of a 2-D weight reach on CPU and CUDA (a [B, S, d] input is folded to
# 2-D first); the batched products (attention's and the MoE experts'
# `bmm`) and everything else are recomputed, as the reference's
# `dots_with_no_batch_dims_saveable` saves only dots without batch dims
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVED_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """`fn` (a layer's call) under the config's activation checkpointing,
    the counterpart of the reference's `maybe_remat` on a scan body:
    ``"layer"`` keeps only the layer's inputs and recomputes it in the
    backward (`torch.utils.checkpoint`, non-reentrant); ``"dots"`` keeps
    the outputs of the 2-D matmuls and recomputes the rest (selective
    checkpointing, `_dots_policy`); ``"none"`` is the plain call.  It
    checkpoints only while autograd records: serving runs `fn` as it
    is.  A layer whose parameters are cut over "data" (FSDP) gathers
    them around the call (`fsdp.gathering`), inside the checkpointed
    function, so the recomputation gathers again and never saves a
    whole weight."""
    fn = fsdp.gathering(fn)
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("layer", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    body = fsdp.recomputed(fn)

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if cfg.remat == "layer":
            return _ckpt.checkpoint(body, *args, use_reentrant=False,
                                    **kwargs)
        return _ckpt.checkpoint(
            body, *args, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy),
            **kwargs)

    return run


def make_norm(cfg: ArchConfig, dim: int | None = None) -> nn.Module:
    dim = dim or cfg.d_model
    if cfg.norm == "rmsnorm":
        return RMSNorm(dim)
    return LayerNorm(dim)


def zero_aux(device=None) -> dict[str, torch.Tensor]:
    """The auxiliary losses of a block without MoE: zeros (on the host
    unless a device is given, so a block adds no device launch)."""
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_lb_loss": z(), "moe_z_loss": z(), "moe_drop_fraction": z()}


def sum_aux(auxes: list) -> dict[str, torch.Tensor]:
    """The blocks' auxiliary values summed over the layers, in layer
    order (the reference's sum over its stacked scan outputs)."""
    return {k: torch.stack([a[k] for a in auxes]).sum() for k in auxes[0]}


def vocab_shard(embed: Embedding, head: Linear | None = None
                ) -> tuple | None:
    """(axis, first id) of the vocabulary slice a split head gives on this
    rank (the untied `head`'s columns, or the tied table's rows), or None
    when it gives all of it."""
    if head is None:
        return embed.vocab_shard()
    if head.split is None:
        return None
    return head.axis, head.axis.index * head.w.shape[1]


def whole_vocab(logits: torch.Tensor, shard: tuple | None) -> torch.Tensor:
    """Logits of every id: a vocabulary slice all-gathered over its axis
    (serving returns whole logits)."""
    return logits if shard is None else all_gather(logits, shard[0], -1)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def seq_sum(parts: list, seq: Axis) -> torch.Tensor:
    """This rank's slice of the sequence of the sum of a sequence-parallel
    block's branch outputs, each ``(tensor, partial)`` over the whole
    sequence: the parts of sums over the axis added and reduce-scattered
    once, the whole outputs cut to the slice."""
    partial = [y for y, is_part in parts if is_part]
    whole = [y for y, is_part in parts if not is_part]
    out = None
    if partial:
        out = reduce_scatter_seq(functools.reduce(torch.add, partial), seq)
    if whole:
        mine = split_chunk(functools.reduce(torch.add, whole), seq, 1)
        out = mine if out is None else out + mine
    return out


def slice_embedded(x: torch.Tensor, embed: Embedding,
                   seq: Axis) -> torch.Tensor:
    """This rank's slice of the sequence of tokens `embed` looked up with
    ``reduce=False``: a split table's parts reduce-scattered, a whole
    table's rows cut."""
    return (reduce_scatter_seq(x, seq) if embed.axis is not None
            else split_chunk(x, seq, 1))


def gather_block_input(h: torch.Tensor, seq: Axis, scope) -> torch.Tensor:
    """The whole sequence of this rank's slice `h` (`gather_seq`), saved
    as the slice where autograd keeps it outside a checkpointed region
    (`fsdp.keep_slice`)."""
    whole = gather_seq(h, seq)
    fsdp.keep_slice(scope, whole, h, seq, 1)
    return whole


class DecoderBlock(nn.Module):
    """Pre-norm transformer block; sequential or parallel (command-r)."""

    def __init__(self, cfg: ArchConfig, *, causal: bool = True,
                 rope: bool = True):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, out_bias=cfg.out_bias, rope=rope,
            rope_theta=cfg.rope_theta, causal=causal,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            skip_masked_chunks=cfg.skip_masked_chunks)
        if cfg.moe is not None:
            self.ffn = MoELayer(
                cfg.d_model, cfg.moe.expert_d_ff, cfg.moe.n_experts,
                cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                activation=cfg.activation, gated=cfg.gated_mlp,
                dense_residual_hidden=cfg.moe.dense_residual_ff or None)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, activation=cfg.activation,
                           gated=cfg.gated_mlp)
        self.norm1 = make_norm(cfg)
        self.norm2 = None if cfg.parallel_block else make_norm(cfg)

    def split_(self, axis: Axis) -> None:
        """Split attention and the FFN over the model axis, each where
        its count divides (`Attention.split_`, `MLP.split_`,
        `MoELayer.split_`)."""
        self.attn.split_(axis)
        self.ffn.split_(axis)

    def _ffn(self, h, reduce: bool = True):
        """The FFN's output and its auxiliary values (an MoE layer's
        load-balance loss, router z-loss and drop fraction; zeros on the
        host for a dense MLP).  ``reduce=False``: the output's part of a
        sum over the model axis where the FFN is split (`ffn_partial`)."""
        if isinstance(self.ffn, MoELayer):
            y, aux = self.ffn(h, reduce)
            return y, {"moe_lb_loss": aux.load_balance_loss,
                       "moe_z_loss": aux.router_z_loss,
                       "moe_drop_fraction": aux.drop_fraction}
        return self.ffn(h, reduce), zero_aux()

    def ffn_partial(self) -> bool:
        if isinstance(self.ffn, MoELayer):
            return self.ffn.partial()
        return self.ffn.axis is not None

    def _residual(self, x, h, attn_out):
        """x plus the attention and FFN branches, in parallel (both read
        h) or in sequence (the FFN reads the norm of x + attention)."""
        if self.cfg.parallel_block:
            ffn_out, aux = self._ffn(h)
            return x + attn_out + ffn_out, aux
        x = x + attn_out
        ffn_out, aux = self._ffn(self.norm2(x))
        return x + ffn_out, aux

    def forward(self, x: torch.Tensor, *, positions=None,
                seq: Axis | None = None):
        """``seq``: `x` is this rank's slice of a sequence cut over that
        axis, and so is the output (sequence parallelism, module
        docstring); positions are then the whole sequence's."""
        if seq is not None:
            return self._seq_forward(x, seq, positions)
        h = self.norm1(x)
        x, aux = self._residual(x, h, self.attn(h, positions=positions))
        return shard_activation(x, ("batch", "seq", None)), aux

    def _seq_forward(self, x, seq: Axis, positions):
        with fsdp.saving_slices() as scope:
            h = gather_block_input(self.norm1(x), seq, scope)
            branches = [(self.attn(h, positions=positions, reduce=False),
                         self.attn.axis is not None)]
            return self._seq_residual(x, h, branches, seq, scope)

    def _seq_residual(self, x, h, branches: list, seq: Axis, scope):
        """`_residual` on this rank's slice `x`, the attention branch
        given over the whole sequence `h` (`seq_sum`)."""
        if self.cfg.parallel_block:
            y, aux = self._ffn(h, reduce=False)
            x = x + seq_sum(branches + [(y, self.ffn_partial())], seq)
            return shard_activation(x, ("batch", "seq", None)), aux
        x = x + seq_sum(branches, seq)
        h2 = gather_block_input(self.norm2(x), seq, scope)
        y, aux = self._ffn(h2, reduce=False)
        x = x + seq_sum([(y, self.ffn_partial())], seq)
        return shard_activation(x, ("batch", "seq", None)), aux

    def _prefill_attention(self, h, positions, reduce: bool = True):
        """This layer's prefill attention over `h` (the whole sequence):
        the chunked or the einsum attention, never flash, as the
        reference's (`repro/nn/transformer.py:146-172`); (``wo``'s
        output, (k, v))."""
        b, s, _ = h.shape
        attn = self.attn
        q, k, v = attn._project(h, positions if positions is not None
                                else _positions(b, s, h.device), reduce)
        if s >= attn.chunk_threshold:
            out = chunked_gqa_attention(
                q, k, v, causal=True, q_chunk=attn.q_chunk,
                kv_chunk=attn.kv_chunk,
                skip_masked_chunks=attn.skip_masked_chunks)
        else:
            out = gqa_attention(q, k, v, causal_mask(s, s, 0, h.device))
        return attn.wo(out.reshape(b, s, -1), reduce), (k, v)

    def prefill(self, x: torch.Tensor, *, positions=None,
                seq: Axis | None = None):
        """Like forward, and also returns this layer's (k, v) over the
        whole sequence (this rank's kv heads where the attention is
        split)."""
        if seq is not None:
            with fsdp.saving_slices() as scope:
                h = gather_block_input(self.norm1(x), seq, scope)
                out, kv = self._prefill_attention(h, positions, reduce=False)
                x, aux = self._seq_residual(
                    x, h, [(out, self.attn.axis is not None)], seq, scope)
            return x, kv, aux
        h = self.norm1(x)
        out, kv = self._prefill_attention(h, positions)
        x, aux = self._residual(x, h, out)
        return x, kv, aux

    def decode(self, x: torch.Tensor, cache: KVCache, *, positions=None):
        h = self.norm1(x)
        attn_out, cache = self.attn.decode_step(h, cache,
                                                positions=positions)
        x, aux = self._residual(x, h, attn_out)
        return x, cache, aux


class LMOutput(NamedTuple):
    logits: torch.Tensor
    aux: dict[str, torch.Tensor]


class DecoderLM(nn.Module):
    """Token-in, logits-out decoder LM.  Also the backbone of
    phi-3-vision: `patch_embeds` (the stubbed CLIP output, [B, P,
    d_model]) are prepended to the token embeddings.  The auxiliary
    values are the blocks' summed over the layers: zeros on the model's
    device for dense blocks, the MoE layers' otherwise."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(DecoderBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = make_norm(cfg)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size,
                                  use_bias=False,
                                  kernel_axes=("embed", "vocab"))
        # the axis the last `backbone`'s sequence was cut over (its output
        # is then normed already), read by `apply_head`
        self.head_seq: Axis | None = None

    def split_(self, axis: Axis) -> None:
        """Tensor parallelism over `axis` (the mesh's "model" axis): every
        block, the embedding table by vocabulary rows and the untied head
        by vocabulary columns, each part where the axis divides its
        count.  The parameters become this rank's slices in place (read
        ``named_parameters()`` again after)."""
        for block in self.blocks:
            block.split_(axis)
        self.embed.split_(axis)
        if self.lm_head is not None and splits(self.cfg.vocab_size, axis):
            self.lm_head.split_("column", axis)

    def vocab_shard(self) -> tuple | None:
        """(axis, first id) of the vocabulary slice `apply_head` gives on
        this rank, or None when it gives all of it."""
        return vocab_shard(self.embed, self.lm_head)

    # ---- shared pieces -----------------------------------------------------

    def _seq_len(self, tokens, patch_embeds=None) -> int:
        """Positions of the residual stream for `tokens` (the patches
        first, where given)."""
        extra = (patch_embeds.shape[1] if self.cfg.num_patches
                 and patch_embeds is not None else 0)
        return tokens.shape[1] + extra

    def _embed_inputs(self, tokens, patch_embeds=None,
                      seq: Axis | None = None):
        """The residual stream's input; with `seq`, this rank's slice of
        its sequence (a split table's parts reduce-scattered)."""
        dtype = torch_dtype(self.cfg.compute_dtype)
        with fsdp.gathered(self.embed):
            x = self.embed(tokens, dtype=dtype, reduce=seq is None)
        split = seq is not None and self.embed.axis is not None
        if self.cfg.num_patches and patch_embeds is not None:
            # vlm: the patches go first; decode has none (they were
            # consumed at prefill and live in the KV cache)
            patches = patch_embeds.to(dtype)
            if split:  # counted once in the sum over the axis
                patches = collectives.first_only(patches, seq)
            x = torch.cat([patches, x], dim=1)
        if seq is not None:
            x = slice_embedded(x, self.embed, seq)
        return shard_activation(x, ("batch", "seq", None))

    def _logits(self, x, whole: bool = False, seq: Axis | None = None):
        """fp32 logits of this rank's vocabulary slice; with `whole`, the
        slices all-gathered over the model axis (serving).  `seq`: `x` is
        a sequence gathered over that axis and normed already
        (`backbone`), each rank's gradient of it a part of a sum over
        the axis: a split head reads it as it is, and a whole head, which
        every rank computes alike, carries 1/M of its gradient."""
        head = self.lm_head if self.lm_head is not None else self.embed
        with fsdp.gathered(self.final_norm, head):
            if seq is None:
                x = self.final_norm(x)
            if self.lm_head is not None:
                h = x if seq is not None else copy_to(x, self.lm_head.axis)
                logits = self.lm_head(h)
            else:
                logits = self.embed.attend(x, reduce=seq is None)
        if seq is not None and self.vocab_shard() is None:
            logits = grad_share(logits, seq)
        logits = shard_activation(logits, ("batch", None, "vocab"))
        if whole:
            logits = whole_vocab(logits, self.vocab_shard())
        return logits.to(torch.float32)

    # ---- full sequence -----------------------------------------------------

    def backbone(self, tokens, *, patch_embeds=None):
        """Full-sequence forward up to the head: ([B, S, d], aux).  Under
        sequence parallelism the blocks run on this rank's slice, and the
        final norm too; the normed sequence is gathered for the head
        (``head_seq`` says so to `apply_head`)."""
        seq = seq_axis(self._seq_len(tokens, patch_embeds))
        x = self._embed_inputs(tokens, patch_embeds, seq)
        auxes = []
        for block in self.blocks:
            x, aux = maybe_remat(block, self.cfg)(x, seq=seq)
            auxes.append(aux)
        if seq is not None:
            with fsdp.gathered(self.final_norm):
                x = gather_seq(self.final_norm(x), seq)
        self.head_seq = seq
        if self.cfg.num_patches:
            x = x[:, self.cfg.num_patches:]
        return x, self._aux(auxes, x.device)

    def _aux(self, auxes: list, device) -> dict[str, torch.Tensor]:
        if self.cfg.moe is None:
            return zero_aux(device)
        return sum_aux(auxes)

    def apply_head(self, x):
        """Final norm and fp32 logits for a slice of positions of the
        last `backbone`'s output (normed already under sequence
        parallelism)."""
        return self._logits(x, seq=self.head_seq)

    def forward(self, tokens, *, patch_embeds=None) -> LMOutput:
        x, aux = self.backbone(tokens, patch_embeds=patch_embeds)
        return LMOutput(self._logits(x, whole=True, seq=self.head_seq), aux)

    # ---- prefill -----------------------------------------------------------

    def prefill(self, tokens, max_len: int | None = None, *,
                patch_embeds=None) -> tuple[LMOutput, KVCache]:
        """Logits of the last position and the stacked cache, padded with
        zeros to `max_len` (never cut below the prompt)."""
        s = self._seq_len(tokens, patch_embeds)
        seq = seq_axis(s)
        x = self._embed_inputs(tokens, patch_embeds, seq)
        cache = self.init_cache(x.shape[0], max(max_len or s, s))
        attn = self.blocks[0].attn
        auxes = []
        for layer, block in enumerate(self.blocks):
            with fsdp.gathered(block):
                x, (k, v), aux = block.prefill(x, seq=seq)
            if cache.seq is not None:  # every kv head of its positions
                k, v = attn.all_heads(k, v)
            write_positions(cache.k[layer], k, 0, cache.seq)
            write_positions(cache.v[layer], v, 0, cache.seq)
            auxes.append(aux)
        cache.length = s
        last = x[:, -1:]
        if seq is not None:  # the last position is the last rank's
            last = all_gather(last, seq, 1)[:, -1:]
        return (LMOutput(self._logits(last, whole=True),
                         self._aux(auxes, x.device)), cache)

    def kv_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.kv_cache_dtype or self.cfg.compute_dtype)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """Zeros for every layer, by this rank's kv heads (all of them
        unless `split_` cut the attention); under sequence parallelism
        (`sharding.seq_axis` of `max_len`) every kv head of this rank's
        positions."""
        cfg = self.cfg
        seq = seq_axis(max_len)
        n_kv = cfg.n_kv_heads if seq is not None else self.blocks[0].attn.n_kv
        return KVCache.zeros(batch, max_len, n_kv, cfg.resolved_head_dim,
                             dtype=self.kv_dtype(), layers=cfg.num_layers,
                             device=self.embed.table.device, seq=seq)

    def cache_axes(self) -> KVCache:
        """The cache's logical axes (the reference's `cache_axes`)."""
        kv = ("layers", "batch", "seq", "kv_heads", None)
        return KVCache(kv, kv, ())

    # ---- decode ------------------------------------------------------------

    def decode_step(self, tokens, cache: KVCache
                    ) -> tuple[LMOutput, KVCache]:
        """tokens [B, S_new] (usually S_new == 1).  Writes the new K/V
        into `cache`'s tensors in place and returns the cache S_new
        longer."""
        x = self._embed_inputs(tokens)
        auxes = []
        for layer, block in enumerate(self.blocks):
            with fsdp.gathered(block):
                x, _, aux = block.decode(x, cache.layer(layer))
            auxes.append(aux)
        new_cache = cut_by(KVCache(cache.k, cache.v,
                                   cache.length + tokens.shape[1]),
                           seq=cache.seq)
        return (LMOutput(self._logits(x, whole=True),
                         self._aux(auxes, x.device)), new_cache)
