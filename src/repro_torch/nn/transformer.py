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
attention by whole heads, the MLP by its hidden width, the MoE experts,
the embedding table and the head by vocabulary.  A part whose count the
axis does not divide stays whole on every rank.  The head then gives
this rank's logits (`vocab_shard`), and the loss reduces over the axis
without gathering them (`repro_torch.train.train_loop`).  A split model
also serves: `prefill` and `init_cache` size the KV cache by the rank's
kv heads (a whole layer's count where attention stayed whole), and
`forward`, `prefill` and `decode_step` all-gather the vocabulary slices
over the axis, so they return whole logits.  The cache is cut by heads,
never by sequence.

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
from repro_torch.distributed.collectives import Axis, all_gather, copy_to
from repro_torch.distributed.sharding import shard_activation
from repro_torch.nn.attention import (Attention, KVCache, causal_mask,
                                      chunked_gqa_attention, gqa_attention,
                                      to_kv_dtype)
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


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


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

    def _ffn(self, h):
        """The FFN's output and its auxiliary values (an MoE layer's
        load-balance loss, router z-loss and drop fraction; zeros on the
        host for a dense MLP)."""
        if isinstance(self.ffn, MoELayer):
            y, aux = self.ffn(h)
            return y, {"moe_lb_loss": aux.load_balance_loss,
                       "moe_z_loss": aux.router_z_loss,
                       "moe_drop_fraction": aux.drop_fraction}
        return self.ffn(h), zero_aux()

    def _residual(self, x, h, attn_out):
        """x plus the attention and FFN branches, in parallel (both read
        h) or in sequence (the FFN reads the norm of x + attention)."""
        if self.cfg.parallel_block:
            ffn_out, aux = self._ffn(h)
            return x + attn_out + ffn_out, aux
        x = x + attn_out
        ffn_out, aux = self._ffn(self.norm2(x))
        return x + ffn_out, aux

    def forward(self, x: torch.Tensor, *, positions=None):
        h = self.norm1(x)
        x, aux = self._residual(x, h, self.attn(h, positions=positions))
        return shard_activation(x, ("batch", "seq", None)), aux

    def prefill(self, x: torch.Tensor, *, positions=None):
        """Like forward, and also returns this layer's (k, v).  Calls the
        chunked or the einsum attention directly, never flash, as the
        reference's does (`repro/nn/transformer.py:146-172`)."""
        h = self.norm1(x)
        b, s, _ = h.shape
        attn = self.attn
        q, k, v = attn._project(h, positions if positions is not None
                                else _positions(b, s, h.device))
        if s >= attn.chunk_threshold:
            out = chunked_gqa_attention(
                q, k, v, causal=True, q_chunk=attn.q_chunk,
                kv_chunk=attn.kv_chunk,
                skip_masked_chunks=attn.skip_masked_chunks)
        else:
            out = gqa_attention(q, k, v, causal_mask(s, s, 0, h.device))
        x, aux = self._residual(x, h, attn.wo(out.reshape(b, s, -1)))
        return x, (k, v), aux

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
        if self.lm_head is None:
            return self.embed.vocab_shard()
        if self.lm_head.split is None:
            return None
        return self.lm_head.axis, (self.lm_head.axis.index
                                   * self.lm_head.w.shape[1])

    # ---- shared pieces -----------------------------------------------------

    def _embed_inputs(self, tokens, patch_embeds=None):
        dtype = torch_dtype(self.cfg.compute_dtype)
        with fsdp.gathered(self.embed):
            x = self.embed(tokens, dtype=dtype)
        if self.cfg.num_patches and patch_embeds is not None:
            # vlm: the patches go first; decode has none (they were
            # consumed at prefill and live in the KV cache)
            x = torch.cat([patch_embeds.to(dtype), x], dim=1)
        return shard_activation(x, ("batch", "seq", None))

    def _logits(self, x, whole: bool = False):
        """fp32 logits of this rank's vocabulary slice; with `whole`, the
        slices all-gathered over the model axis (serving)."""
        head = self.lm_head if self.lm_head is not None else self.embed
        with fsdp.gathered(self.final_norm, head):
            x = self.final_norm(x)
            if self.lm_head is not None:
                logits = self.lm_head(copy_to(x, self.lm_head.axis))
            else:
                logits = self.embed.attend(x)
        logits = shard_activation(logits, ("batch", None, "vocab"))
        shard = self.vocab_shard() if whole else None
        if shard is not None:
            logits = all_gather(logits, shard[0], -1)
        return logits.to(torch.float32)

    # ---- full sequence -----------------------------------------------------

    def backbone(self, tokens, *, patch_embeds=None):
        """Full-sequence forward up to the head: ([B, S, d], aux)."""
        x = self._embed_inputs(tokens, patch_embeds)
        auxes = []
        for block in self.blocks:
            x, aux = maybe_remat(block, self.cfg)(x)
            auxes.append(aux)
        if self.cfg.num_patches:
            x = x[:, self.cfg.num_patches:]
        return x, self._aux(auxes, x.device)

    def _aux(self, auxes: list, device) -> dict[str, torch.Tensor]:
        if self.cfg.moe is None:
            return zero_aux(device)
        return sum_aux(auxes)

    def apply_head(self, x):
        """Final norm and fp32 logits for a slice of positions."""
        return self._logits(x)

    def forward(self, tokens, *, patch_embeds=None) -> LMOutput:
        x, aux = self.backbone(tokens, patch_embeds=patch_embeds)
        return LMOutput(self._logits(x, whole=True), aux)

    # ---- prefill -----------------------------------------------------------

    def prefill(self, tokens, max_len: int | None = None, *,
                patch_embeds=None) -> tuple[LMOutput, KVCache]:
        """Logits of the last position and the stacked cache, padded with
        zeros to `max_len` (never cut below the prompt)."""
        x = self._embed_inputs(tokens, patch_embeds)
        b, s, _ = x.shape
        cache = self.init_cache(b, max(max_len or s, s))
        dtype = cache.k.dtype
        cfg = self.cfg
        auxes = []
        for layer, block in enumerate(self.blocks):
            with fsdp.gathered(block):
                x, (k, v), aux = block.prefill(x)
            cache.k[layer, :, :s] = to_kv_dtype(k, dtype)
            cache.v[layer, :, :s] = to_kv_dtype(v, dtype)
            auxes.append(aux)
        cache.length = s
        if cfg.num_patches:
            x = x[:, cfg.num_patches:]
        return (LMOutput(self._logits(x[:, -1:], whole=True),
                         self._aux(auxes, x.device)), cache)

    def kv_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.kv_cache_dtype or self.cfg.compute_dtype)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """Zeros for every layer, by this rank's kv heads (all of them
        unless `split_` cut the attention)."""
        cfg = self.cfg
        return KVCache.zeros(batch, max_len, self.blocks[0].attn.n_kv,
                             cfg.resolved_head_dim, dtype=self.kv_dtype(),
                             layers=cfg.num_layers,
                             device=self.embed.table.device)

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
                x, _, aux = block.decode(
                    x, KVCache(cache.k[layer], cache.v[layer],
                               cache.length))
            auxes.append(aux)
        new_cache = KVCache(cache.k, cache.v,
                            cache.length + tokens.shape[1])
        return (LMOutput(self._logits(x, whole=True),
                         self._aux(auxes, x.device)), new_cache)
