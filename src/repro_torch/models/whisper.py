"""Whisper-style encoder-decoder (counterpart of `repro.models.whisper`).

The convolutional mel front end is a stub, as in the reference: the
encoder takes frame embeddings ``[B, T_frames, d_model]``.  The encoder
(self-attention, sinusoidal positions) and the decoder (causal
self-attention, cross-attention, sinusoidal positions at the decoded
offset) are complete.  Serving goes through the model's own `prefill`
(which takes ``audio_embeds=``, encodes them once and keeps every
decoder layer's cross K/V in the cache with their valid length) and
`decode_step`; `ServeEngine` passes no audio and raises at the encoder,
as the reference's does.

The encoder and decoder stacks are `nn.ModuleList`s named ``encoder``
and ``decoder`` (the reference's stacked trees, split by
`layers.load_jax_lm_params`); their layers run under `maybe_remat`, as
the reference's scan bodies (the cross K/V projections do not).

On a mesh `split_` splits the encoder's and the decoder's attention and
MLPs over the "model" axis (`Attention.split_`, `MLP.split_`, each where
the axis divides its count) and the tied embedding table by vocabulary:
the head gives this rank's logits (`vocab_shard`), serving all-gathers
them, and the caches hold this rank's kv heads.

Under the ``"seq": "model"`` rule (`sharding.seq_axis`) the model is
sequence parallel in training and prefill, as `DecoderLM` is: the
encoder's residual is this rank's slice of the frames (the sinusoidal
positions added to the whole frames first), the decoder's its slice of
the tokens (the positions the whole sequence's rows, cut with it); each
block norms its slice, gathers the normed sequence for each branch
(inside its checkpointed region) and keeps the slice of the branch's
output (a split layer's parts reduce-scattered along the sequence).
The encoder's final norm runs on the slice, and the normed frames are
gathered once for every decoder layer's cross K/V, so the
cross-attention attends over all frames with this rank's heads.  The
decoder's final norm runs on the slice and the normed sequence is
gathered for the head (``head_seq``).  With autograd recording the
rule cuts both sequences or neither: where the axis divides only one
of them, the other's whole computation would sit in a region whose
gradients are parts of a sum (the train cells' decoder is the frames'
quarter, so the two divide together there); a prefill cuts each where
the axis divides it.  The caches are cut by sequence too: the
decoder's self-attention cache over its positions and the cross cache
over the encoder's frames, each where the axis divides its length
(`WhisperCache.seq` / ``enc_seq``), and decode merges the softmax over
the axis (`attention.merged_gqa_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed.collectives import (Axis, all_gather,
                                                 gather_seq, grad_share,
                                                 split_chunk)
from repro_torch.distributed.sharding import seq_axis, shard_activation
from repro_torch.nn.attention import (Attention, KVCache, causal_mask,
                                      cut_by, gqa_attention,
                                      sinusoidal_positions, write_positions)
from repro_torch.nn.layers import MLP, Embedding, LayerNorm
from repro_torch.nn.transformer import (LMOutput, gather_block_input,
                                        maybe_remat, seq_sum, slice_embedded,
                                        torch_dtype, whole_vocab, zero_aux)

# the decoder's position table: the reference slices rows of an
# 8192-row sinusoidal table, its start clamped into the table
DECODER_POSITIONS = 8192


@dataclasses.dataclass
class WhisperCache:
    dec_k: torch.Tensor  # [L, B, S_dec, K, D] decoder self-attention
    dec_v: torch.Tensor
    enc_k: torch.Tensor  # [L, B, T_enc, K, D] cross-attention K/V
    enc_v: torch.Tensor
    enc_valid: int
    length: int
    # dec_k / dec_v cut by sequence, enc_k / enc_v by frames, over these
    # axes (`attention.cut_by`)
    seq: ClassVar[Axis | None] = None
    enc_seq: ClassVar[Axis | None] = None


def decoder_positions(start: int, s: int, dim: int,
                      device=None) -> torch.Tensor:
    """Rows ``[start, start + s)`` of the reference's 8192-row
    `sinusoidal_positions` table, the start clamped into the table as
    ``dynamic_slice_in_dim`` clamps it."""
    start = min(max(int(start), 0), DECODER_POSITIONS - s)
    return sinusoidal_positions(DECODER_POSITIONS, dim,
                                device)[start:start + s]


def _attention(cfg: ArchConfig, causal: bool) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     qkv_bias=True, out_bias=True, rope=False, causal=causal,
                     q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def _mlp(cfg: ArchConfig) -> MLP:
    return MLP(cfg.d_model, cfg.d_ff, activation="gelu", gated=False,
               use_bias=True)


def _seq_branch(layer, norm, x, seq: Axis, scope, **kwargs):
    """This rank's slice of the sequence of `layer` (an attention or an
    MLP) over the whole normed sequence of the slice `x`: the normed
    slice gathered (`gather_block_input`), a split layer's parts
    reduce-scattered, a whole layer's output cut (`seq_sum`)."""
    h = gather_block_input(norm(x), seq, scope)
    return seq_sum([(layer(h, reduce=False, **kwargs),
                     layer.axis is not None)], seq)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.attn = _attention(cfg, causal=False)
        self.mlp = _mlp(cfg)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)

    def forward(self, x, seq: Axis | None = None):
        """``seq``: `x` is this rank's slice of the frames, and so is the
        output (module docstring)."""
        if seq is not None:
            with fsdp.saving_slices() as scope:
                x = x + _seq_branch(self.attn, self.ln1, x, seq, scope)
                x = x + _seq_branch(self.mlp, self.ln2, x, seq, scope)
            return shard_activation(x, ("batch", "seq", None))
        x = x + self.attn(self.ln1(x))
        return shard_activation(x + self.mlp(self.ln2(x)),
                                ("batch", "seq", None))


class DecoderBlockXAttn(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.self_attn = _attention(cfg, causal=True)
        self.cross_attn = _attention(cfg, causal=False)
        self.mlp = _mlp(cfg)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)
        self.ln3 = LayerNorm(cfg.d_model)

    def forward(self, x, enc_kv, seq: Axis | None = None):
        """``seq``: `x` is this rank's slice of the tokens, and so is the
        output; `enc_kv` are over all frames (module docstring)."""
        if seq is not None:
            with fsdp.saving_slices() as scope:
                x = x + _seq_branch(self.self_attn, self.ln1, x, seq, scope)
                x = x + _seq_branch(self.cross_attn, self.ln2, x, seq, scope,
                                    kv=enc_kv)
                x = x + _seq_branch(self.mlp, self.ln3, x, seq, scope)
            return shard_activation(x, ("batch", "seq", None))
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), kv=enc_kv)
        return shard_activation(x + self.mlp(self.ln3(x)),
                                ("batch", "seq", None))

    def _prefill_self(self, h, reduce: bool = True):
        """The self-attention of the prefill over the whole sequence `h`:
        (``wo``'s output, (k, v))."""
        b, s, _ = h.shape
        pos = torch.arange(s, device=h.device)[None].expand(b, s)
        q, k, v = self.self_attn._project(h, pos, reduce)
        out = gqa_attention(q, k, v, causal_mask(s, s, 0, h.device))
        return self.self_attn.wo(out.reshape(b, s, -1), reduce), (k, v)

    def prefill(self, x, enc_kv, seq: Axis | None = None):
        """Like forward, with the self-attention always the einsum form
        under a causal mask (the reference's prefill body,
        `repro/models/whisper.py:217-233`); also returns its (k, v) over
        the whole sequence (`seq`: `x` this rank's slice of it)."""
        if seq is not None:
            with fsdp.saving_slices() as scope:
                h = gather_block_input(self.ln1(x), seq, scope)
                y, kv = self._prefill_self(h, reduce=False)
                del h
                x = x + seq_sum([(y, self.self_attn.axis is not None)], seq)
                x = x + _seq_branch(self.cross_attn, self.ln2, x, seq, scope,
                                    kv=enc_kv)
                x = x + _seq_branch(self.mlp, self.ln3, x, seq, scope)
            return x, kv
        y, kv = self._prefill_self(self.ln1(x))
        x = x + y
        x = x + self.cross_attn(self.ln2(x), kv=enc_kv)
        return x + self.mlp(self.ln3(x)), kv

    def decode(self, x, cache: KVCache, enc_k, enc_v, enc_valid,
               enc_seq: Axis | None = None):
        y, cache = self.self_attn.decode_step(self.ln1(x), cache)
        x = x + y
        x = x + self.cross_attn.cross_decode_step(self.ln2(x), enc_k, enc_v,
                                                  kv_valid=enc_valid,
                                                  seq=enc_seq)
        return x + self.mlp(self.ln3(x)), cache


class WhisperModel(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.enc_layers = cfg.enc_layers or cfg.num_layers
        self.dec_layers = cfg.dec_layers or cfg.num_layers
        self.embed = Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = nn.ModuleList(EncoderBlock(cfg)
                                     for _ in range(self.enc_layers))
        self.decoder = nn.ModuleList(DecoderBlockXAttn(cfg)
                                     for _ in range(self.dec_layers))
        self.ln_enc = LayerNorm(cfg.d_model)
        self.ln_dec = LayerNorm(cfg.d_model)
        # the axis the last `backbone`'s decoder sequence was cut over
        # (its output is then normed already), read by `apply_head`
        self.head_seq: Axis | None = None

    def split_(self, axis: Axis) -> None:
        """Tensor parallelism over `axis` (module docstring); the
        parameters become this rank's slices in place."""
        for block in self.encoder:
            block.attn.split_(axis)
            block.mlp.split_(axis)
        for block in self.decoder:
            block.self_attn.split_(axis)
            block.cross_attn.split_(axis)
            block.mlp.split_(axis)
        self.embed.split_(axis)

    def vocab_shard(self) -> tuple | None:
        """(axis, first id) of this rank's logits, or None when whole."""
        return self.embed.vocab_shard()

    # ---- encoder -----------------------------------------------------------

    @staticmethod
    def seq_axes(frames: int, tokens: int) -> tuple:
        """(frames' axis, tokens' axis) the ``"seq"`` rule cuts, each
        `sharding.seq_axis` of its length; with autograd recording both
        or neither (module docstring)."""
        enc_seq, seq = seq_axis(frames), seq_axis(tokens)
        if torch.is_grad_enabled() and (enc_seq is None) != (seq is None):
            return None, None
        return enc_seq, seq

    def encode(self, audio_embeds, seq: Axis | None = None):
        """audio_embeds [B, T, d_model] (the stubbed front end's output);
        with `seq`, the normed output is this rank's slice of the
        frames."""
        b, t, d = audio_embeds.shape
        x = audio_embeds + sinusoidal_positions(
            t, d, audio_embeds.device).to(audio_embeds.dtype)[None]
        if seq is not None:
            x = split_chunk(x, seq, 1)
        x = shard_activation(x, ("batch", "seq", None))
        for block in self.encoder:
            x = maybe_remat(block, self.cfg)(x, seq=seq)
        with fsdp.gathered(self.ln_enc):
            return self.ln_enc(x)

    def _cross_kvs(self, enc_out, seq: Axis | None = None) -> list:
        """Every decoder layer's cross-attention (k, v) of the encoder
        output, over all frames (`seq`: `enc_out` is this rank's slice
        of them, gathered once for every layer)."""
        if seq is None:
            return [fsdp.gathering(block.cross_attn.cross_kv,
                                   block.cross_attn)(enc_out)
                    for block in self.decoder]
        with fsdp.saving_slices() as scope:
            whole = gather_block_input(enc_out, seq, scope)
            return [fsdp.gathering(block.cross_attn.cross_kv,
                                   block.cross_attn)(whole, reduce=False)
                    for block in self.decoder]

    def _decoder_embed(self, tokens, offset: int = 0,
                       seq: Axis | None = None):
        """The embedded tokens at their positions; with `seq`, this
        rank's slice of them (a split table's parts reduce-scattered)."""
        dtype = torch_dtype(self.cfg.compute_dtype)
        with fsdp.gathered(self.embed):
            x = self.embed(tokens, dtype=dtype, reduce=seq is None)
        pos = decoder_positions(offset, tokens.shape[1], self.cfg.d_model,
                                tokens.device)
        if seq is not None:
            x = slice_embedded(x, self.embed, seq)
            pos = split_chunk(pos, seq, 0)
        return x + pos.to(dtype)[None]

    def _logits(self, x, whole: bool = False, seq: Axis | None = None):
        """fp32 logits of this rank's vocabulary slice; with `whole`, all
        of them (serving).  `seq`: `x` is normed and gathered over that
        axis (`backbone`): a split table reads it as it is, and a whole
        one, which every rank computes alike, carries 1/M of its
        gradient."""
        with fsdp.gathered(self.ln_dec, self.embed):
            if seq is None:
                x = self.ln_dec(x)
            logits = self.embed.attend(x, reduce=seq is None)
        if seq is not None and self.vocab_shard() is None:
            logits = grad_share(logits, seq)
        if whole:
            logits = whole_vocab(logits, self.vocab_shard())
        return logits.to(torch.float32)

    # ---- teacher forcing -----------------------------------------------------

    def backbone(self, tokens, *, audio_embeds=None, **_):
        """([B, S, d], aux); under sequence parallelism the decoder's
        final norm runs on this rank's slice and the normed sequence is
        gathered (``head_seq`` says so to `apply_head`)."""
        enc_seq, seq = self.seq_axes(audio_embeds.shape[1], tokens.shape[1])
        kvs = self._cross_kvs(self.encode(audio_embeds, enc_seq), enc_seq)
        x = self._decoder_embed(tokens, seq=seq)
        for block, kv in zip(self.decoder, kvs):
            x = maybe_remat(block, self.cfg)(x, kv, seq=seq)
        if seq is not None:
            with fsdp.gathered(self.ln_dec):
                x = gather_seq(self.ln_dec(x), seq)
        self.head_seq = seq
        return x, zero_aux(x.device)

    def apply_head(self, x):
        return self._logits(x, seq=self.head_seq)

    def forward(self, tokens, *, audio_embeds=None, **_) -> LMOutput:
        x, aux = self.backbone(tokens, audio_embeds=audio_embeds)
        return LMOutput(self._logits(x, whole=True, seq=self.head_seq), aux)

    # ---- serving -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   enc_len: int = 0) -> WhisperCache:
        """Zeros: `max_len` decoder positions and `enc_len` frames, each
        this rank's of them and every kv head where the ``"seq"`` rule
        cuts it, else all of them and this rank's kv heads."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        dev = self.embed.table.device
        l, hd = self.dec_layers, cfg.resolved_head_dim
        seq = seq_axis(max_len)
        enc_seq = seq_axis(enc_len) if enc_len else None
        block = self.decoder[0]

        def zeros(n, cut, attn):
            n = n // cut.size if cut is not None else n
            kh = cfg.n_kv_heads if cut is not None else attn.n_kv
            return torch.zeros((l, batch, n, kh, hd), dtype=dtype,
                               device=dev)
        dec = (max_len, seq, block.self_attn)
        enc = (max(enc_len, 1), enc_seq, block.cross_attn)
        return cut_by(WhisperCache(zeros(*dec), zeros(*dec), zeros(*enc),
                                   zeros(*enc), 0, 0),
                      seq=seq, enc_seq=enc_seq)

    def cache_axes(self) -> WhisperCache:
        """The cache's logical axes (the reference's `cache_axes`)."""
        kv = ("layers", "batch", "seq", "kv_heads", None)
        return WhisperCache(kv, kv, kv, kv, (), ())

    def prefill(self, tokens, max_len: int | None = None, *,
                audio_embeds=None, **_):
        """Encode the audio once, run the decoder prompt, and keep each
        decoder layer's self-attention K/V (padded with zeros to
        `max_len`, never cut below the prompt) and cross K/V, all in the
        compute dtype."""
        b, s = tokens.shape
        frames = audio_embeds.shape[1]
        enc_seq, seq = self.seq_axes(frames, s)
        kvs = self._cross_kvs(self.encode(audio_embeds, enc_seq), enc_seq)
        x = self._decoder_embed(tokens, seq=seq)
        cache = self.init_cache(b, max(max_len or s, s), frames)
        dtype = cache.dec_k.dtype
        for layer, (block, kv) in enumerate(zip(self.decoder, kvs)):
            with fsdp.gathered(block):
                x, (k, v) = block.prefill(x, kv, seq=seq)
            if cache.seq is not None:  # every kv head of its positions
                k, v = block.self_attn.all_heads(k, v)
            write_positions(cache.dec_k[layer], k, 0, cache.seq)
            write_positions(cache.dec_v[layer], v, 0, cache.seq)
            if cache.enc_seq is not None:  # every kv head of its frames
                kv = tuple(split_chunk(t, cache.enc_seq, 1)
                           for t in block.cross_attn.all_heads(*kv))
            cache.enc_k[layer] = kv[0].to(dtype)
            cache.enc_v[layer] = kv[1].to(dtype)
        cache.enc_valid, cache.length = frames, s
        last = x[:, -1:]
        if seq is not None:  # the last position is the last rank's
            last = all_gather(last, seq, 1)[:, -1:]
        return (LMOutput(self._logits(last, whole=True),
                         zero_aux(x.device)), cache)

    def decode_step(self, tokens, cache: WhisperCache):
        """Writes the new self-attention K/V into `cache`'s tensors in
        place and returns the cache one token longer."""
        x = self._decoder_embed(tokens, offset=cache.length)
        for layer, block in enumerate(self.decoder):
            with fsdp.gathered(block):
                x, _ = block.decode(
                    x, cut_by(KVCache(cache.dec_k[layer], cache.dec_v[layer],
                                      cache.length), seq=cache.seq),
                    cache.enc_k[layer], cache.enc_v[layer],
                    cache.enc_valid, cache.enc_seq)
        return (LMOutput(self._logits(x, whole=True), zero_aux(x.device)),
                cut_by(dataclasses.replace(
                    cache, length=cache.length + tokens.shape[1]),
                    seq=cache.seq, enc_seq=cache.enc_seq))
