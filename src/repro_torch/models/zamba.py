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
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import shard_activation
from repro_torch.nn.attention import KVCache
from repro_torch.nn.layers import Embedding, RMSNorm
from repro_torch.nn.ssm import Mamba2, Mamba2State
from repro_torch.nn.transformer import (DecoderBlock, LMOutput,
                                        maybe_remat, sum_aux, torch_dtype)


@dataclasses.dataclass
class ZambaCache:
    ssm: torch.Tensor   # [L, B, H, P, N]
    conv: torch.Tensor  # [L, B, K-1, conv_dim]
    k: torch.Tensor     # [G, B, S, Kh, Dh]: one cache an application
    v: torch.Tensor
    length: int


class MambaResidualBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model)
        self.mamba = Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand)

    def forward(self, x, state: Mamba2State):
        y, state = self.mamba(self.norm(x), state)
        return x + y, state

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

    def group_sizes(self) -> list[int]:
        l, g = self.cfg.num_layers, self.n_groups
        base = l // g
        rem = l - base * g
        return [base + (1 if i < rem else 0) for i in range(g)]

    def init_cache(self, batch: int, max_len: int) -> ZambaCache:
        cfg = self.cfg
        m = self.mamba[0].mamba
        dev = self.embed.table.device
        f32 = torch.float32
        kv = (self.n_groups, batch, max_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        dtype = torch_dtype(cfg.compute_dtype)
        return ZambaCache(
            ssm=torch.zeros((cfg.num_layers, batch, m.n_heads, m.head_dim,
                             m.d_state), dtype=f32, device=dev),
            conv=torch.zeros((cfg.num_layers, batch, m.conv_kernel - 1,
                              m.conv_dim), dtype=f32, device=dev),
            k=torch.zeros(kv, dtype=dtype, device=dev),
            v=torch.zeros(kv, dtype=dtype, device=dev), length=0)

    def cache_axes(self) -> ZambaCache:
        """The cache's logical axes (the reference's `cache_axes`)."""
        kv = (None, "batch", "seq", "kv_heads", None)
        return ZambaCache(("layers", "batch", "heads", None, None),
                          ("layers", "batch", None, "mlp"), kv, kv, ())

    def _logits(self, x):
        with fsdp.gathered(self.final_norm, self.embed):
            x = self.final_norm(x)
            return self.embed.attend(x).to(torch.float32)

    def _run_groups(self, x, cache: ZambaCache, mode: str):
        """mode: "train", "prefill" or "decode".  Returns (x, the new
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
                    x, state = maybe_remat(block, self.cfg)(x, state)
                else:
                    with fsdp.gathered(block):
                        x, state = block(x, state)
                ssm.append(state.ssm)
                conv.append(state.conv)
                layer += 1
            # shared attention block, application g (gathered for each)
            with fsdp.gathered(self.shared):
                if mode == "train":
                    x, aux = self.shared(x)
                elif mode == "prefill":
                    x, kv, aux = self.shared.prefill(x)
                    kvs.append(kv)
                else:
                    x, _, aux = self.shared.decode(
                        x, KVCache(cache.k[g], cache.v[g], cache.length))
            auxes.append(aux)
        return (x, torch.stack(ssm), torch.stack(conv), kvs,
                sum_aux(auxes))

    def _embed(self, tokens):
        with fsdp.gathered(self.embed):
            return self.embed(tokens,
                              dtype=torch_dtype(self.cfg.compute_dtype))

    def backbone(self, tokens, **_):
        cache = self.init_cache(tokens.shape[0], max_len=0)
        x = shard_activation(self._embed(tokens), ("batch", "seq", None))
        x, _, _, _, aux = self._run_groups(x, cache, "train")
        return x, aux

    def apply_head(self, x):
        return self._logits(x)

    def forward(self, tokens, **_) -> LMOutput:
        x, aux = self.backbone(tokens)
        return LMOutput(self.apply_head(x), aux)

    def prefill(self, tokens, max_len: int | None = None, **_):
        """Logits of the last position and the cache: the states after
        the prompt and each application's K/V, cast to the compute dtype
        and padded with zeros to `max_len` (never cut below the
        prompt)."""
        b, s = tokens.shape
        x, ssm, conv, kvs, aux = self._run_groups(
            self._embed(tokens), self.init_cache(b, max_len=0), "prefill")
        cache = self.init_cache(b, max(max_len or s, s))
        for g, (k, v) in enumerate(kvs):
            cache.k[g, :, :s] = k.to(cache.k.dtype)
            cache.v[g, :, :s] = v.to(cache.v.dtype)
        cache.ssm, cache.conv, cache.length = ssm, conv, s
        return LMOutput(self._logits(x[:, -1:]), aux), cache

    def decode_step(self, tokens, cache: ZambaCache):
        """Writes the new K/V into `cache`'s tensors in place and returns
        the cache with the new states, one token longer."""
        x, ssm, conv, _, aux = self._run_groups(self._embed(tokens), cache,
                                                "decode")
        return (LMOutput(self._logits(x), aux),
                ZambaCache(ssm, conv, cache.k, cache.v,
                           cache.length + tokens.shape[1]))
