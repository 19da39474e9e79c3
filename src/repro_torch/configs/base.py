"""Architecture + shape configuration (a copy of `repro.configs.base`,
which imports no JAX; `tests/test_torch_lm.py` holds every config and its
parameter counts to the reference's).

One `ArchConfig` instance per assigned architecture (see configs/<id>.py) and
four canonical input-shape presets.  Everything here is static/hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0          # arctic: parallel dense MLP width
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    out_bias: bool = False
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    activation: str = "silu"
    gated_mlp: bool = True
    parallel_block: bool = False        # command-r style attn ∥ mlp
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    # ssm / hybrid
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_attn_every: int = 6          # zamba2: shared attn block period
    # enc-dec (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    # vlm
    num_patches: int = 0
    # attention chunking (XLA flash-style path)
    q_chunk: int = 512
    kv_chunk: int = 1024
    skip_masked_chunks: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # KV-cache storage dtype (decode); float8_e4m3fn halves HBM for the
    # MHA archs whose 32k x batch-128 caches the reference sized for its
    # TPU dry-run
    kv_cache_dtype: str = ""
    # activation checkpointing for the train path:
    #   "layer"  — remat each scanned layer body (recompute in backward)
    #   "dots"   — save matmul outputs w/o batch dims (XLA policy)
    #   "none"
    remat: str = "layer"
    # sub-quadratic? (drives long_500k applicability)
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.sub_quadratic
        return True

    def param_count_estimate(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.family == "ssm":  # rwkv6
            attn = 5 * d * d  # r,k,v,g,o (decay/mix LoRAs are negligible)
            mlp = 3 * d * self.d_ff if False else (2 * d * self.d_ff + d * d)
            layers = l * (attn + mlp)
        elif self.family == "hybrid":
            d_inner = self.ssm_expand * d
            mamba = d * (2 * d_inner + 2 * self.ssm_state
                         + d_inner // self.ssm_head_dim) + d_inner * d
            n_attn = max(1, l // self.hybrid_attn_every)
            layers = l * (mamba + 2 * d * self.d_ff) + attn  # shared attn once
            del n_attn
        elif self.moe is not None:
            expert = 3 * d * self.moe.expert_d_ff if self.gated_mlp \
                else 2 * d * self.moe.expert_d_ff
            mlp = self.moe.n_experts * expert + d * self.moe.n_experts
            mlp += (3 * d * self.moe.dense_residual_ff
                    if self.moe.dense_residual_ff else 0)
            layers = l * (attn + mlp)
        else:
            mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
            layers = l * (attn + mlp)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return layers + embed

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count_estimate()
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        expert = (3 if self.gated_mlp else 2) * d * self.moe.expert_d_ff
        mlp = self.moe.top_k * expert + d * self.moe.n_experts
        mlp += (3 * d * self.moe.dense_residual_ff
                if self.moe.dense_residual_ff else 0)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp) + embed


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    moe = None
    if cfg.moe is not None:
        # near-dropless capacity in smoke tests so batched-vs-incremental
        # (prefill+decode) outputs agree (drops differ across batch splits)
        moe = MoESpec(n_experts=min(cfg.moe.n_experts, 4),
                      top_k=min(cfg.moe.top_k, 2), expert_d_ff=64,
                      capacity_factor=4.0,
                      dense_residual_ff=64 if cfg.moe.dense_residual_ff else 0)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        enc_layers=min(cfg.enc_layers, 2),
        dec_layers=min(cfg.dec_layers, 2),
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=256, vocab_size=256, moe=moe,
        ssm_state=16, ssm_head_dim=32, hybrid_attn_every=2,
        num_patches=4 if cfg.num_patches else 0,
        q_chunk=64, kv_chunk=64,
        compute_dtype="float32", kv_cache_dtype="")
