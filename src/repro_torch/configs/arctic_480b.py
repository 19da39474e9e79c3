"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; 128 experts
top-2 with a parallel dense residual MLP]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    qkv_bias=False, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=False, rope_theta=10000.0,
    moe=MoESpec(n_experts=128, top_k=2, expert_d_ff=4864,
                dense_residual_ff=4864),
    param_dtype="bfloat16", kv_cache_dtype="float8_e4m3fn")
