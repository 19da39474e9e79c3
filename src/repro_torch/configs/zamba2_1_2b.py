"""Zamba2-1.2B [arXiv:2411.15242; Mamba2 backbone + shared attention
block; ssm_state=64; sub-quadratic => long_500k runs]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    qkv_bias=False, norm="rmsnorm", activation="gelu", gated_mlp=True,
    tie_embeddings=True, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6, sub_quadratic=True)
