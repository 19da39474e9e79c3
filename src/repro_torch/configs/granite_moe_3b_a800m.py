"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0 family; 40 experts
top-8, expert d_ff=512, GQA kv=8]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
    qkv_bias=False, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=True, rope_theta=10000.0,
    moe=MoESpec(n_experts=40, top_k=8, expert_d_ff=512,
                capacity_factor=1.0),
    remat="dots")  # the reference's choice for its TPU dry-run
