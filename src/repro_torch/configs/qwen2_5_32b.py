"""Qwen2.5-32B [hf:Qwen/Qwen2.5 family; dense, GQA kv=8, QKV bias]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=27648, vocab_size=152064,
    qkv_bias=True, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=False, rope_theta=1000000.0,
    skip_masked_chunks=True)
