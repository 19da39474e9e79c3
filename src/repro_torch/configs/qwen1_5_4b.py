"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family scaling; dense, QKV bias]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense", num_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
    qkv_bias=True, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=False, rope_theta=10000.0,
    kv_cache_dtype="float8_e4m3fn")
