"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; phi3-mini
backbone + CLIP frontend STUBBED: input_specs provides patch embeddings]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064,
    qkv_bias=False, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=False, rope_theta=10000.0, num_patches=576,
    kv_cache_dtype="float8_e4m3fn")
