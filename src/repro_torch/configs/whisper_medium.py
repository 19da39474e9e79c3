"""Whisper-medium [arXiv:2212.04356; enc-dec, conv frontend STUBBED:
inputs are precomputed frame embeddings]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio", num_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865,
    qkv_bias=True, out_bias=True, norm="layernorm", activation="gelu",
    gated_mlp=False, tie_embeddings=True, enc_layers=24, dec_layers=24)
