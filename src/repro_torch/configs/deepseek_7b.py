"""DeepSeek-7B [arXiv:2401.02954; llama-arch dense, MHA kv=32]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    qkv_bias=False, norm="rmsnorm", activation="silu", gated_mlp=True,
    tie_embeddings=False, rope_theta=10000.0,
    kv_cache_dtype="float8_e4m3fn")
