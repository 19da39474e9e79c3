"""Command-R+ 104B [hf:CohereForAI/c4ai-command-r-v01 scaled; parallel
attn||mlp blocks, LayerNorm, no biases, tied embeddings]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense", num_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab_size=256000,
    qkv_bias=False, norm="layernorm", activation="silu", gated_mlp=True,
    parallel_block=True, tie_embeddings=True, rope_theta=75000000.0,
    param_dtype="bfloat16", kv_cache_dtype="float8_e4m3fn")
