"""RWKV6 "Finch" 3B [arXiv:2404.05892; attention-free, data-dependent
decay; O(1) state => long_500k runs]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab_size=65536,
    norm="layernorm", tie_embeddings=False, ssm_head_dim=64,
    sub_quadratic=True)
