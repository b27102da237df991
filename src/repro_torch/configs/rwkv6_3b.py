"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch: data-dependent decay time-mix + channel-mix. [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # 2560 / rwkv_head_dim(64)
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    tie_embeddings=False,    # rwkv uses separate head
)
