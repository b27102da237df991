"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,            # MQA
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    local_window=2048,
    d_rnn=2560,
    conv_width=4,
    block_pattern=("rec", "rec", "attn"),
)
