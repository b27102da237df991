"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    local_window=1024,
    global_every=6,          # 5 local : 1 global
    rope_theta=1_000_000.0,
)
