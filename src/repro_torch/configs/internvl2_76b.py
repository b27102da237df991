"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    n_patches=256,           # stub ViT patch embeddings per image
    rope_theta=1_000_000.0,
)
