"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec,
conv frontend (stub: input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,              # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    src_len=1500,            # 30 s of 10 ms frames after conv stride 2 (stub)
)
