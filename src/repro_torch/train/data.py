"""Deterministic synthetic data pipeline, shardable across hosts.

A copy of ``repro.train.data`` for the port (numpy only: batches come out
as numpy arrays, bitwise the reference's, and go to the device in the
training loop).  A seeded counter-based generator (on (seed, step)) gives
every host the same view of the global stream with zero coordination, the
property a deterministic tokenized-shard layout gives a real run; here one
process yields the full global batch.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    mode: str = "uniform"  # uniform (i.i.d. tokens) | arith (learnable)
    # modality stubs
    n_patches: int = 0
    src_len: int = 0
    d_model: int = 0


class SyntheticStream:
    """Counter-based deterministic token stream (restart-safe: indexable by step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
        if cfg.mode == "arith":
            # learnable stream: x_{t+1} = x_t + 1 (mod vocab); the model can
            # reach near-zero loss — used by convergence examples/tests
            start = rng.integers(0, cfg.vocab, size=(cfg.global_batch, 1))
            idx = np.arange(cfg.seq_len + 1)[None, :]
            tokens = ((start + idx) % cfg.vocab).astype(np.int32)
        else:
            shape = (cfg.global_batch, cfg.seq_len + 1)
            tokens = rng.integers(0, cfg.vocab, size=shape, dtype=np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.n_patches:
            out["patches"] = rng.standard_normal(
                (cfg.global_batch, cfg.n_patches, cfg.d_model), dtype=np.float32
            )
        if cfg.src_len:
            out["frames"] = rng.standard_normal(
                (cfg.global_batch, cfg.src_len, cfg.d_model), dtype=np.float32
            )
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
