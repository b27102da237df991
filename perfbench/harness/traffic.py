"""The general generator of training traffic, driven by a workload file.

A workload file of ``kind`` "train" gives ``batch`` rows of ``seq_len``
tokens a step, token ids uniform over the configuration's vocabulary, and
the fault schedule: each of ``replica_groups`` groups abstains from a
step's vote with probability ``straggler_prob``, and a step commits when
at least ``commit_quorum`` groups voted.

Batches are counter-based: step ``i`` of seed ``s`` is drawn from
``numpy.random.default_rng([s, i])`` whoever asks, so the program's feed and
the reference's first steps read the same rows, and every row differs.
"""

from __future__ import annotations

import numpy as np

from .spans import Spans


def _key(seed: int) -> int:
    return seed % (1 << 64)


def batch_at(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> dict:
    """Step ``step``'s batch: int32 ``tokens`` and ``labels`` (``batch``,
    ``seq_len``), the labels the tokens shifted by one."""
    rng = np.random.default_rng([_key(seed), step])
    ids = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class Feed:
    """The program's data iterator: step 0, 1, ... of the seed's stream.
    Each draw is a ``data`` span."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int, spans: Spans):
        self.args = (seed, batch, seq_len, vocab)
        self.spans = spans
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        seed, batch, seq_len, vocab = self.args
        with self.spans("data"):
            out = batch_at(seed, self.step, batch, seq_len, vocab)
        self.step += 1
        return out


def chunk_seed(seed: int, chunk: int) -> int:
    """The straggler seed of the ``chunk``-th call of the training loop."""
    return _key(seed) * 1_000_003 + chunk


def abstentions(rng_seed: int, groups: int, prob: float) -> int:
    """How many groups abstain at the one step of a loop call seeded
    ``rng_seed``: each group in turn draws ``random() < prob`` from
    ``numpy.random.default_rng(rng_seed)``."""
    rng = np.random.default_rng(rng_seed)
    return sum(rng.random() < prob for _ in range(groups))
