"""The yardstick's arithmetic: the H100's data-sheet peaks, a training step's
operations and K9's bound.  A frozen copy of the program's
``analysis/analytic.py`` (the dense family's training terms, on one card)
and ``analysis/bounds.py`` (K9), so a later change to the program cannot
move what its metrics are measured against.

Conventions of the original: a multiply-add is 2 operations; the forward
pass's products are ``2 · N · tokens`` with ``N`` its approximate parameter
count (``n_params``: the embedding once, which counts the output head's
product where the embeddings are tied and the product a separate head would
add where they are not); attention adds ``4 · pairs · H · D`` a layer and
sequence, half the square under the causal mask.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12  # FLOP/s, dense, tensor cores (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12  # bytes/s (data sheet)


@dataclasses.dataclass(frozen=True)
class Dense:
    """The sizes the arithmetic reads, from a ``config.json``."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @classmethod
    def from_config(cls, conf: dict) -> Dense:
        h = conf["num_attention_heads"]
        return cls(
            n_layers=conf["num_hidden_layers"],
            d_model=conf["hidden_size"],
            n_heads=h,
            n_kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim") or conf["hidden_size"] // h,
            d_ff=conf["intermediate_size"],
            vocab=conf["vocab_size"],
        )

    @property
    def n_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        return self.vocab * d + self.n_layers * (attn + 3 * d * self.d_ff)


def attention_flops(m: Dense, batch: int, seq: int) -> float:
    """The attention's score and value products of one forward pass over
    ``batch`` causal sequences of ``seq`` tokens, every layer."""
    pairs = seq * seq / 2
    return batch * m.n_layers * 2.0 * 2.0 * pairs * m.n_heads * m.head_dim


def train_terms(m: Dense, batch: int, seq: int) -> dict[str, float]:
    """One training step on one card with remat "full": ``flops`` as executed
    (the forward recomputed in the backward: 4x the forward's products, plus
    Adam's 10 a parameter), ``hbm_bytes`` and ``model_flops`` (6 N tokens)."""
    tokens = batch * seq
    n = float(m.n_params)
    p_bytes = n * 2.0
    matmul = 2.0 * n * tokens
    mix = attention_flops(m, batch, seq)
    flops = 4.0 * (matmul + mix) + 10.0 * (p_bytes / 2.0)
    param_traffic = p_bytes * 3 + (p_bytes / 2) * (4 + 4) * 2 + p_bytes * 2
    act_save = m.n_layers * batch * seq * m.d_model * 2.0 * 2 * 1.0
    io = batch * seq * 4.0 * 2
    logits = batch * seq * m.vocab * 2.0 * 2
    return {
        "flops": flops,
        "hbm_bytes": param_traffic + act_save + io + logits,
        "model_flops": 6.0 * n * tokens,
    }


def step_flops(m: Dense, batch: int, seq: int) -> float:
    """The operations a step's forward and backward passes need, counting no
    recomputation: three times the forward's products and attention."""
    return train_terms(m, batch, seq)["model_flops"] + 3.0 * attention_flops(m, batch, seq)


def causal_pairs(sq: int, sk: int, offset: int) -> int:
    """#{(i, j): 0 <= i < sq, 0 <= j < sk, j <= i + offset}."""

    def rows(x: int) -> int:
        if x <= 0:
            return 0
        if x <= sk:
            return x * (x + 1) // 2
        return sk * (sk + 1) // 2 + (x - sk) * sk

    return rows(offset + sq) - rows(offset)


def k9_operations(b: int, h: int, sq: int, sk: int, d: int, causal: bool = True) -> int:
    """K9's operations on q (B, H, Sq, D): 4·D a (row, key) pair it computes."""
    pairs = causal_pairs(sq, sk, 0) if causal else sq * sk
    return 4 * d * pairs * b * h


def k9_bytes(b: int, h: int, kvh: int, sq: int, sk: int, d: int, itemsize: int) -> int:
    """q, k and v read once, the output written once."""
    return itemsize * (2 * b * h * sq * d + 2 * b * kvh * sk * d)


def k9_bound_s(b: int, h: int, kvh: int, s: int, d: int, itemsize: int = 2) -> float:
    """The least time one causal K9 launch could take: the larger of its
    operations at the bf16 peak and its bytes at the memory rate."""
    return max(k9_operations(b, h, s, s, d) / PEAK_BF16,
               k9_bytes(b, h, kvh, s, s, d, itemsize) / HBM_BYTES_PER_S)  # fmt: skip
