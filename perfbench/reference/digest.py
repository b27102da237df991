"""The gradient digest that a training step reports and commits, written from
its definition.

For each leaf, in sorted-key order: its elements' bit patterns read as
signed integers of the element's width (a 16-bit element sign-extended),
``w[i]`` at row-major index ``i`` weighted by ``2 * i + 1`` and summed,
modulo 2^32.  The leaves fold as ``acc = (acc * 1000003 + sum) mod 2^32``
from 0, and the digest is ``acc`` read as a signed 32-bit integer.
"""

from __future__ import annotations

import torch

from .adamw import leaves

CHUNK = 1 << 24  # elements folded at a time
MASK = (1 << 32) - 1


def leaf_sum(x: torch.Tensor) -> int:
    """``sum(bits[i] * (2i + 1)) mod 2^32`` over ``x``'s elements."""
    width = {2: torch.int16, 4: torch.int32}[x.element_size()]
    bits = x.contiguous().view(width).reshape(-1)
    total = 0
    for start in range(0, bits.numel(), CHUNK):
        w = bits[start : start + CHUNK].to(torch.int64)
        i = torch.arange(start, start + w.numel(), dtype=torch.int64, device=x.device)
        # int64 products and sums wrap modulo 2^64, which keeps them modulo 2^32
        total = (total + int(torch.sum(w * (2 * i + 1)))) & MASK
    return total


def digest(tree: dict) -> int:
    acc = 0
    for _, leaf in leaves(tree):
        acc = (acc * 1000003 + leaf_sum(leaf)) & MASK
    return acc - (1 << 32) if acc >= 1 << 31 else acc
