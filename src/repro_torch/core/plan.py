"""Host-side wire planning for the single-group dataplane.

The subset of ``repro.core.plan`` the single-group fused path uses: burst
quantization (every wire burst is a power of two in ``[MIN_BURST, batch]``,
whatever the engine, so the plain engine and the kernel see identical burst
shapes and their delivery logs cannot fork), the burst packing convention,
and the reference kernel's batch block, which decides where the failover
restore burns the watermark forward to.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

NO_ROUND = -1
NOP_SENTINEL = -0x7FFFFFFF  # first value word marking an internal filler slot
MIN_BURST = 8  # smallest wire burst (pow2 quantization floor)
# The reference kernel's batch block (``repro.kernels.wirepath``); instance
# numbering after a coordinator restore depends on it, so it is kept here.
DEFAULT_BLOCK_B = 128


def wire_block(b: int) -> int:
    """The reference kernel's batch-block size for a burst of ``b``."""
    return min(DEFAULT_BLOCK_B, b)


def quantize_burst(n: int, cap: int) -> int:
    """Wire-burst sizing: next power of two >= ``n`` in [MIN_BURST, cap]."""
    be = MIN_BURST
    while be < n:
        be *= 2
    return min(be, cap)


def pack_rows(
    rows: Sequence[np.ndarray], be: int, value_words: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pack encoded value rows into a ``(be, V)`` wire burst; unfilled slots
    carry the NOP sentinel and are inactive.  An oversized chunk fails
    before any wire array is built."""
    if len(rows) > be:
        raise ValueError(f"chunk of {len(rows)} rows exceeds quantized burst {be}")
    vals = np.zeros((be, value_words), np.int32)
    active = np.zeros((be,), bool)
    vals[:, 0] = NOP_SENTINEL
    for j, row in enumerate(rows):
        vals[j] = row
        active[j] = True
    return vals, active
