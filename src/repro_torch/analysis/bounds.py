"""The least time each hand-written kernel could take on one H100.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does over the card's peak rate for their type
(``analysis.roofline``'s data-sheet rates).  Every count here is a pure
function of the kernel's shapes, whatever code implements the kernel, so
``chip_smoke.py``'s kernel lines and a benchmark's rows read one count.

The consensus kernels' counts (K1-K8) hold for the timed walks' data: every
lane accepted by all A acceptors and fresh, as on the main path with every
acceptor alive; their operations are int32 compares, selects and adds.
K9's count is its pairs of (query row, key), of each head and batch row,
at 4·D bf16 tensor-core operations a pair.

The reference has no such module: its TPU bound per message lives in
``benchmarks/table2_throughput.py``.  Imports nothing but the rates.
"""

from __future__ import annotations

from repro_torch.analysis.roofline import HBM_BW, INT32_OPS_PER_S


def bound_ms(nbytes: float, ops_: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """Milliseconds of the bound on ``nbytes`` bytes and ``ops_`` operations
    at ``ops_per_s``, and which of the two it is: ``"bytes"`` or
    ``"operations"``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops_ / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bytes(a: int, b: int, v: int) -> int:
    """The bytes one K1 launch reads and writes when every lane is accepted
    by all A acceptors and is fresh, as on the main path with every acceptor
    alive.  Reads: the promised rounds rnd (A*B*4), the learner's delivered
    flag and instance (2*B*4), the burst (B*V*4), alive (A) and the
    watermark and round (8).  Writes: rnd, vrnd and V value words of each
    acceptor (A*B*(2+V)*4), the learner's flag, instance and value words
    (B*(2+V)*4), and the outputs: the new watermark (4), inst and win
    (2*B*4), fresh (B) and value (B*V*4).  vrnd, the acceptors' values and
    the learner's values are written, never read, so they count once.  At
    A=3, B=128, V=16: 10,763 B read + 46,212 B written = 56,975 B."""
    read = a * b * 4 + 2 * b * 4 + b * v * 4 + a + 8
    written = a * b * (2 + v) * 4 + b * (2 + v) * 4 + 4 + 2 * b * 4 + b + b * v * 4
    return read + written


def k1_operations(a: int, b: int, v: int, c: int = 1) -> int:
    """K1's operations over ``c`` groups (or K6's lanes) of B lanes: per
    lane, a compare, an and, a select and a max per acceptor; the agree
    count; the slot, the permit and the dedup test; the V selects."""
    return c * b * (4 * a + 2 * a + 8 + v)


def k1_cohort_bytes(a: int, b: int, v: int, c: int, nb: int) -> int:
    """The bytes one cohort K1 launch reads and writes over ``c`` selected
    groups in ``nb`` blocks when every lane is accepted by all A acceptors
    and is fresh: ``k1_bytes``'s terms per group, less the watermark and
    instance outputs the cohort entry does not write (4 + B*4), plus the
    limit and enabled words it reads (8), plus one gsel word per block.  At
    A=3, B=128, V=16: 56,467 B per group."""
    return c * (k1_bytes(a, b, v) - 4 - b * 4 + 8) + 4 * nb


def k2_bytes(a: int, b: int, v: int) -> int:
    """The bytes one K2 launch reads and writes when every lane is accepted
    by all A acceptors (then ``st_vrnd`` is not read).  Reads: the batch's
    msgtype, inst and rnd (3*B*4) and values (B*V*4), alive (A), and the
    promised rounds (A*B*4).  Writes: rnd and vrnd (2*A*B*4) and the V value
    words (A*B*V*4) of each acceptor's register, and the votes: type, inst,
    rnd, vrnd and swid (5*A*B*4) and values (A*B*V*4).  At A=3, B=128,
    V=16: 11,267 B read + 59,904 B written = 71,171 B."""
    read = 3 * b * 4 + b * v * 4 + a + a * b * 4
    written = 2 * a * b * 4 + a * b * v * 4 + 5 * a * b * 4 + a * b * v * 4
    return read + written


def k2_operations(a: int, b: int) -> int:
    """K2's operations: 11 a (acceptor, lane)."""
    return 11 * a * b


def k3_bytes(b: int) -> int:
    """K3 reads active (B bools), the watermark and the round (8), and writes
    msgtype, inst, rnd, vrnd and swid (5*B*4) and the new watermark (4).  At
    B=128: 2,700 B."""
    return b + 8 + 5 * b * 4 + 4


def k3_operations(b: int) -> int:
    """K3's operations: 6 a lane."""
    return 6 * b


def k4_bytes(leaf_words: list[int]) -> int:
    """K4 reads every word of every leaf once and writes one digest a leaf;
    ``leaf_words`` holds each leaf's element count (4-byte words).  At the
    N/4 seal (16,384 + 262,144 words) 1,114,120 B."""
    return 4 * sum(leaf_words) + 4 * len(leaf_words)


def k4_operations(leaf_words: list[int]) -> int:
    """K4's fold: a multiply and an add for each word it moves."""
    return 2 * k4_bytes(leaf_words) // 4


def k5_bytes(a: int, b: int, v: int, c: int, nb: int, k: int, g: int) -> int:
    """The bytes one K5 launch of K rounds reads and writes over ``c``
    selected groups in ``nb`` blocks when every lane is accepted by all A
    acceptors and is fresh: K times ``k1_cohort_bytes`` plus the (K, G)
    descriptor words ``wni`` and ``wen``.  At A=3, B=128, V=16, K=8, G=8:
    3,614,432 B for eight groups, 452,280 B for one."""
    return k * k1_cohort_bytes(a, b, v, c, nb) + 2 * k * g * 4


def k5_operations(a: int, b: int, v: int, c: int, k: int) -> int:
    """K5's operations: K rounds of K1's over ``c`` groups."""
    return k * k1_operations(a, b, v, c)


def k6_bytes(a: int, b: int, v: int, c: int) -> int:
    """The bytes one K6 launch of ``c`` enabled lanes reads and writes when
    every lane is accepted by all A acceptors and is fresh: per lane,
    ``k1_cohort_bytes`` of one group (whose next_inst, crnd, limit, enabled
    and alive words are here the lane's table) with alive as A int32 words
    instead of A bytes (+3A), plus the lane's seg word (+4).  At A=3,
    B=128, V=16: 56,480 B per lane."""
    return c * (k1_cohort_bytes(a, b, v, 1, 0) + 3 * a + 4)


def k7_bytes(b: int, v: int) -> int:
    """K2's bytes for one acceptor, without the alive mask: at B=128, V=16,
    10,240 B read + 19,968 B written = 30,208 B."""
    return k2_bytes(1, b, v) - 1


def k7_operations(b: int) -> int:
    """K2's operations for one acceptor."""
    return k2_operations(1, b)


def k8_bytes(a: int, b: int, v: int, agreed: int) -> int:
    """K8 reads every vote's type and vrnd (2*A*B*4) and, on each of the
    ``agreed`` lanes where an acceptor agrees, the first such acceptor's
    value (V*4); it writes deliver and win (2*B*4) and the values (B*V*4).
    At A=3, B=128, V=16 with every lane agreed: 20,480 B."""
    return 2 * a * b * 4 + agreed * v * 4 + 2 * b * 4 + b * v * 4


def k8_operations(a: int, b: int) -> int:
    """K8's operations: 6 an acceptor and 2 more a lane."""
    return b * (6 * a + 2)


def forwarding_bytes(b: int, v: int) -> int:
    """Table 1's forwarding row: one copy of a batch of B messages, each
    five header words and V value words, read once and written once."""
    return 2 * b * (5 + v) * 4


def _causal_pairs(sq: int, sk: int, offset: int) -> int:
    """#{(i, j): 0 <= i < sq, 0 <= j < sk, j <= i + offset}.  Row i counts
    min(max(i + offset + 1, 0), sk) keys, so the sum over rows is
    ``rows(offset + sq) - rows(offset)`` with ``rows(x)`` the sum of
    min(t, sk) over t = 1..x."""

    def rows(x: int) -> int:
        if x <= 0:
            return 0
        if x <= sk:
            return x * (x + 1) // 2
        return sk * (sk + 1) // 2 + (x - sk) * sk

    return rows(offset + sq) - rows(offset)


def k9_pairs(sq: int, sk: int, causal: bool = True, window: int = 0) -> int:
    """The (query row i, key j) pairs K9 computes for one head of one batch
    row: every pair, or key j <= row i when ``causal`` (top-left aligned,
    also where Sq != Sk), and j > i - ``window`` when windowed."""
    if window < 0:
        raise ValueError(f"a negative window ({window})")
    pairs = _causal_pairs(sq, sk, 0) if causal else sq * sk
    return pairs - _causal_pairs(sq, sk, -window) if window else pairs


def k9_operations(
    b: int, h: int, sq: int, sk: int, d: int, causal: bool = True, window: int = 0
) -> int:
    """K9's operations on q (B, H, Sq, D): 4*D a pair (the score's and the
    value's multiply-adds), each head, each batch row."""
    return 4 * d * k9_pairs(sq, sk, causal, window) * b * h


def k9_bytes(b: int, h: int, kvh: int, sq: int, sk: int, d: int, itemsize: int) -> int:
    """K9 reads q (B, H, Sq, D), k and v (B, KVH, Sk, D) once and writes
    the output (B, H, Sq, D) once, every element ``itemsize`` bytes."""
    return itemsize * (2 * b * h * sq * d + 2 * b * kvh * sk * d)
