"""The port's digest and seal fold against the reference's, bit for bit.

``repro_torch.kernels.ops.digest``/``tree_digest`` on CPU tensors (the plain
fold) against ``repro.kernels.digest`` in interpret mode and
``repro.kernels.ref.digest``: int32 and float32 leaves, lengths that are not
a multiple of the reference kernel's block, and the empty seal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import snapshot as rsnap  # noqa: E402
from repro.kernels import digest as rdigest  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import snapshot as tsnap  # noqa: E402
from repro_torch.kernels import digest as tdigest  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# the reference kernel's block is 32 Ki elements: lengths below, at and
# across it, odd ones included
LENGTHS = [1, 7, 1000, 32 * 1024, 32 * 1024 + 5, 70_001]


def _leaf(rng, n: int, dtype: str) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31, n, dtype=np.int32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", LENGTHS)
def test_digest_matches_reference(n, dtype):
    x = _leaf(np.random.default_rng([n, len(dtype)]), n, dtype)
    got = int(tops.digest(torch.from_numpy(x)))
    assert got == int(rref.digest(jnp.asarray(x)))
    assert got == int(rdigest.digest(jnp.asarray(x), interpret=True))


def test_digest_of_a_2d_leaf_is_its_flat_fold():
    x = np.random.default_rng(1).integers(-(2**31), 2**31, (300, 16), dtype=np.int32)
    assert int(tops.digest(torch.from_numpy(x))) == int(rref.digest(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float16, torch.int64, torch.float64])
def test_digest_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        tops.digest(torch.zeros(8, dtype=dtype))
    with pytest.raises(TypeError):
        tdigest.digest_plain(torch.zeros(8, dtype=dtype))


def test_digest_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdigest.digest(torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("seed", range(3))
def test_tree_digest_matches_reference(seed):
    rng = np.random.default_rng([seed, 9])
    leaves = [_leaf(rng, int(rng.integers(1, 5000)), d) for d in ("int32", "float32", "int32")]
    leaves.append(rng.integers(-(2**31), 2**31, (77, 16), dtype=np.int32))
    want = int(rdigest.tree_digest([jnp.asarray(x) for x in leaves], interpret=True))
    assert tops.tree_digest([torch.from_numpy(x) for x in leaves]) == want


def test_seal_matches_reference_and_empty_seals_to_zero():
    rng = np.random.default_rng(5)
    insts = np.sort(rng.choice(10_000, 700, replace=False)).astype(np.int32)
    values = rng.integers(-(2**31), 2**31, (700, 16), dtype=np.int32)
    assert tsnap._seal(insts, values, "cpu") == rsnap._seal(insts, values)
    empty = (np.zeros((0,), np.int32), np.zeros((0, 16), np.int32))
    assert tsnap._seal(*empty, "cpu") == rsnap._seal(*empty) == 0
    assert tops.tree_digest([]) == 0


# ---------------------------------------------------------------------------
# K4's launch geometry (csrc/digest.cu, laid out on the host)
# ---------------------------------------------------------------------------
SM_COUNT = 132  # the H100's SMs
# (lengths, byte offsets past 16): the seal's two leaves, odd lengths,
# empty leaves among full ones, views 4, 8 and 12 bytes off 16, leaves
# shorter than their head, and eight leaves
GEOMETRY_CASES = [
    ([16_384, 16_384 * 16], [0, 0]),
    ([98_304, 98_304 * 16], [0, 0]),
    ([524_287], [4]),
    ([0, 1_000_001, 0, 7], [0, 8, 12, 4]),
    ([1, 2, 3, 5, 6, 0], [12, 8, 4, 4, 12, 0]),
    ([1], [8]),
    ([0], [0]),
    ([0, 0, 0], [4, 8, 12]),
    ([70_001, 1, 4096 * 256 + 3, 9, 33, 1 << 20, 12, 255], [4, 12, 8, 0, 4, 0, 8, 12]),
    ([1 << 26, 1 << 22], [0, 4]),
]


def _block_words(geo, b: int) -> tuple[int, list[tuple[int, int]]]:
    """The leaf block ``b`` folds and the half-open word ranges it reads
    there, as ``csrc/digest.cu`` walks them: its chunk of the int4 body,
    and the head and tail words in the leaf's first block."""
    for leaf, s in enumerate(geo.leaves):
        if s.first <= b < s.first + s.blocks:
            c = b - s.first
            start, end = c * s.chunk, min((c + 1) * s.chunk, s.body)
            spans = [(s.head + 4 * start, s.head + 4 * end)]
            if c == 0:
                tail = s.head + 4 * s.body
                spans += [(0, s.head), (tail, tail + s.tail)]
            return leaf, [(lo, hi) for lo, hi in spans if hi > lo]
    raise AssertionError(f"block {b} belongs to no leaf")


@pytest.mark.parametrize("lengths,align", GEOMETRY_CASES)
def test_digest_geometry_covers_every_word_once(lengths, align):
    """Every word of every leaf, head and tail included, lies in exactly one
    block's chunk; each block reads one leaf, and each leaf's blocks are one
    run of the grid, in leaf order."""
    geo = tdigest.digest_geometry(lengths, align, SM_COUNT)
    (blocks,) = geo.grid
    assert blocks >= 1 and geo.block == tdigest.THREADS
    seen = [np.zeros(n, np.uint8) for n in lengths]
    owner = []
    for b in range(blocks):
        leaf, spans = _block_words(geo, b)
        owner.append(leaf)
        for lo, hi in spans:
            seen[leaf][lo:hi] += 1
    for n, count in zip(lengths, seen, strict=True):
        assert (count == 1).all(), (n, np.flatnonzero(count != 1)[:5])
    assert owner == sorted(owner)
    for leaf, s in enumerate(geo.leaves):
        assert owner.count(leaf) == s.blocks
        assert s.head + 4 * s.body + s.tail == lengths[leaf]
        assert 0 <= s.tail <= 3
        # the body starts on 16 bytes
        assert s.body == 0 or (align[leaf] + 4 * s.head) % 16 == 0


@pytest.mark.parametrize("lengths,align", GEOMETRY_CASES)
def test_digest_geometry_sizes_the_grid_by_the_bytes(lengths, align):
    geo = tdigest.digest_geometry(lengths, align, SM_COUNT)
    units = sum(-(-s.body // tdigest.THREADS) for s in geo.leaves)
    words = sum(lengths)
    bodiless = sum(1 for s in geo.leaves if not s.body and s.head + s.tail)
    # no more blocks than chunks at small sizes ...
    assert geo.grid[0] <= max(1, units + bodiless)
    assert geo.grid[0] <= SM_COUNT * tdigest.BLOCKS_PER_SM + len(lengths)
    # ... and at least one block every SM at large ones
    full = SM_COUNT * tdigest.BLOCKS_PER_SM * tdigest.MIN_UNITS  # units of a full grid
    if words >= full * tdigest.THREADS * 4:
        assert geo.grid[0] >= SM_COUNT


def test_digest_geometry_refuses_what_the_table_cannot_hold():
    with pytest.raises(ValueError, match="1 to 8 leaves"):
        tdigest.digest_geometry([4] * 9, [0] * 9, SM_COUNT)
    with pytest.raises(ValueError, match="1 to 8 leaves"):
        tdigest.digest_geometry([], [], SM_COUNT)
    with pytest.raises(ValueError, match="bytes past 16"):
        tdigest.digest_geometry([8], [2], SM_COUNT)
    with pytest.raises(ValueError, match="alignments"):
        tdigest.digest_geometry([8, 8], [0], SM_COUNT)


def _kernel_model(leaves: list[np.ndarray], align: list[int]) -> list[int]:
    """What ``csrc/digest.cu`` computes over ``digest_geometry``'s launch,
    in numpy uint32: each block folds its chunk of int4 words with the
    weights w, w+2, w+4, w+6 of the word index's 2i+1, its leaf's first
    block also the head and tail words; the leaf's digest is the sum of
    its blocks' partials."""
    geo = tdigest.digest_geometry([x.size for x in leaves], align, SM_COUNT)
    out = [np.uint32(0)] * len(leaves)
    for b in range(geo.grid[0]):
        leaf, _ = _block_words(geo, b)
        s = geo.leaves[leaf]
        x = leaves[leaf].reshape(-1).view(np.uint32)
        c = b - s.first
        q = np.arange(c * s.chunk, min((c + 1) * s.chunk, s.body), dtype=np.int64)
        w = (2 * (s.head + 4 * q) + 1).astype(np.uint32)
        v = x[s.head : s.head + 4 * s.body].reshape(-1, 4)[q]
        with np.errstate(over="ignore"):
            acc = (v[:, 0] * w + v[:, 1] * (w + 2) + v[:, 2] * (w + 4) + v[:, 3] * (w + 6)).sum(
                dtype=np.uint32
            )
            if c == 0:
                idx = np.r_[0 : s.head, s.head + 4 * s.body : x.size].astype(np.int64)
                acc += (x[idx] * (2 * idx + 1).astype(np.uint32)).sum(dtype=np.uint32)
            out[leaf] = np.uint32(out[leaf] + acc)
    return [int(np.int32(np.uint32(d).view(np.int32))) for d in out]


@pytest.mark.parametrize("lengths,align", GEOMETRY_CASES[:-1])
def test_kernel_model_over_the_geometry_is_the_reference_fold(lengths, align):
    rng = np.random.default_rng([len(lengths), sum(lengths) % 9973])
    leaves = [_leaf(rng, n, "int32" if i % 2 else "float32") for i, n in enumerate(lengths)]
    want = [int(rref.digest(jnp.asarray(x))) if x.size else 0 for x in leaves]
    assert _kernel_model(leaves, align) == want


# ---------------------------------------------------------------------------
# the plain tree form and the chunked fold
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [16_384, 1_000])
def test_tree_digest_plain_matches_reference_on_the_seal_leaves(k):
    """The seal's two leaves, insts (K,) and values (K, V): per leaf and
    combined, bit for bit against the reference's digest and tree_digest."""
    rng = np.random.default_rng(k)
    insts = np.sort(rng.choice(4 * k, k, replace=False)).astype(np.int32)
    values = rng.integers(-(2**31), 2**31, (k, 16), dtype=np.int32)
    ds = tdigest.tree_digest_plain([torch.from_numpy(insts), torch.from_numpy(values)])
    assert ds.dtype == torch.int32 and ds.shape == (2,)
    want = [int(rdigest.digest(jnp.asarray(x), interpret=True)) for x in (insts, values)]
    assert ds.tolist() == want
    tree = int(rdigest.tree_digest([jnp.asarray(insts), jnp.asarray(values)], interpret=True))
    assert tdigest.combine(ds.tolist()) == tree
    assert tops.tree_digest([torch.from_numpy(insts), torch.from_numpy(values)]) == tree


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("chunk", [1, 7, 1000, 32 * 1024, 70_000, 70_001, 1 << 20])
def test_chunked_fold_is_the_whole_fold(chunk, dtype):
    """D(x) = sum_c [D(x_c) + 2 o_c S(x_c)] mod 2^32 at any chunk size: the
    oracle for leaves too large for one plain call."""
    x = _leaf(np.random.default_rng([chunk, len(dtype)]), 70_001, dtype)
    got = int(tdigest.digest_plain_chunked(torch.from_numpy(x), chunk))
    assert got == int(tdigest.digest_plain(torch.from_numpy(x))) == int(rref.digest(jnp.asarray(x)))


def test_chunked_fold_splits_at_any_offset():
    rng = np.random.default_rng(77)
    x = rng.integers(-(2**31), 2**31, 5_003, dtype=np.int32)
    whole = int(rref.digest(jnp.asarray(x)))
    for cut in (1, 2, 3, 4, 5, 17, 2_500, 5_002):
        acc = 0
        for o, part in ((0, x[:cut]), (cut, x[cut:])):
            d = int(tdigest.digest_plain(torch.from_numpy(part)))
            s = int(part.view(np.uint32).sum(dtype=np.uint64))
            acc = (acc + d + 2 * o * s) & 0xFFFFFFFF
        assert tdigest._signed(acc) == whole, cut


def test_tree_digest_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdigest.tree_digest([torch.zeros(8, dtype=torch.int32)])
    with pytest.raises(ValueError, match="at least one leaf"):
        tdigest.tree_digest([])


@pytest.fixture
def ticket_rows(monkeypatch):
    """The ticket rows' bookkeeping, empty, for this test alone."""
    monkeypatch.setattr(tdigest, "_rows", {})
    monkeypatch.setattr(tdigest, "_taken", {})
    return tdigest._ticket_row


def test_ticket_rows_are_a_streams_own(ticket_rows):
    """An eager launch uses its stream's row: the same at every launch on
    that stream, another on another stream or device."""
    a, b = ticket_rows(0, 11, False), ticket_rows(0, 22, False)
    assert a != b
    assert ticket_rows(0, 11, False) == a and ticket_rows(0, 22, False) == b
    assert ticket_rows(1, 11, False) == 0  # each device counts its own rows


def test_ticket_rows_of_captured_launches_are_their_own(ticket_rows):
    """Each launch captured in a CUDA graph takes a row that no stream and
    no other captured launch uses, even when every capture ran on one
    stream (``torch.cuda.graph``'s shared capture stream)."""
    eager = ticket_rows(0, 11, False)
    captured = [ticket_rows(0, 11, True) for _ in range(5)]
    assert len({eager, *captured}) == 6
    assert ticket_rows(0, 11, False) == eager  # the stream keeps its row


def test_ticket_rows_run_out_with_an_error(ticket_rows, monkeypatch):
    monkeypatch.setattr(tdigest, "_ROWS", 3)
    for stream in range(3):
        ticket_rows(0, stream, stream == 1)
    assert ticket_rows(0, 0, False) == 0  # a stream with a row keeps it
    with pytest.raises(RuntimeError, match="3 ticket rows a device"):
        ticket_rows(0, 0, True)
    with pytest.raises(RuntimeError, match="3 ticket rows a device"):
        ticket_rows(0, 9, False)
