"""K4: the snapshot seal's digest, a CUDA kernel, with its plain version.

``tree_digest`` launches ``csrc/digest.cu``, which replaces the TPU kernel
``repro.kernels.digest.digest`` and the leaf loop of its ``tree_digest``:
the weighted fold

    digest = sum_i  bits(x_i) * (2*i + 1)   (mod 2^32)

over the flat 32-bit pattern of each int32 or float32 leaf (floats are
bit-cast), every leaf of a seal in one launch, one digest a leaf.  Odd
weights make it position-sensitive.  ``digest`` is its one-leaf call.
``digest_geometry`` lays out the launch on the host: each leaf's scalar
head up to its first 16-byte boundary, its int4 body and its scalar tail,
and each leaf's run of blocks, sized by the bytes.  ``digest_plain`` and
``tree_digest_plain`` are the same fold in plain PyTorch; ``combine``
folds leaf digests the way the reference's ``tree_digest`` does.  Only
4-byte dtypes are accepted: the reference's fold of 16-bit inputs is not
well defined.
"""

from __future__ import annotations

import ctypes
from collections.abc import Iterable, Sequence
from dataclasses import dataclass

import torch

from repro_torch.analysis.contracts import Binding

from . import _build

_DTYPES = (torch.int32, torch.float32)
_M32 = 0xFFFFFFFF
_MIX = 1000003  # the reference's polynomial combine constant
MAX_LEAVES = 8  # leaves a launch folds (csrc/digest.cu's MAX_LEAVES)
THREADS = 256  # threads a block (csrc/digest.cu's THREADS)
# the grid's sizing (PERF.md section 6): at large leaves BLOCKS_PER_SM
# blocks an SM, and at small ones no block with fewer than MIN_UNITS units,
# one pass of the kernel's loop (its UNROLL)
BLOCKS_PER_SM = 4
MIN_UNITS = 4
_ROWS = 1024  # ticket rows a device holds, MAX_LEAVES int64 words each

# launches of the kernel in this process (one a seal, one a ``digest``);
# reset by whoever reads it
launches = 0

_fn = None
_tickets: dict[int, torch.Tensor] = {}  # device index -> its zeroed ticket rows
_rows: dict[tuple[int, int], int] = {}  # (device index, stream) -> the stream's row
_taken: dict[int, int] = {}  # device index -> rows handed out


class _Leaf(ctypes.Structure):
    """``csrc/digest.cu``'s ``Leaf`` record."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("head", ctypes.c_longlong),
        ("body", ctypes.c_longlong),
        ("tail", ctypes.c_longlong),
        ("chunk", ctypes.c_longlong),
        ("first", ctypes.c_int),
        ("blocks", ctypes.c_int),
    ]


@dataclass(frozen=True)
class LeafSpan:
    """One leaf of a launch: ``head`` scalar words up to its first 16-byte
    boundary, ``body`` int4 words, ``tail`` scalar words, and its blocks
    ``first .. first + blocks - 1``, each folding ``chunk`` int4 words of
    the body (the last one fewer); the first also folds head and tail."""

    head: int
    body: int
    tail: int
    chunk: int
    first: int
    blocks: int


@dataclass(frozen=True)
class DigestGeometry:
    """The launch of one fold: the leaves' spans, threads a block, the grid."""

    leaves: tuple[LeafSpan, ...]
    block: int
    grid: tuple[int]


def digest_geometry(lengths: Sequence[int], align: Sequence[int], sm_count: int) -> DigestGeometry:
    """The launch that folds leaves of ``lengths`` words whose data start
    ``align`` bytes past a 16-byte boundary (0, 4, 8 or 12), on a card of
    ``sm_count`` SMs.  The grid is sized by the bytes: the leaves' int4
    bodies are cut into chunks of a whole number of units of ``THREADS``
    int4 words (one a thread), as many units a chunk as keeps the grid
    within ``BLOCKS_PER_SM`` blocks an SM and at least ``MIN_UNITS``, one
    block a chunk; so large leaves spread over every SM and small ones take
    no more blocks than they have units.  A leaf with words but no body
    takes one block, an empty one none; a launch takes at least one."""
    if len(lengths) != len(align):
        raise ValueError(f"{len(lengths)} leaves but {len(align)} alignments")
    if not 1 <= len(lengths) <= MAX_LEAVES:
        raise ValueError(f"a digest launch folds 1 to {MAX_LEAVES} leaves, got {len(lengths)}")
    parts = []
    for n, off in zip(lengths, align, strict=True):
        if n < 0 or off not in (0, 4, 8, 12):
            raise ValueError(f"a leaf of {n} words at {off} bytes past 16 cannot be folded")
        head = min(n, (16 - off) % 16 // 4)
        body = (n - head) // 4
        parts.append((head, body, n - head - 4 * body))
    units = [-(-body // THREADS) for _, body, _ in parts]
    per = max(MIN_UNITS, -(-sum(units) // (sm_count * BLOCKS_PER_SM)))
    leaves, first = [], 0
    for (head, body, tail), u in zip(parts, units, strict=True):
        blocks = -(-u // per) if body else int(head + tail > 0)
        leaves.append(LeafSpan(head, body, tail, per * THREADS, first, blocks))
        first += blocks
    if not first:  # every leaf empty: one block writes their zeros
        leaves[0] = LeafSpan(0, 0, 0, per * THREADS, 0, 1)
        leaves[1:] = [LeafSpan(0, 0, 0, per * THREADS, 1, 0) for _ in leaves[1:]]
        first = 1
    return DigestGeometry(tuple(leaves), THREADS, (first,))


def _bind(lib, entry: str):
    if lib.tree_digest_leaf_bytes() != ctypes.sizeof(_Leaf):
        raise RuntimeError("csrc/digest.cu's Leaf record differs from kernels.digest._Leaf")
    fn = getattr(lib, entry)
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


BINDINGS = (Binding("digest", "tree_digest", _bind),)


def _kernel():
    global _fn
    if _fn is None:
        _fn = BINDINGS[0].load(_build.library)
    return _fn


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"digest takes int32 or float32 arrays, got {x.dtype}")
    flat = x.reshape(-1)
    return flat if flat.dtype == torch.int32 else flat.view(torch.int32)


def _signed(u: int) -> int:
    u &= _M32
    return u - (1 << 32) if u >= 1 << 31 else u


def _ticket_row(device: int, stream: int, capturing: bool) -> int:
    """The row of ``device``'s ticket words that a launch on ``stream``
    uses.  An eager launch uses its stream's row, taken at the stream's
    first launch, so two digests in flight on two streams never share one.
    A launch captured in a CUDA graph takes a row of its own, which no other
    launch uses: a graph replays on whatever stream it is given, beside
    whatever else runs, so its tickets cannot be those of the stream it was
    captured on.  A graph replayed on two streams at once shares its rows,
    as it shares every buffer it captured."""
    row = None if capturing else _rows.get((device, stream))
    if row is None:
        row = _taken.get(device, 0)
        if row >= _ROWS:
            raise RuntimeError(
                f"the digest has {_ROWS} ticket rows a device: one a stream and one for each "
                "launch captured in a CUDA graph"
            )
        _taken[device] = row + 1
        if not capturing:
            _rows[(device, stream)] = row
    return row


def _ticket(dev: torch.device, stream: int) -> int:
    """The address of the ``MAX_LEAVES`` ticket words of a launch on
    ``stream`` on ``dev`` (``_ticket_row``): zeroed once, at the device's
    first launch, and left at 0 by every launch."""
    capturing = torch.cuda.is_current_stream_capturing()
    pool = _tickets.get(dev.index)
    if pool is None:
        if capturing:
            raise RuntimeError(
                "launch the digest once on this device before capturing it in a CUDA graph: "
                "its ticket words are zeroed at the first launch"
            )
        pool = _tickets[dev.index] = torch.zeros((_ROWS, MAX_LEAVES), dtype=torch.int64, device=dev)
        torch.cuda.current_stream(dev).synchronize()  # zeroed before any stream uses a word
    return pool[_ticket_row(dev.index, stream, capturing)].data_ptr()


def tree_digest(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fold of every leaf in one launch on the card: an int32 tensor of
    one digest a leaf, on the leaves' device (at most ``MAX_LEAVES``)."""
    global launches
    if not leaves:
        raise ValueError("tree_digest needs at least one leaf")
    dev = leaves[0].device
    _build.on_card("digest", dev)
    bits = []
    for x in leaves:
        if x.device != dev:
            raise ValueError(f"digest leaves on {x.device} and {dev}")
        bits.append(_bits(x).contiguous())
    geo = digest_geometry(
        [b.numel() for b in bits],
        [b.data_ptr() % 16 for b in bits],
        torch.cuda.get_device_properties(dev).multi_processor_count,
    )
    table = (_Leaf * len(bits))(*(
        _Leaf(b.data_ptr(), s.head, s.body, s.tail, s.chunk, s.first, s.blocks)
        for b, s in zip(bits, geo.leaves, strict=True)
    ))  # fmt: skip
    out = torch.empty(len(bits), dtype=torch.int32, device=dev)  # no kernel runs
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.addressof(table), len(bits), out.data_ptr(), _ticket(dev, stream),
                geo.grid[0], stream)  # fmt: skip
    _build.check(rc, "digest launch")
    launches += 1
    return out


def digest(x: torch.Tensor) -> torch.Tensor:
    """The fold of one array on the card; returns a 0-d int32 tensor on
    ``x``'s device.  The one-leaf launch of ``tree_digest``."""
    return tree_digest([x])[0]


def digest_plain(x: torch.Tensor) -> torch.Tensor:
    """The same fold in plain PyTorch, on any device: a 0-d int32 tensor.

    Each product ``bits * w`` mod 2^32 is taken in int64 without overflow by
    splitting ``bits`` into 16-bit halves; the sum of n < 2^31 terms below
    2^32 fits int64."""
    bits = _bits(x).to(torch.int64) & _M32
    w = (torch.arange(bits.numel(), dtype=torch.int64, device=x.device) * 2 + 1) & _M32
    lo, hi = bits & 0xFFFF, bits >> 16
    terms = (lo * w + (((hi * w) & 0xFFFF) << 16)) & _M32
    total = terms.sum() & _M32
    return torch.where(total >= 1 << 31, total - (1 << 32), total).to(torch.int32)


def digest_plain_chunked(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``digest_plain`` folded ``chunk`` words at a time, for leaves too
    large for one plain call (the fold of 2^31 words and more): a chunk at
    flat offset ``o`` weighs its word j by ``2*(o + j) + 1``, so

        D(x) = sum_c [D(x_c) + 2 * o_c * S(x_c)]   (mod 2^32)

    with ``S`` the plain sum of the chunk's bits.  A 0-d int32 tensor."""
    if chunk < 1:
        raise ValueError(f"chunks of {chunk} words")
    bits = _bits(x)
    acc = 0
    for o in range(0, bits.numel(), chunk):
        part = bits[o : o + chunk]
        s = int((part.to(torch.int64) & _M32).sum())
        acc = (acc + int(digest_plain(part)) + 2 * o * s) & _M32
    return torch.tensor(_signed(acc), dtype=torch.int32, device=x.device)


def tree_digest_plain(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``tree_digest`` in plain PyTorch: an int32 tensor of one digest a
    leaf, on the first leaf's device."""
    if not leaves:
        raise ValueError("tree_digest_plain needs at least one leaf")
    return torch.stack([digest_plain(x).to(leaves[0].device) for x in leaves])


def combine(digests: Iterable[int]) -> int:
    """Fold leaf digests in order: ``acc = acc * 1000003 + d`` mod 2^32,
    returned as the signed int32 the reference's ``int(tree_digest(...))``
    gives."""
    acc = 0
    for d in digests:
        acc = (acc * _MIX + d) & _M32
    return _signed(acc)
