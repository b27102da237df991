"""K4: the snapshot seal's digest, a CUDA kernel, with its plain version.

``digest`` launches ``csrc/digest.cu``, which replaces the TPU kernel
``repro.kernels.digest.digest``: the weighted fold

    digest = sum_i  bits(x_i) * (2*i + 1)   (mod 2^32)

over the flat 32-bit pattern of an int32 or float32 array (floats are
bit-cast).  Odd weights make it position-sensitive.  ``digest_plain`` is
the same fold in plain PyTorch; ``combine`` folds leaf digests the way the
reference's ``tree_digest`` does.  Only 4-byte dtypes are accepted: the
reference's fold of 16-bit inputs is not well defined.
"""

from __future__ import annotations

import ctypes
from collections.abc import Iterable

import torch

from . import _build

_DTYPES = (torch.int32, torch.float32)
_M32 = 0xFFFFFFFF
_MIX = 1000003  # the reference's polynomial combine constant
_THREADS = 256
_BLOCKS_PER_SM = 8  # resident blocks per multiprocessor for the grid-stride loop

# launches of the kernel in this process; reset by whoever reads it
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("digest").digest
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"digest takes int32 or float32 arrays, got {x.dtype}")
    flat = x.reshape(-1)
    return flat if flat.dtype == torch.int32 else flat.view(torch.int32)


def _signed(u: int) -> int:
    u &= _M32
    return u - (1 << 32) if u >= 1 << 31 else u


def digest(x: torch.Tensor) -> torch.Tensor:
    """The fold on the card; returns a 0-d int32 tensor on ``x``'s device."""
    global launches
    _build.on_card("digest", x.device)
    bits = _bits(x).contiguous()
    n = bits.numel()
    out = torch.zeros((1,), dtype=torch.int32, device=x.device)
    max_blocks = torch.cuda.get_device_properties(x.device).multi_processor_count * _BLOCKS_PER_SM
    blocks = max(1, min(max_blocks, -(-n // _THREADS)))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(bits.data_ptr(), n, out.data_ptr(), blocks, stream)
    _build.check(rc, "digest launch")
    launches += 1
    return out[0]


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


def combine(digests: Iterable[int]) -> int:
    """Fold leaf digests in order: ``acc = acc * 1000003 + d`` mod 2^32,
    returned as the signed int32 the reference's ``int(tree_digest(...))``
    gives."""
    acc = 0
    for d in digests:
        acc = (acc * _MIX + d) & _M32
    return _signed(acc)
