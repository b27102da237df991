"""K9: online-softmax GQA attention, a CUDA kernel, with its plain version.

``flash_attention`` routes by device: a CPU tensor goes to
``flash_attention_plain``, a CUDA tensor to ``flash_attention_kernel``,
which launches ``csrc/flash_attention.cu`` or raises.  The kernel replaces
the TPU kernel ``repro.kernels.flash_attention.flash_attention`` (body
``_flash_kernel``); the plain version is a twin of its oracle
``repro.kernels.ref.flash_attention``.

Shapes (the reference's): q ``(B, H, Sq, D)``, k and v ``(B, KVH, Sk, D)``,
``H = KVH * G``; head ``bh`` of the flattened ``B*H`` reads kv head
``(bh % H) // G + (bh // H) * KVH``.  Scores are ``q . k`` in float32 times
the scale (``D ** -0.5`` by default); the query at row ``i`` sees the key
at column ``j`` where ``j <= i`` (causal) and ``j > i - window``
(``window > 0``); the other scores are ``-1e30``, so a row that sees no key
averages V over all ``Sk`` keys.  P is cast to V's dtype before the PV
product, which sums in float32; the output is cast to q's dtype.

Layout: the kernel reads q, k and v through their strides and writes an
output laid out as q is (``torch.empty_like``), so a ``(B, H, S, D)``
view permuted from the models' ``(B, S, H, D)`` tensors needs no copy.
``layout_problem`` says what it takes: the last dim contiguous, every other
stride a multiple of 8 elements, the start 16-byte aligned.

Under autograd: ``K9Attention`` takes the models' layout, launches K9 for
the forward pass, and for the backward pass returns ``attention_vjp``: the
gradient of the reference models' chunked online softmax
(``models.layers._chunked_attention``), recomputed in PyTorch ops from the
saved q, k and v.  That is the one place where the training path runs the
attention in PyTorch ops on the card, and it is what the JAX package does
too: its models never call the Pallas kernel, and training differentiates
the chunked jnp attention, so the backward pass there runs outside any
Pallas kernel as well.  There is no backward kernel to port.  The forward
pass on the card is always K9.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256

# launches of the kernel in this process; reset by whoever reads it
launches = 0

_fn = None


_STRIDE_UNIT = 8  # elements: 16-byte rows in bf16, as TMA needs


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_attention").flash_attention
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i, i, i, i, i, i, i, i, f, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def layout_problem(shape, strides, address: int) -> str | None:
    """Why the kernel cannot read a tensor of this shape, these strides (in
    elements) and this start address in place, or None if it can.  Dims of
    size 1 take any stride."""
    if shape[-1] > 1 and strides[-1] != 1:
        return f"must be contiguous in its last dim, got strides {tuple(strides)}"
    for n, st in zip(shape[:-1], strides[:-1]):
        if n > 1 and (st <= 0 or st % _STRIDE_UNIT):
            return (
                f"must be read as contiguous rows of 16 bytes: every stride but the last a "
                f"positive multiple of {_STRIDE_UNIT} elements, got strides {tuple(strides)}"
            )
    if address % 16:
        return "must start on a 16-byte boundary"
    return None


def _plane_strides(t: torch.Tensor) -> list[int]:
    """``t``'s strides of dims (b, head, s); a dim of size 1 gets the stride
    a contiguous tensor would have there, which TMA takes."""
    dense = [t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], t.shape[3]]
    return [st if n > 1 else dn for n, st, dn in zip(t.shape[:3], t.stride()[:3], dense)]


def _require(what: str, name: str, t: torch.Tensor, dtype, shape: tuple, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(
            f"{what}: {name} must be a {dtype} tensor of shape {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    why = layout_problem(tuple(t.shape), t.stride(), t.data_ptr())
    if why is not None:
        raise ValueError(f"{what}: {name} {why}")


def _shapes(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"{what}: q must be (B, H, Sq, D) and k, v one (B, KVH, Sk, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh < 1 or h % kvh:
        raise ValueError(f"{what}: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    return b, h, kvh, sq, sk, d


def _window(what: str, window: int) -> None:
    # The kernel masks only for window > 0, the plain version for any window
    # but 0: a negative one would make the two routes disagree.
    if window < 0:
        raise ValueError(f"{what} takes a window >= 0 (0: none), got {window}")


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """K9 on the card: the attention output ``(B, H, Sq, D)`` in q's dtype,
    a new tensor laid out as q is.  Takes float32 or bfloat16 (all three
    alike) in any layout that ``layout_problem`` passes, ``Sq, Sk >= 1``
    and ``D`` a multiple of 16 up to 256."""
    global launches
    what = "flash_attention"
    dev = q.device
    _build.on_card(what, dev)
    b, h, kvh, sq, sk, d = _shapes(what, q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    if sq < 1 or sk < 1 or b < 1:
        raise ValueError(f"{what} needs B, Sq, Sk >= 1, got {b}, {sq}, {sk}")
    if d % 16 or not 16 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"{what} takes a head dim that is a multiple of 16 up to 256, got {d}")
    _window(what, window)
    _require(what, "q", q, q.dtype, (b, h, sq, d), dev)
    _require(what, "k", k, q.dtype, (b, kvh, sk, d), dev)
    _require(what, "v", v, q.dtype, (b, kvh, sk, d), dev)
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    out = torch.empty_like(q)  # q's layout where q is dense, else contiguous: both pass
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in _plane_strides(t)))
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _DTYPES[q.dtype], b, h, kvh, sq, sk, d, int(window), int(bool(causal)),
            float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), stream,
        )  # fmt: skip
    _build.check(rc, f"{what} launch")
    launches += 1
    return out


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """The same attention in plain PyTorch, on any device: the direct
    softmax over every key (no tiling), in float32 from the inputs' values."""
    b, h, kvh, sq, sk, d = _shapes("flash_attention_plain", q, k, v)
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    qg = q.reshape(b, kvh, g, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """K9 for a CUDA tensor, its plain version for a CPU one."""
    _window("flash_attention", window)
    kw = dict(window=window, causal=causal, softmax_scale=softmax_scale)
    if q.device.type == "cuda":
        return flash_attention_kernel(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention: no kernel or plain version for device {q.device}")


class K9Attention(torch.autograd.Function):
    """The models' attention on the card under autograd.  Takes q
    ``(B, Sq, KVH, G, D)`` and k, v ``(B, Sk, KVH, D)`` and returns
    ``(B, Sq, KVH, G, D)``.  The forward pass hands K9 ``(B, H, S, D)`` views
    of the inputs, no copies; the backward pass is ``attention_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        b, sq, kvh, g, d = q.shape
        # .contiguous() copies only a tensor that is not dense in its own
        # (B, S, ., D) layout; the permutes are views
        qh = q.contiguous().reshape(b, sq, kvh * g, d).permute(0, 2, 1, 3)
        kh = k.contiguous().permute(0, 2, 1, 3)
        vh = v.contiguous().permute(0, 2, 1, 3)
        out = flash_attention(qh, kh, vh, window=window, causal=causal, softmax_scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        # (B, H, Sq, D), dense as (B, Sq, H, D): the reshape is a view
        return out.permute(0, 2, 1, 3).reshape(b, sq, kvh, g, d)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_vjp(q, k, v, dout, *ctx.args), None, None, None)


def attention_vjp(q, k, v, dout, causal: bool, window: int, scale: float):
    """``(dq, dk, dv)``: the gradient of the models' attention at q
    ``(B, Sq, KVH, G, D)``, k, v ``(B, Sk, KVH, D)`` (query offset 0, the
    models' 512-row chunks) for the output cotangent ``dout``, by autograd
    through the reference's chunked online softmax recomputed in PyTorch ops:
    ``jax.vjp`` of ``repro.models.layers.flash_attention``."""
    # models.layers imports this module, so it is imported here, on first use
    from repro_torch.models.layers import _chunked_attention

    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = _chunked_attention(*inputs, causal, window, 0, None, 512, 512, scale)
        return torch.autograd.grad(out, inputs, dout)
