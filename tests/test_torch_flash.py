"""K9's plain version and the port's model attention against the reference.

``flash_attention_plain`` (``repro_torch.kernels.flash_attention``) against
the reference's Pallas K9 run in interpret mode, at every case of
``tests/test_flash_kernel.py`` and the fully masked rows, and on permuted
views of the models' (B, S, H, D) layout; the kernel wrapper's layout
check; the port's
``models.layers.flash_attention`` (its CPU path, the chunked online softmax)
against the reference's at ragged lengths, windows, a non-zero ``q_offset``
and explicit ``k_positions``.  Inputs come from numpy with a fixed seed.

Tolerances: float32 at 2e-5, the reference's own for K9 (sums in another
order); bfloat16 at 2e-2, one rounding of the output and of p.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_k9  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_ATOL, BF16_ATOL = 2e-5, 2e-2


def _mk(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, sq, d)).astype(np.float32),
        rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
        rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
    )


def _both(q, k, v, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (
        tuple(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        tuple(torch.from_numpy(x).to(td) for x in (q, k, v)),
    )


# (b, h, kvh, sq, sk, d, window, causal, dtype): tests/test_flash_kernel.py's
# causal sweep, windows, non-causal and bf16 cases, then the fully masked rows
# (causal, window 64, Sq 256 > Sk 128: rows 191 and up see no key)
CASES = [
    (1, 4, 2, 256, 256, 64, 0, True, "f32"),
    (2, 4, 4, 128, 128, 128, 0, True, "f32"),
    (1, 8, 1, 256, 256, 64, 0, True, "f32"),
    (1, 2, 2, 384, 384, 128, 0, True, "f32"),
    (1, 4, 2, 256, 256, 64, 64, True, "f32"),
    (1, 4, 2, 256, 256, 64, 128, True, "f32"),
    (1, 4, 2, 256, 256, 64, 1024, True, "f32"),
    (1, 2, 1, 128, 128, 64, 0, False, "f32"),
    (1, 4, 2, 128, 128, 128, 0, True, "bf16"),
    (1, 4, 2, 256, 128, 64, 64, True, "f32"),
    (1, 4, 2, 256, 128, 64, 64, True, "bf16"),
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,causal,dtype", CASES)
def test_plain_matches_reference_k9(b, h, kvh, sq, sk, d, window, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(*_mk(7, b, h, kvh, sq, sk, d), dtype)
    want = jax_k9(jq, jk, jv, window=window, causal=causal, interpret=True)
    got = k_flash.flash_attention(tq, tk, tv, window=window, causal=causal)  # CPU: plain
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, h, sq, d)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol
    )


# (b, h, kvh, sq, sk, d, window, causal, dtype): the LM path's call in
# miniature (GQA, a global and a local layer), non-causal cross-attention
# and ragged lengths across a 128-row and a 128-key tile edge, which the
# reference's Pallas K9 does not take (its blocks must divide the lengths):
# there its oracle ``ref.flash_attention`` stands in
VIEW_CASES = [
    (2, 4, 2, 256, 256, 64, 0, True, "f32"),
    (2, 4, 2, 256, 256, 64, 96, True, "f32"),
    (1, 4, 4, 96, 384, 32, 0, False, "f32"),
    (1, 4, 2, 200, 333, 64, 0, True, "f32"),
    (2, 4, 2, 256, 256, 64, 96, True, "bf16"),
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,causal,dtype", VIEW_CASES)
def test_plain_on_model_layout_views_matches_reference_k9(b, h, kvh, sq, sk, d, window, causal,
                                                          dtype):  # fmt: skip
    """q, k, v made in the models' (B, S, H, D) layout and handed over as
    permuted (B, H, S, D) views, as ``layers.flash_attention`` hands them to
    the kernel on the card, against the reference's K9 on the same values in
    its own layout."""
    rng = np.random.default_rng(17)
    qm, km, vm = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))  # fmt: skip
    (jq, jk, jv), _ = _both(*(np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (qm, km, vm)),
                           dtype)  # fmt: skip
    if sq % min(sq, 128) or sk % min(sk, 128):
        want = jref.flash_attention(jq, jk, jv, window=window, causal=causal)
    else:
        want = jax_k9(jq, jk, jv, window=window, causal=causal, interpret=True)
    _, (tq, tk, tv) = _both(qm, km, vm, dtype)
    views = [t.permute(0, 2, 1, 3) for t in (tq, tk, tv)]
    assert not any(t.is_contiguous() for t in views)
    got = k_flash.flash_attention(*views, window=window, causal=causal)  # CPU: plain
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, h, sq, d)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def _layout_case(kind):
    """A (B, H, S, D) tensor of one layout kind, and the refusal expected."""
    if kind == "contiguous":
        return torch.zeros(2, 4, 64, 32), None
    if kind == "model view":  # (B, S, H, D) seen as (B, H, S, D)
        return torch.zeros(2, 64, 4, 32).permute(0, 2, 1, 3), None
    if kind == "padded rows":  # rows of 40 elements, 32 used: 80-byte strides in bf16
        return torch.zeros(2, 4, 64, 40, dtype=torch.bfloat16)[..., :32], None
    if kind == "size-1 dims":  # any stride where there is one index
        return torch.zeros(1, 64, 4, 32).permute(0, 2, 1, 3)[:, :1], None
    if kind == "strided last dim":
        return torch.zeros(2, 4, 64, 64)[..., ::2], "contiguous in its last dim"
    if kind == "odd row stride":  # rows of 36 elements: not a multiple of 8
        return torch.zeros(2, 4, 64, 36)[..., :32], "multiple of 8"
    if kind == "expanded head":
        return torch.zeros(2, 1, 64, 32).expand(2, 4, 64, 32), "multiple of 8"
    if kind == "misaligned start":  # 4 bf16 = 8 bytes in
        return torch.zeros(2 * 4 * 64 * 32 + 4, dtype=torch.bfloat16)[4:].view(2, 4, 64, 32), (
            "16-byte boundary"
        )
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind",
    ["contiguous", "model view", "padded rows", "size-1 dims", "strided last dim",
     "odd row stride", "expanded head", "misaligned start"],
)  # fmt: skip
def test_layout_check_takes_model_views_and_refuses_the_rest(kind):
    """``layout_problem``, the kernel wrapper's check before any launch: the
    last dim contiguous, every other stride (of a dim longer than 1) a
    positive multiple of 8 elements, the start 16-byte aligned.  Every
    refusal says "contiguous", as the card test of refusals expects."""
    t, why = _layout_case(kind)
    got = k_flash.layout_problem(tuple(t.shape), t.stride(), t.data_ptr())
    if why is None:
        assert got is None
        dense = [t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], t.shape[3]]
        assert k_flash._plane_strides(t) == [
            st if n > 1 else dn for n, st, dn in zip(t.shape[:3], t.stride()[:3], dense)
        ]
    else:
        assert why in got and ("contiguous" in got or why == "16-byte boundary")


def test_plain_averages_v_where_a_row_sees_no_key():
    q, k, v = _mk(3, 1, 4, 2, 256, 128, 64)
    got = k_flash.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), window=64)
    mean = np.repeat(v.mean(axis=2), 2, axis=1)  # (1, 4, 64): kv head h // 2
    for row in (191, 255):
        np.testing.assert_allclose(got[:, :, row].numpy(), mean, atol=F32_ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention(*map(jnp.asarray, (q, k, v)), window=64)),
        atol=F32_ATOL,
    )  # fmt: skip


def _layout(q, k, v, kvh):
    """The models' layout: q (B, S, KV, G, D); k, v (B, S, KV, D)."""
    b, h, sq, d = q.shape
    qm = q.reshape(b, kvh, h // kvh, sq, d).transpose(0, 3, 1, 2, 4)
    return qm, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)


# (sq, sk, window, causal, q_offset, k_positions, chunk_q, chunk_k)
LAYER_CASES = [
    (256, 256, 0, True, 0, None, 128, 128),
    (200, 200, 0, True, 0, None, 64, 48),
    (137, 137, 32, True, 0, None, 64, 64),
    (90, 130, 0, False, 0, None, 32, 64),
    (64, 200, 50, True, 136, None, 32, 64),
    (50, 77, 16, True, 40, "ring", 32, 32),
]


@pytest.mark.parametrize("sq,sk,window,causal,q_offset,kpos,chunk_q,chunk_k", LAYER_CASES)
def test_layer_attention_matches_reference(sq, sk, window, causal, q_offset, kpos, chunk_q,
                                           chunk_k):  # fmt: skip
    kvh, g, d = 2, 2, 32
    q, k, v = _layout(*_mk(11, 2, kvh * g, kvh, sq, sk, d), kvh)
    k_positions = None
    if kpos == "ring":  # a ring cache: some slots empty (-1), the rest out of order
        k_positions = np.random.default_rng(5).permutation(sk).astype(np.int32) + q_offset - sk
        k_positions[::7] = -1
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk_q=chunk_q, chunk_k=chunk_k)
    want = jlayers.flash_attention(
        *map(jnp.asarray, (q, k, v)),
        k_positions=None if k_positions is None else jnp.asarray(k_positions), **kw,
    )  # fmt: skip
    got = tlayers.flash_attention(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)),
        k_positions=None if k_positions is None else torch.from_numpy(k_positions), **kw,
    )  # fmt: skip
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_layer_attention_equals_k9_plain_on_the_models_call():
    """The models' call (q_offset 0, no key positions, Sq == Sk) is K9's
    function: the chunked softmax and K9's plain version agree."""
    kvh, g, d, s = 2, 2, 64, 256
    q, k, v = _mk(13, 1, kvh * g, kvh, s, s, d)
    want = k_flash.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), window=64)
    qm, km, vm = (torch.from_numpy(np.ascontiguousarray(x)) for x in _layout(q, k, v, kvh))
    got = tlayers.flash_attention(qm, km, vm, window=64, chunk_q=128, chunk_k=128)
    got = got.permute(0, 2, 3, 1, 4).reshape(1, kvh * g, s, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)


def test_kernel_route_refuses_tensors_off_the_card():
    """The kernel's wrapper launches or raises: CPU tensors never reach the
    plain version through it, and nothing launches."""
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1, 2, 1, 32, 32, 16))
    before = k_flash.launches
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        k_flash.flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        _build.on_card("flash_attention", q.device)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        k_flash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert k_flash.launches == before
    if not torch.cuda.is_available():
        from repro_torch.serve.engine import ServeLoop

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeLoop(None, None, batch_size=1, max_len=4)


def test_negative_window_is_refused_on_every_route():
    """K9 masks only for a window > 0 and the plain version for any window
    but 0, so the router refuses a negative window rather than let the two
    routes give different answers."""
    q, k, v = (torch.from_numpy(x) for x in _mk(2, 1, 2, 1, 32, 32, 16))
    with pytest.raises(ValueError, match="window >= 0"):
        k_flash.flash_attention(q, k, v, window=-8)
    want = k_flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(k_flash.flash_attention(q, k, v, window=0), want, rtol=0, atol=0)
