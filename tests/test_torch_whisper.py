"""The port's whisper against the reference's, on the CPU.

``layers.sinusoidal_pos`` and the decode step's ``_pos_embed_at``; the
encoder on float32 frames over bf16 weights, where JAX promotes the encoder
to float32 (the port casts where JAX promotes); ``layers.attention_fwd``
with ``kv_override`` (the cross-attention: keys and values as given, no
projection, no rope on them, ``qk_norm`` still applied); and the reduced
model's prefill, whose cache keeps the cross keys and values, with decode
going on from it.

Tolerances, absolute: 1e-6 on the position embeddings, plus one float32
ulp of the largest angle (``_pos_atol``); ``LOGITS_ATOL`` 1e-4 and
``CACHE_ATOL`` 5e-4 in float32, as ``tests/test_torch_models.py``; 2e-5 on
the float32 encoder over bf16 weights (outputs of order 1: float32 sums in
another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
POS_ATOL, LOGITS_ATOL, CACHE_ATOL, ENC_ATOL = 1e-6, 1e-4, 5e-4, 2e-5
ARCH = "whisper-base"


def _close(got, want, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, err_msg=what)  # fmt: skip


def _pair(seed: int = 0, dtype: str = "float32"):
    """The reduced model in both packages on the reference's weights, every
    attention's ``wq`` and ``wk`` (the encoder's, the decoder's and the
    cross-attention's) scaled by sqrt(heads / d_model) so that q and k have
    unit spread: ``tests/test_torch_models.py::_unit_qk`` says why."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), remat=False, dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=False, dtype=dtype)
    jparams = jax.tree_util.tree_map(np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(seed)))
    for stack, attn in (("enc", "attn"), ("dec", "attn"), ("dec", "cross")):
        tree = dict(jparams[stack][attn])
        for name in ("wq", "wk"):
            scale = np.sqrt(tree[name].shape[2] / cfg.d_model)
            tree[name] = (tree[name].astype(np.float32) * scale).astype(tree[name].dtype)
        jparams[stack] = dict(jparams[stack], **{attn: tree})
    params = params_from_numpy(jparams, CPU, getattr(torch, dtype))
    return cfg, jcfg, params, jax.tree_util.tree_map(jnp.asarray, jparams)


def _pos_atol(largest: int) -> float:
    """1e-6, plus one float32 ulp of the largest angle (position ``largest``
    at dim 0): sines computed by two libraries differ by up to that much
    (5.5e-6 seen at 106 rad, whose ulp is 7.6e-6)."""
    return POS_ATOL + largest * 2.0**-23


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    shape = (b, cfg.src_len, cfg.d_model)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("seq,d,offset", [(16, 64, 0), (1500, 512, 0), (7, 33, 440)])
def test_sinusoidal_pos_matches(seq, d, offset):
    want = np.asarray(jlayers.sinusoidal_pos(seq, d, offset))
    got = tlayers.sinusoidal_pos(seq, d, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, _pos_atol(offset + seq))


@pytest.mark.parametrize("pos", [0, 1, 17, 447])
def test_pos_embed_at_matches(pos):
    want = np.asarray(jwhisper._pos_embed_at(jnp.int32(pos), 64))
    got = whisper._pos_embed_at(pos, 64)
    assert tuple(got.shape) == want.shape == (1, 1, 64)
    _close(got, want, _pos_atol(pos))
    _close(got[0], tlayers.sinusoidal_pos(1, 64, pos), _pos_atol(pos))


def test_encode_promotes_float32_frames_over_bf16_weights():
    """bf16 weights, float32 frames: JAX rounds the frames to bf16, adds the
    float32 positions (promoting to float32) and runs the encoder in
    float32; the port's encoder must give float32 of the same values."""
    cfg, jcfg, params, jparams = _pair(seed=1, dtype="bfloat16")
    assert params["enc"]["attn"]["wq"].dtype == torch.bfloat16
    frames = _frames(cfg, 2, 1)
    want = jwhisper.encode(jcfg, jparams, jnp.asarray(frames))
    got = whisper.encode(cfg, params, torch.from_numpy(frames))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, ENC_ATOL)
    # bf16 frames stay in bf16, as in the reference
    half = torch.from_numpy(frames).to(torch.bfloat16)
    assert whisper.encode(cfg, params, half).dtype == torch.bfloat16


@pytest.mark.parametrize("qk_norm,use_rope", [(False, False), (True, True)])
def test_attention_with_kv_override_matches(qk_norm, use_rope):
    """Cross-attention on keys and values given from elsewhere (Sk = 13,
    Sq = 6): no projection, no rope on them, ``qk_norm`` on them where set."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), qk_norm=qk_norm)
    rng = np.random.default_rng(4)
    p = tlayers.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        tlayers.attention_specs(cfg),
    )
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    kk = rng.standard_normal((2, 13, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    vv = rng.standard_normal((2, 13, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    want, (wk, wv) = jlayers.attention_fwd(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg, causal=False,
        use_rope=use_rope, kv_override=(jnp.asarray(kk), jnp.asarray(vv)),
    )  # fmt: skip
    got, (gk, gv) = tlayers.attention_fwd(
        params_from_numpy(p, CPU), torch.from_numpy(x), cfg, causal=False, use_rope=use_rope,
        kv_override=(torch.from_numpy(kk), torch.from_numpy(vv)),
    )  # fmt: skip
    _close(got, want, LOGITS_ATOL)
    _close(gk, wk, LOGITS_ATOL)
    _close(gv, wv, 0)
    if not qk_norm:
        torch.testing.assert_close(gk, torch.from_numpy(kk), rtol=0, atol=0)


def test_prefill_keeps_the_cross_cache_and_decode_reads_it():
    """The reduced model's prefill against the reference's: logits, the
    self-attention cache and the cross keys and values, (L, B, src_len,
    KVH, D), computed once a layer from the encoder output; then decode of
    three more tokens on a cache that starts as the prefill's, against the
    reference's decode (``tests/test_serve.py``'s ``test_decode_matches_forward``
    seeds the cross cache the same way)."""
    cfg, jcfg, params, jparams = _pair(seed=2)
    b, s = 2, 9
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    frames = _frames(cfg, b, 2)
    jbatch = {"tokens": jnp.asarray(tokens[:, :s]), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(tokens[:, :s]), "frames": torch.from_numpy(frames)}
    jlogits, jcache = jwhisper.prefill(jcfg, jparams, jbatch)
    logits, cache = whisper.prefill(cfg, params, batch)
    _close(logits, jlogits, LOGITS_ATOL)
    assert set(cache) == set(jcache) == {"k", "v", "kpos", "cross_k", "cross_v"}
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, b, cfg.src_len, cfg.n_kv_heads, cfg.hd)
    for key, t in cache.items():
        assert tuple(t.shape) == jcache[key].shape, key
        _close(t, jcache[key], 0 if t.dtype == torch.int32 else CACHE_ATOL, key)
    enc = whisper.encode(cfg, params, batch["frames"])
    ck = torch.einsum("bfd,dhk->bfhk", enc, params["dec"]["cross"]["wk"][1])
    torch.testing.assert_close(cache["cross_k"][1], ck, rtol=0, atol=0)

    jc = jwhisper.init_cache(jcfg, b, s + 3, jnp.float32)
    jc = {key: jc[key].at[:, :, : jcache[key].shape[2]].set(jcache[key]) for key in jc}
    dc = whisper.init_cache(cfg, b, s + 3, torch.float32, CPU)
    for key in dc:
        dc[key][:, :, : cache[key].shape[2]] = cache[key]
    for t in range(s, s + 3):
        want, jc = jwhisper.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t : t + 1]), jc,
                                        jnp.int32(t))  # fmt: skip
        got, dc = whisper.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]), dc, t)
        _close(got, want, LOGITS_ATOL, str(t))
    for key, t in dc.items():
        _close(t, jc[key], 0 if t.dtype == torch.int32 else CACHE_ATOL, key)
