"""The port's rwkv6 against the reference's, on the CPU.

The WKV recurrence from a non-zero state, the time-mix (token shift, the
LoRA decay, the bonus ``1 + u``, ``ln_x``) from a non-zero state, and the
channel-mix, on seeded numpy inputs at the reference's spreads; then the
reduced model (4 layers, 4 heads of 16) on the reference's weights: the
prefill cache, whose ``x_tm`` and ``x_cm`` are each layer's last *raw*
inputs to its time-mix and channel-mix, and decode that goes on from it.

Tolerances, absolute, float32: 1e-5 on the recurrence's outputs and states
(of order 1 to 10: products summed in another order, step by step as the
reference's ``lax.scan``); ``LOGITS_ATOL`` 1e-4 on logits, as
``tests/test_torch_models.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
WKV_ATOL, LOGITS_ATOL = 1e-5, 1e-4
ARCH = "rwkv6-3b"


def _normal(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, err_msg=what)


def _block(cfg, seed: int) -> dict:
    """One layer's params as numpy arrays: normal leaves at the fan-in rule's
    spread, the token-shift factors, ``w0``, ``u`` and the norms' weights
    drawn too (the reference initialises them to 0, which would hide a
    token shift or a bonus the wrong way round)."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init == "zeros":
            return _normal(rng, *spec.shape, scale=0.5)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return _normal(rng, *spec.shape, scale=fan_in**-0.5)

    return tlayers.tree_map(leaf, rwkv6.block_specs(cfg))


def test_wkv_scan_from_a_state_matches():
    cfg = get_config(ARCH).reduced()
    h, hd = cfg.n_heads, cfg.rwkv_head_dim
    rng = np.random.default_rng(0)
    r, k, v = (_normal(rng, 2, 9, h, hd, scale=0.5) for _ in range(3))
    w = rng.uniform(0.2, 1.0, (2, 9, h, hd)).astype(np.float32)
    u, s0 = _normal(rng, h, hd), _normal(rng, 2, h, hd, hd)
    want_y, want_s = jrwkv6._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    got_y, got_s = rwkv6._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    assert tuple(got_y.shape) == (2, 9, h, hd) and tuple(got_s.shape) == (2, h, hd, hd)
    _close(got_y, want_y, WKV_ATOL)
    _close(got_s, want_s, WKV_ATOL)


@pytest.mark.parametrize("t", [1, 7])
def test_time_mix_from_a_state_matches(t):
    cfg = get_config(ARCH).reduced()
    h, hd = cfg.n_heads, cfg.rwkv_head_dim
    p = _block(cfg, 1)["tm"]
    rng = np.random.default_rng(t)
    x, xprev = _normal(rng, 2, t, cfg.d_model), _normal(rng, 2, t, cfg.d_model)
    s0 = _normal(rng, 2, h, hd, hd)
    want, want_s = jrwkv6._time_mix(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                    jnp.asarray(xprev), cfg, jnp.asarray(s0))  # fmt: skip
    got, got_s = rwkv6._time_mix(params_from_numpy(p, CPU), torch.from_numpy(x),
                                 torch.from_numpy(xprev), cfg, torch.from_numpy(s0))  # fmt: skip
    _close(got, want, WKV_ATOL)
    _close(got_s, want_s, WKV_ATOL)


def test_channel_mix_matches():
    cfg = get_config(ARCH).reduced()
    p = _block(cfg, 2)["cm"]
    rng = np.random.default_rng(2)
    x, xprev = _normal(rng, 2, 5, cfg.d_model), _normal(rng, 2, 5, cfg.d_model)
    want = jrwkv6._channel_mix(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                               jnp.asarray(xprev))  # fmt: skip
    got = rwkv6._channel_mix(params_from_numpy(p, CPU), torch.from_numpy(x),
                             torch.from_numpy(xprev))  # fmt: skip
    _close(got, want, WKV_ATOL)


def _pair(seed: int):
    """The reduced model in both packages on the reference's weights, with
    every layer's token-shift factors, ``w0``, ``u`` and norms drawn (see
    ``_block``)."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), remat=False)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=False)
    jparams = jax.tree_util.tree_map(np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(seed)))
    layers = [_block(cfg, seed * 100 + i) for i in range(cfg.n_layers)]
    jparams["blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *layers)
    return cfg, jcfg, params_from_numpy(jparams, CPU), jax.tree_util.tree_map(jnp.asarray, jparams)


def test_prefill_cache_keeps_the_raw_last_inputs_and_decode_goes_on():
    """The prefill cache against the reference's: the WKV states, and
    ``x_tm``/``x_cm`` equal to each layer's last raw (un-normalised) inputs,
    which the port's layer loop shows directly; then three decode steps from
    that cache against the reference's, and against the port's prefill of
    the longer sequence."""
    cfg, jcfg, params, jparams = _pair(seed=3)
    b, s = 2, 11
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    jlogits, jcache = jrwkv6.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens[:, :s])})
    logits, cache = rwkv6.prefill(cfg, params, {"tokens": torch.from_numpy(tokens[:, :s])})
    _close(logits, jlogits, LOGITS_ATOL)
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        k: tuple(t.shape) for k, t in jcache.items()
    }
    for key in ("s", "x_tm", "x_cm"):
        _close(cache[key], jcache[key], LOGITS_ATOL, key)
    # the raw inputs: layer i's time-mix input is the residual after layer i - 1
    x = params["embed"][torch.from_numpy(tokens[:, :s])]
    for i in range(cfg.n_layers):
        blk = tlayers.tree_map(lambda a, i=i: a[i], params["blocks"])
        last = x[:, -1]
        x, _, x_in, x_mid = rwkv6._block(cfg, x, blk)
        torch.testing.assert_close(x_in, last, rtol=0, atol=0)
        torch.testing.assert_close(cache["x_tm"][i], x_in, rtol=0, atol=0)
        torch.testing.assert_close(cache["x_cm"][i], x_mid, rtol=0, atol=0)
    full, _ = rwkv6.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    for t in range(s, s + 3):
        want, jcache = jrwkv6.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t : t + 1]),
                                          jcache, jnp.int32(t))  # fmt: skip
        got, same = rwkv6.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                      cache, t)  # fmt: skip
        assert same is cache and tuple(got.shape) == (b, 1, cfg.vocab)
        _close(got, want, LOGITS_ATOL, str(t))
        _close(got[:, 0], full[:, t].detach(), LOGITS_ATOL, str(t))
    for key in ("s", "x_tm", "x_cm"):
        _close(cache[key], jcache[key], LOGITS_ATOL, key)


def test_cache_specs_match():
    cfg = get_config(ARCH).reduced()
    want = jrwkv6.cache_specs(cfg, 3)
    got = rwkv6.cache_specs(cfg, 3)
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == {
        k: (tuple(t.shape), str(t.dtype)) for k, t in want.items()
    }
    assert rwkv6.CACHE_AXES == jrwkv6.CACHE_AXES
    zeros = rwkv6.init_cache(cfg, 3, device=CPU)
    assert all(bool((t == 0).all()) for t in zeros.values())
