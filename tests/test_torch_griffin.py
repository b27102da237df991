"""The port's griffin (recurrentgemma) against the reference's, on the CPU.

The recurrent pieces on seeded numpy inputs: the depthwise causal conv with
and without a carried state; the RG-LRU with and without an initial state,
at odd and even T; the ported associative scan against
``jax.lax.associative_scan``; the gelu and softplus forms.  Then the whole
model, reduced to 8 layers (two superblocks and the 2 remainder rec layers,
as the full 26-layer model has), on the reference's weights: forward,
prefill and its cache, decode through the 8-slot attention ring, and the
reference's ring-cache test.

Tolerances, absolute, float32: 1e-6 on the conv and the scan (the same
products and sums in the same order; XLA may fuse a multiply-add); 1e-5 on
the RG-LRU (its two projections summed in another order, values of order
1); ``LOGITS_ATOL`` 1e-4 on logits and ``CACHE_ATOL`` 5e-4 on cached keys,
values and states (of order 1 to 30), as ``tests/test_torch_models.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import griffin  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
EXACT_ATOL, LRU_ATOL = 1e-6, 1e-5
LOGITS_ATOL, CACHE_ATOL = 1e-4, 5e-4
ARCH = "recurrentgemma-2b"


def _pair(seed: int = 0, **kw):
    """(port cfg, reference cfg, port params, reference params): the reduced
    model at 8 layers unless ``kw`` says otherwise, float32, no remat; the
    attention blocks' ``wq`` and ``wk`` scaled by sqrt(heads / d_model), so
    q and k have unit spread (``tests/test_torch_models.py::_unit_qk``: at
    the fan-in rule's spread, here 1 for ``wk`` of one kv head, the keys
    reach 30 and the attention is near one-hot, where float32 sums taken in
    another order part both packages by 1e-4 within a few decode steps)."""
    kw = {"n_layers": 8, "remat": False, **kw}
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(seed)))
    attn = dict(jparams["super"]["attn"]["attn"])
    for name in ("wq", "wk"):
        attn[name] = attn[name] * np.float32(np.sqrt(attn[name].shape[2] / cfg.d_model))
    blocks = dict(jparams["super"]["attn"], attn=attn)
    jparams = dict(jparams, super=dict(jparams["super"], attn=blocks))
    params = params_from_numpy(jparams, CPU)
    return cfg, jcfg, params, jax.tree_util.tree_map(jnp.asarray, jparams)


def _normal(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rec_params(cfg, rng) -> dict:
    """One rec block's mixer params at the reference's spreads, a random conv
    kernel and a spread of ``lam``."""
    d, dr, w = cfg.d_model, cfg.d_rnn, cfg.conv_width
    return {
        "w_gate": _normal(rng, d, dr, scale=d**-0.5),
        "w_x": _normal(rng, d, dr, scale=d**-0.5),
        "conv": _normal(rng, w, dr, scale=0.5),
        "w_a": _normal(rng, dr, dr, scale=dr**-0.5),
        "w_i": _normal(rng, dr, dr, scale=dr**-0.5),
        "lam": _normal(rng, dr),
        "w_o": _normal(rng, dr, d, scale=dr**-0.5),
    }


def _close(got, want, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, err_msg=what)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(1)
    u, kernel = _normal(rng, 2, 7, 5), _normal(rng, 4, 5)
    state = _normal(rng, 2, 3, 5) if with_state else None
    want, want_state = jgriffin._causal_conv(
        jnp.asarray(u), jnp.asarray(kernel), None if state is None else jnp.asarray(state)
    )
    got, got_state = griffin._causal_conv(
        torch.from_numpy(u), torch.from_numpy(kernel),
        None if state is None else torch.from_numpy(state),
    )  # fmt: skip
    _close(got, want, EXACT_ATOL)
    _close(got_state, want_state, 0)
    assert tuple(got_state.shape) == (2, 3, 5)


@pytest.mark.parametrize("t", [1, 2, 5, 8, 13, 64])
def test_assoc_scan_matches_jax(t):
    """The ported recursion against ``jax.lax.associative_scan`` with the
    reference's combine, on decays in (0, 1) and inputs of order 1."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.05, 1.0, (3, t, 4)).astype(np.float32)
    b = _normal(rng, 3, t, 4)

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]

    want_a, want_b = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got_a, got_b = griffin._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got_a, want_a, EXACT_ATOL)
    _close(got_b, want_b, EXACT_ATOL)
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    h, seq = np.zeros((3, 4), np.float64), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    np.testing.assert_allclose(got_b.numpy(), np.stack(seq, 1), atol=1e-5)


@pytest.mark.parametrize("t", [6, 7])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches(t, with_h0):
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(2 + t)
    p = _rec_params(cfg, rng)
    u = _normal(rng, 2, t, cfg.d_rnn)
    h0 = _normal(rng, 2, cfg.d_rnn) if with_h0 else None
    want, want_last = jgriffin._rg_lru(
        jnp.asarray(u), jax.tree_util.tree_map(jnp.asarray, p),
        None if h0 is None else jnp.asarray(h0),
    )  # fmt: skip
    got, got_last = griffin._rg_lru(
        torch.from_numpy(u), params_from_numpy(p, CPU),
        None if h0 is None else torch.from_numpy(h0),
    )  # fmt: skip
    assert got.dtype == torch.float32 and got_last.dtype == torch.float32
    assert tuple(got.shape) == (2, t, cfg.d_rnn) and tuple(got_last.shape) == (2, cfg.d_rnn)
    _close(got, want, LRU_ATOL)
    _close(got_last, want_last, LRU_ATOL)


def test_gelu_is_the_tanh_form_and_softplus_is_logaddexp():
    """At inputs of a few units the erf gelu (``F.gelu``'s default) is up to
    2e-4 from the tanh form that ``jax.nn.gelu`` computes; the port's is the
    latter.  ``jax.nn.softplus`` is ``logaddexp(x, 0)``: the port's matches
    it from -100 to 100; ``F.softplus`` returns x itself above 20, which a
    float64 input shows (softplus(25) = 25 + 1.4e-11)."""
    x = np.array([-3.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 3.0], np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = griffin._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4
    s = np.array([-100.0, -20.0, -3.0, 0.0, 0.7, 15.0, 20.0, 21.0, 100.0], np.float32)
    np.testing.assert_allclose(griffin._softplus(torch.from_numpy(s)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(s))), rtol=1e-6,
                               atol=1e-30)  # fmt: skip
    big = torch.tensor([25.0], dtype=torch.float64)
    assert float(F.softplus(big)) == 25.0
    assert float(griffin._softplus(big)) == pytest.approx(25.0 + np.log1p(np.exp(-25.0)), abs=0)


def test_layout_and_specs_match():
    for n_layers in (6, 8, 26):
        cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
        assert griffin._layout(cfg) == jgriffin._layout(cfg)
    cfg, jcfg, params, _ = _pair()
    assert griffin._layout(cfg) == (2, 2)
    assert set(params) == {"embed", "super", "ln_f", "rem_rec"}
    assert params["super"]["rec"]["w_a"].shape[:2] == (2, 2)
    assert params["rem_rec"]["w_a"].shape[0] == 2
    assert griffin.CACHE_AXES == jgriffin.CACHE_AXES


def test_forward_prefill_and_cache_match():
    """The 8-layer model: logits of forward and prefill, and every cache
    entry (the superblocks' conv and recurrence states, keys, values and
    positions, the remainder's states) against the reference's."""
    cfg, jcfg, params, jparams = _pair(seed=3)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 19)).astype(np.int32)
    want, _ = jgriffin.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got, none = griffin.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert none is None
    _close(got, want, LOGITS_ATOL)
    jlogits, jcache = jgriffin.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    logits, cache = griffin.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    _close(logits, jlogits, LOGITS_ATOL)
    assert set(cache) == set(jcache)
    for key, t in cache.items():
        assert tuple(t.shape) == jcache[key].shape, key
        assert str(t.dtype)[6:] == str(jcache[key].dtype), key
        _close(t, jcache[key], 0 if t.dtype == torch.int32 else CACHE_ATOL, key)


def test_decode_through_the_ring_matches():
    """Teacher-forced decode of 14 positions on a cache of 10 positions, so
    the attention ring holds ``min(10, local_window)`` = 8 slots and wraps:
    each step's logits and the final cache against the reference's."""
    cfg, jcfg, params, jparams = _pair(seed=4)
    b, steps = 2, 14
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (b, steps)).astype(np.int32)
    jcache = jgriffin.init_cache(jcfg, b, 10, jnp.float32)
    cache = griffin.init_cache(cfg, b, 10, torch.float32, CPU)
    assert cache["k"].shape[2] == cfg.local_window == 8
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in cache.items()} == {
        k: (tuple(t.shape), str(t.dtype)) for k, t in jcache.items()
    }
    assert bool((cache["kpos"] == -1).all())
    jstep = jax.jit(lambda p, t, c, pos: jgriffin.decode_step(jcfg, p, t, c, pos))
    for t in range(steps):
        want, jcache = jstep(jparams, jnp.asarray(tokens[:, t : t + 1]), jcache, jnp.int32(t))
        got, cache = griffin.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                         cache, t)  # fmt: skip
        _close(got, want, LOGITS_ATOL, str(t))
    for key, t in cache.items():
        _close(t, jcache[key], 0 if t.dtype == torch.int32 else CACHE_ATOL, key)


def test_ring_cache_sliding_window_decode():
    """tests/test_serve.py's ring-cache test on the port: the reduced model
    (6 layers), B=1, 12 decode steps on an 8-slot ring, against the port's
    forward (5e-3, the reference test's bound) and the reference's decode
    (``LOGITS_ATOL``)."""
    cfg, jcfg, params, jparams = _pair(seed=2, n_layers=6)
    key = jax.random.PRNGKey(2)
    b, t_len = 1, 12
    tokens = np.asarray(jax.random.randint(key, (b, t_len), 0, cfg.vocab)).astype(np.int32)
    ref, _ = griffin.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    c = max(cfg.local_window, 8)
    jcache = jgriffin.init_cache(jcfg, b, c, jnp.float32)
    cache = griffin.init_cache(cfg, b, c, torch.float32, CPU)
    outs = []
    for t in range(t_len):
        want, jcache = jgriffin.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t : t + 1]),
                                            jcache, jnp.int32(t))  # fmt: skip
        got, cache = griffin.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                         cache, t)  # fmt: skip
        _close(got, want, LOGITS_ATOL, str(t))
        outs.append(got.reshape(b, -1))
    err = (torch.stack(outs, 1) - ref).abs().max().item()
    assert err < 5e-3, err
    assert int(cache["kpos"].min()) == t_len - c  # the ring wrapped


def test_init_cache_means_the_card_by_default():
    cfg = get_config(ARCH).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            griffin.init_cache(cfg, 1, 8)
