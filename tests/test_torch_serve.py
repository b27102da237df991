"""The port's LM serving engine against the reference's, on the same weights.

``ServeLoop`` on the reduced qwen3-4b and gemma3-27b, and on the reduced
MoE (llama4-scout, dbrx) and VLM (internvl2) models (float32, CPU), must
give the reference ``ServeLoop``'s token ids exactly, on the mixed-length
and empty-prompt requests of ``tests/test_serve.py``; ``make_prefill_step``
must match on last logits (absolute 1e-4: float32 sums in another order,
logits of order 1) and cache shapes.
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
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

CPU = torch.device("cpu")
LOGITS_ATOL = 1e-4
MOE_VLM = ["llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b"]


def _pair(arch: str, seed: int):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), remat=False)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=False)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return cfg, jcfg, params, jparams


def _requests(cls, vocab: int):
    """tests/test_serve.py's mixed lengths in one chunk, then the same with
    an empty prompt in front (an implicit BOS 0)."""
    rng = np.random.default_rng(7)
    reqs = [
        cls(rid=i, prompt=rng.integers(1, vocab, ln).astype(np.int32), max_new=4)
        for i, ln in enumerate([3, 7, 5, 2])
    ]
    return reqs, [cls(rid=9, prompt=np.array([], np.int32), max_new=3)] + reqs


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"] + MOE_VLM)
def test_serve_loop_gives_the_references_tokens(arch):
    cfg, jcfg, params, jparams = _pair(arch, seed=1)
    jreqs, jmixed = _requests(jengine.Request, cfg.vocab)
    reqs, mixed = _requests(engine.Request, cfg.vocab)
    for want_reqs, got_reqs in ((jreqs, reqs), (jmixed, mixed)):
        want = jengine.ServeLoop(jcfg, jparams, batch_size=4, max_len=16).run(want_reqs)
        loop = engine.ServeLoop(cfg, params, batch_size=4, max_len=16, device=CPU)
        got = loop.run(got_reqs)
        assert got == want
        assert all(len(got[r.rid]) == r.max_new for r in got_reqs)
    # batched equals each request decoded alone (tests/test_serve.py's invariant)
    solo = engine.ServeLoop(cfg, params, batch_size=4, max_len=16, device=CPU)
    batched = engine.ServeLoop(cfg, params, batch_size=4, max_len=16, device=CPU).run(reqs)
    for r in reqs:
        assert solo.run([r])[r.rid] == batched[r.rid]


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b"] + MOE_VLM)
def test_prefill_step_matches(arch):
    cfg, jcfg, params, jparams = _pair(arch, seed=0)
    b, t = 2, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    jlast, jcache = jax.jit(jengine.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)}
    )
    last, cache = engine.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(last.shape) == (b, cfg.vocab)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=LOGITS_ATOL)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()
    }
    assert tuple(cache["k"].shape) == (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.hd)
    full, _ = transformer.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(last.numpy(), full[:, -1].numpy())


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"] + MOE_VLM)
def test_serve_step_decode_matches_prefill(arch):
    """Teacher-forced ``serve_step`` reproduces the prefill's logits at
    every position (tests/test_serve.py's decode-against-forward check).
    A MoE model runs at capacity ``n_experts / top_k``, where the prefill
    drops no token: at the default 1.25 it drops tokens that one-token
    decode never drops, and the two differ by design (the reference's test
    raises the factor to 8.0 for that reason)."""
    cfg, _, params, _ = _pair(arch, seed=7)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    b, t = 2, 10
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (b, t)))
    want, _ = transformer.forward(cfg, params, {"tokens": tokens})
    cache = transformer.init_cache(cfg, b, t, torch.float32, CPU)
    step = engine.make_serve_step(cfg)
    for pos in range(t):
        logits, cache = step(params, tokens[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(logits.numpy(), want[:, pos].numpy(), atol=LOGITS_ATOL)
