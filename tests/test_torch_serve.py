"""The port's LM serving engine against the reference's, on the same weights.

``ServeLoop`` on the reduced qwen3-4b and gemma3-27b, on the reduced MoE
(llama4-scout, dbrx) and VLM (internvl2) models, and on the reduced rwkv6,
recurrentgemma (griffin) and whisper (float32, CPU), must give the
reference ``ServeLoop``'s token ids exactly, on the mixed-length and
empty-prompt requests of ``tests/test_serve.py`` (whisper's with zero cross
caches, as the reference's ``ServeLoop`` takes no frames);
``make_prefill_step`` must match on last logits (absolute 1e-4: float32
sums in another order, logits of order 1) and cache shapes.  Griffin and
whisper run at unit q and k spread (``tests/test_torch_models.py::_unit_qk``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from test_torch_models import _inputs, _pair  # noqa: E402

CPU = torch.device("cpu")
LOGITS_ATOL = 1e-4
MOE_VLM = ["llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b"]
OTHERS = ["rwkv6-3b", "recurrentgemma-2b", "whisper-base"]


def _requests(cls, vocab: int):
    """tests/test_serve.py's mixed lengths in one chunk, then the same with
    an empty prompt in front (an implicit BOS 0)."""
    rng = np.random.default_rng(7)
    reqs = [
        cls(rid=i, prompt=rng.integers(1, vocab, ln).astype(np.int32), max_new=4)
        for i, ln in enumerate([3, 7, 5, 2])
    ]
    return reqs, [cls(rid=9, prompt=np.array([], np.int32), max_new=3)] + reqs


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"] + MOE_VLM + OTHERS)
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


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b"] + MOE_VLM + OTHERS)
def test_prefill_step_matches(arch):
    cfg, jcfg, params, jparams = _pair(arch, seed=0)
    b, t = 2, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    jbatch, batch = _inputs(cfg, tokens)
    jlast, jcache = jax.jit(jengine.make_prefill_step(jcfg))(jparams, jbatch)
    last, cache = engine.make_prefill_step(cfg)(params, batch)
    assert tuple(last.shape) == (b, cfg.vocab)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=LOGITS_ATOL)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()
    }
    if treg.family_module(cfg) is transformer:
        assert tuple(cache["k"].shape) == (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.hd)
    full, _ = treg.family_module(cfg).forward(cfg, params, batch)
    np.testing.assert_array_equal(last.numpy(), full[:, -1].numpy())


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b"] + MOE_VLM + OTHERS)
def test_prefill_step_returns_logits_of_their_own(arch):
    """The prefill step's last logits hold B·V elements in storage of their
    own, not a view that keeps the whole (B, S, V) logits alive, and they
    are the last row of the forward pass's logits bit for bit (the values
    against the reference: ``test_prefill_step_matches``; the tokens:
    ``test_serve_loop_gives_the_references_tokens``)."""
    cfg, _, params, _ = _pair(arch, seed=0)
    b, t = 2, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    _, batch = _inputs(cfg, tokens)
    last, _ = engine.make_prefill_step(cfg)(params, batch)
    assert last.untyped_storage().nbytes() == b * cfg.vocab * last.element_size()
    assert last.is_contiguous() and last.storage_offset() == 0
    full, _ = treg.family_module(cfg).forward(cfg, params, batch)
    np.testing.assert_array_equal(last.numpy(), full[:, -1].numpy())


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"] + MOE_VLM + OTHERS)
def test_serve_step_decode_matches_prefill(arch):
    """Teacher-forced ``serve_step`` reproduces the prefill's logits at
    every position (tests/test_serve.py's decode-against-forward check;
    whisper's decode starts from the cross cache of a prefill on the same
    frames, as there).  A MoE model runs at capacity ``n_experts / top_k``,
    where the prefill drops no token: at the default 1.25 it drops tokens
    that one-token decode never drops, and the two differ by design (the
    reference's test raises the factor to 8.0 for that reason)."""
    cfg, _, params, _ = _pair(arch, seed=7)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    b, t = 2, 10
    mod = treg.family_module(cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    _, batch = _inputs(cfg, tokens)
    want, _ = mod.forward(cfg, params, batch)
    cache = mod.init_cache(cfg, b, t, torch.float32, CPU)
    if cfg.family == "encdec":
        _, pre = mod.prefill(cfg, params, dict(batch, tokens=batch["tokens"][:, :1]))
        cache["cross_k"], cache["cross_v"] = pre["cross_k"], pre["cross_v"]
    tokens = batch["tokens"]
    step = engine.make_serve_step(cfg)
    for pos in range(t):
        logits, cache = step(params, tokens[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(logits.numpy(), want[:, pos].numpy(), atol=LOGITS_ATOL)
