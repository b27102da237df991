"""The port's dense transformer against the reference's, on the same weights.

The reference's ``init_params`` draws the weights; ``params_from_numpy``
carries them into the port.  ``forward``, ``prefill`` and ``decode_step``
of the reduced dense models run in float32 on the CPU in both packages.

Tolerances, absolute: 1e-4 on logits (of order 1) and 5e-4 on the cached
keys and values (of order 10 to 25).  Both are float32 sums taken in
another order through a few layers: about 2e-5 of the values' size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

DENSE = ["qwen3-4b", "gemma3-27b", "yi-9b", "mistral-nemo-12b"]
OTHERS = [
    "rwkv6-3b", "recurrentgemma-2b", "llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b",
    "whisper-base",
]  # fmt: skip
LOGITS_ATOL, CACHE_ATOL = 1e-4, 5e-4
CPU = torch.device("cpu")


def _pair(arch: str, seed: int = 0):
    """(port cfg, reference cfg, port params, reference params), reduced."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), remat=False)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=False)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return cfg, jcfg, params, jparams


def _tokens(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_configs_are_the_references():
    assert list_archs() == jax_archs()
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(
            jax_config(arch).reduced()
        )
        assert get_config(arch).n_params == jax_config(arch).n_params


@pytest.mark.parametrize("arch", DENSE)
def test_param_tree_and_count_match(arch):
    for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                      (get_config(arch).reduced(), jax_config(arch).reduced())):  # fmt: skip
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), jreg.param_shapes(jcfg))
        got = tlayers.tree_map(lambda t: tuple(t.shape), treg.param_shapes(cfg))
        assert got == want
        assert tlayers.axes_tree(treg.model_specs(cfg)) == jreg.param_axes(jcfg)
        assert treg.count_params(cfg) == jreg.count_params(jcfg)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    params = treg.init_params(cfg, torch.Generator().manual_seed(0))
    assert tlayers.tree_map(lambda t: tuple(t.shape), params) == jax.tree_util.tree_map(
        lambda x: x.shape, jparams
    )


def test_init_params_draws_each_leaf_in_chunks_at_its_fan_in_spread(monkeypatch):
    """A leaf larger than a chunk is drawn a chunk at a time into its own
    dtype: the same seed gives the same weights, zeros and ones stay so, and
    each normal leaf has the spread ``scale / sqrt(fan_in)``."""
    cfg = get_config("gemma3-27b").reduced()
    monkeypatch.setattr(tlayers, "_INIT_CHUNK", 1000)
    params = treg.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16)
    again = treg.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16)
    specs = tlayers.tree_leaves(treg.model_specs(cfg))
    leaves, twins = tlayers.tree_leaves(params), tlayers.tree_leaves(again)
    assert any(spec.init == "normal" and np.prod(spec.shape) > 1000 for spec in specs)
    for spec, leaf, twin in zip(specs, leaves, twins):
        assert leaf.dtype == torch.bfloat16 and tuple(leaf.shape) == spec.shape
        assert torch.equal(leaf, twin)
        if spec.init != "normal":
            assert bool((leaf == (spec.init == "ones")).all())
        elif leaf.numel() >= 4096:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / np.sqrt(fan_in)
            assert abs(leaf.float().std().item() / std - 1) < 0.1, spec


@pytest.mark.parametrize("arch", DENSE)
def test_window_schedule_matches(arch):
    from repro.models import transformer as jtransformer

    for cfg in (get_config(arch), get_config(arch).reduced()):
        want = np.asarray(jtransformer.window_schedule(cfg)).tolist()
        assert transformer.window_schedule(cfg) == want


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match(arch):
    cfg, jcfg, params, jparams = _pair(arch)
    tokens = _tokens(cfg, 2, 19)
    jmod = jreg.family_module(jcfg)
    want, _ = jmod.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    mod = treg.family_module(cfg)
    got, none = mod.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)

    jlogits, jcache = jmod.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    logits, cache = transformer.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    assert set(cache) == set(jcache) == {"k", "v", "kpos"}
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), atol=CACHE_ATOL)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match(arch):
    """Teacher-forced decode past a ring wrap: a cache of 12 slots for 16
    positions, so the last four steps evict the oldest keys."""
    cfg, jcfg, params, jparams = _pair(arch, seed=2)
    b, steps, slots = 2, 16, 12
    tokens = _tokens(cfg, b, steps, seed=3)
    jmod = jreg.family_module(jcfg)
    jcache = jmod.init_cache(jcfg, b, slots, jnp.float32)
    cache = transformer.init_cache(cfg, b, slots, torch.float32, CPU)
    jstep = jax.jit(lambda p, t, c, pos: jmod.decode_step(jcfg, p, t, c, pos))
    for t in range(steps):
        want, jcache = jstep(jparams, jnp.asarray(tokens[:, t : t + 1]), jcache, jnp.int32(t))
        got, cache = transformer.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                             cache, t)  # fmt: skip
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL,
                                   err_msg=str(t))  # fmt: skip
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), atol=CACHE_ATOL)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8"):
        treg.family_module(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8"):
        treg.init_params(cfg, torch.Generator().manual_seed(0))


def test_moe_blocks_and_the_ring_cache_raise():
    moe = dataclasses.replace(get_config("qwen3-4b").reduced(), n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="moe_fwd"):
        transformer.specs(moe)
    with pytest.raises(NotImplementedError, match="moe_fwd"):
        tlayers.moe_fwd({}, torch.zeros(1, 1, 64), moe)
    ring = dataclasses.replace(get_config("gemma3-27b").reduced(), ring_local_cache=True)
    with pytest.raises(NotImplementedError, match="ring_local_cache"):
        transformer.init_cache(ring, 1, 8, torch.float32, CPU)
    params = treg.init_params(ring, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ring_local_cache"):
        transformer.decode_step(ring, params, torch.zeros(1, 1, dtype=torch.int64), {}, 0)


def test_init_cache_means_the_card_by_default():
    """``init_cache`` with no device means the card, as ``ServeLoop`` and
    ``PaxosContext`` do: without one it raises, naming ``device='cpu'``.
    Asked for the CPU, it is the reference's empty cache."""
    cfg = get_config("qwen3-4b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            transformer.init_cache(cfg, 1, 8)
    jcfg = jax_config("qwen3-4b").reduced()
    want = jreg.family_module(jcfg).init_cache(jcfg, 1, 8, jnp.float32)
    got = transformer.init_cache(cfg, 1, 8, torch.float32, CPU)
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.device == CPU and t.dtype == (torch.int32 if key == "kpos" else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]))


def test_inputs_match_the_reference_specs():
    from repro_torch.configs import SHAPES

    cfg = get_config("gemma3-27b")
    jcfg = jax_config("gemma3-27b")
    for shape in SHAPES.values():
        want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                      jreg.input_specs(jcfg, shape))  # fmt: skip
        got = tlayers.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                               treg.input_specs(cfg, shape))  # fmt: skip
        assert got == want, shape.name
    small = dataclasses.replace(SHAPES["decode_32k"], seq_len=8, global_batch=2)
    made = treg.make_inputs(cfg.reduced(), small, torch.Generator().manual_seed(0))
    assert tuple(made["tokens"].shape) == (2, 1) and made["pos"] == 0
    assert bool((made["cache"]["kpos"] == -1).all())
