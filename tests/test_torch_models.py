"""The port's models against the reference's, on the same weights.

The reference's ``init_params`` draws the weights; ``params_from_numpy``
carries them into the port.  ``forward``, ``prefill`` and ``decode_step``
of the reduced models of every family (dense, MoE and the VLM backbone,
with its patch prefix; rwkv6, griffin and whisper, with seeded frames) run
in float32 on the CPU in both packages, and so does decode on the grouped
ring cache (``ring_local_cache``).  Griffin's and whisper's attention runs
at unit q and k spread (``_unit_qk``).

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
MOE_VLM = ["llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b"]
OTHERS = ["rwkv6-3b", "recurrentgemma-2b", "whisper-base"]
LOGITS_ATOL, CACHE_ATOL = 1e-4, 5e-4
CPU = torch.device("cpu")


def _pair(arch: str, seed: int = 0):
    """(port cfg, reference cfg, port params, reference params), reduced;
    griffin's and whisper's at unit q and k spread (``_unit_qk``)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), remat=False)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=False)
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    if arch in ("recurrentgemma-2b", "whisper-base"):
        jparams, params = _unit_qk(cfg, jparams)
        return cfg, jcfg, params, jparams
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return cfg, jcfg, params, jparams


def _unit_qk(cfg, jparams):
    """The reference's params with every attention's ``wq`` and ``wk``
    scaled by sqrt(heads / d_model), so q and k have unit spread; the port's
    copy of them.  The fan-in rule takes a (d_model, heads, head_dim)
    weight's head count as its fan-in, which makes the reduced models'
    attention near one-hot: then a float32 sum taken in another order grows
    about 6x a layer (at 8 layers, or behind a prefix of unit-normal
    patches, both packages end up 2e-3 from each other and from a wider
    run), and no tolerance can tell a right port from a wrong one.
    ``chip_smoke.py``'s ``lm_params`` does the same at full width."""

    def scaled(tree):
        if not isinstance(tree, dict):
            return tree
        out = {key: scaled(sub) for key, sub in tree.items()}
        if "wq" in tree and "wk" in tree:  # an attention's (..., d_model, heads, head_dim)
            for name in ("wq", "wk"):
                scale = np.sqrt(tree[name].shape[-2] / cfg.d_model)
                out[name] = (tree[name] * scale).astype(tree[name].dtype)
        return out

    jparams = scaled(jax.tree_util.tree_map(np.asarray, jparams))
    return jax.tree_util.tree_map(jnp.asarray, jparams), params_from_numpy(jparams, CPU)


def _inputs(cfg, tokens: np.ndarray, seed: int = 8) -> tuple[dict, dict]:
    """The reference's and the port's batch of ``tokens``, whisper's with
    seeded frames."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        shape = (tokens.shape[0], cfg.src_len, cfg.d_model)
        batch["frames"] = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})  # fmt: skip


def _close_cache(cache: dict, jcache: dict) -> None:
    """Every entry of a cache against the reference's: same keys, shapes and
    dtypes, int32 positions exactly, the rest within ``CACHE_ATOL``."""
    assert set(cache) == set(jcache)
    for key, t in cache.items():
        assert tuple(t.shape) == jcache[key].shape and str(t.dtype)[6:] == str(jcache[key].dtype)
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[key]), err_msg=key)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[key]), atol=CACHE_ATOL,
                                       err_msg=key)  # fmt: skip


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


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + OTHERS)
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


@pytest.mark.parametrize("arch", DENSE + MOE_VLM)
def test_window_schedule_matches(arch):
    from repro.models import transformer as jtransformer

    for cfg in (get_config(arch), get_config(arch).reduced()):
        want = np.asarray(jtransformer.window_schedule(cfg)).tolist()
        assert transformer.window_schedule(cfg) == want


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + OTHERS)
def test_forward_and_prefill_match(arch):
    cfg, jcfg, params, jparams = _pair(arch)
    tokens = _tokens(cfg, 2, 19)
    jbatch, batch = _inputs(cfg, tokens)
    jmod = jreg.family_module(jcfg)
    want, _ = jmod.forward(jcfg, jparams, jbatch)
    mod = treg.family_module(cfg)
    got, none = mod.forward(cfg, params, batch)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)

    jlogits, jcache = jmod.prefill(jcfg, jparams, jbatch)
    logits, cache = mod.prefill(cfg, params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    if mod is transformer:
        assert set(cache) == {"k", "v", "kpos"}
    _close_cache(cache, jcache)


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + OTHERS)
def test_decode_steps_match(arch):
    """Teacher-forced decode past a ring wrap: a cache of 12 slots for 16
    positions, so the last four steps evict the oldest keys (griffin's
    attention ring holds ``min(12, local_window)`` = 8 slots; whisper's
    cross cache is its prefill's, of seeded frames)."""
    cfg, jcfg, params, jparams = _pair(arch, seed=2)
    b, steps, slots = 2, 16, 12
    tokens = _tokens(cfg, b, steps, seed=3)
    jmod, mod = jreg.family_module(jcfg), treg.family_module(cfg)
    jcache = jmod.init_cache(jcfg, b, slots, jnp.float32)
    cache = mod.init_cache(cfg, b, slots, torch.float32, CPU)
    if cfg.family == "encdec":
        jbatch, batch = _inputs(cfg, tokens[:, :1])
        _, jpre = jmod.prefill(jcfg, jparams, jbatch)
        _, pre = mod.prefill(cfg, params, batch)
        for key in ("cross_k", "cross_v"):
            jcache[key] = jpre[key]
            cache[key].copy_(pre[key])
    jstep = jax.jit(lambda p, t, c, pos: jmod.decode_step(jcfg, p, t, c, pos))
    for t in range(steps):
        want, jcache = jstep(jparams, jnp.asarray(tokens[:, t : t + 1]), jcache, jnp.int32(t))
        got, cache = mod.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]), cache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL,
                                   err_msg=str(t))  # fmt: skip
    _close_cache(cache, jcache)


@pytest.mark.parametrize("arch", OTHERS)
def test_every_family_maps_to_its_module(arch):
    """rwkv6, griffin and whisper: the registry's module, its ``CACHE_AXES``
    and ``init_params`` on the CPU in the reference's tree."""
    from repro_torch.models import griffin, rwkv6, whisper

    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    mod = treg.family_module(cfg)
    assert mod is {"ssm": rwkv6, "hybrid": griffin, "encdec": whisper}[cfg.family]
    assert mod.CACHE_AXES == jreg.family_module(jcfg).CACHE_AXES
    params = treg.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), jreg.param_shapes(jcfg))
    assert tlayers.tree_map(lambda t: tuple(t.shape), params) == want


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + OTHERS)
def test_attention_calls_count_a_prefills_attention(arch, monkeypatch):
    """``registry.attention_calls`` (K9's launches in a prefill on the card)
    is the number of attention calls a prefill makes: one a transformer
    layer, one a griffin superblock, none in rwkv6, one an encoder and two a
    decoder layer in whisper."""
    cfg = get_config(arch).reduced()
    calls, plain = [], tlayers.flash_attention

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(tlayers, "flash_attention", counted)
    params = treg.init_params(cfg, torch.Generator().manual_seed(0))
    _, batch = _inputs(cfg, np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)))
    treg.family_module(cfg).prefill(cfg, params, batch)
    assert len(calls) == treg.attention_calls(cfg)


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


@pytest.mark.parametrize("arch", DENSE + MOE_VLM)
def test_transformer_families_map_to_the_transformer(arch):
    from repro.models import transformer as jtransformer

    assert treg.family_module(get_config(arch)) is transformer
    assert transformer.CACHE_AXES == jtransformer.CACHE_AXES


def test_vlm_patch_prefix_matches():
    """internvl2 with seeded patch embeddings: the logits of the tokens
    alone, a prefill cache that holds the prefix (positions from the first
    patch), and decode that goes on from that cache, against the reference.  q and k at unit spread
    (``_unit_qk``)."""
    cfg, jcfg, _, jparams = _pair("internvl2-76b", seed=4)
    jparams, params = _unit_qk(cfg, jparams)
    b, s, p = 2, 11, cfg.n_patches
    tokens = _tokens(cfg, b, s + 3, seed=5)
    patches = np.random.default_rng(6).standard_normal((b, p, cfg.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :s]), "patches": jnp.asarray(patches)}
    batch = {"tokens": torch.from_numpy(tokens[:, :s]), "patches": torch.from_numpy(patches)}
    jmod = jreg.family_module(jcfg)
    want, _ = jmod.forward(jcfg, jparams, jbatch)
    got, _ = transformer.forward(cfg, params, batch)
    assert tuple(got.shape) == (b, s, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    jlogits, jpre = jmod.prefill(jcfg, jparams, jbatch)
    logits, pre = transformer.prefill(cfg, params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    assert tuple(pre["k"].shape) == (cfg.n_layers, b, p + s, cfg.n_kv_heads, cfg.hd)
    for key in ("k", "v"):
        np.testing.assert_allclose(pre[key].numpy(), np.asarray(jpre[key]), atol=CACHE_ATOL)
    np.testing.assert_array_equal(pre["kpos"].numpy(), np.asarray(jpre["kpos"]))
    # three more tokens decoded after the prefix and the prompt, on a cache
    # of p + s + 3 slots that starts as the prefill's
    n = p + s
    jcache = jmod.init_cache(jcfg, b, n + 3, jnp.float32)
    jcache = {key: jcache[key].at[:, :, :n].set(jpre[key]) for key in jcache}
    cache = transformer.init_cache(cfg, b, n + 3, torch.float32, CPU)
    for key in cache:
        cache[key][:, :, :n] = pre[key]
    for t in range(s, s + 3):
        want, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t : t + 1]),
                                        jcache, jnp.int32(p + t))  # fmt: skip
        got, cache = transformer.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                             cache, p + t)  # fmt: skip
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL,
                                   err_msg=str(t))  # fmt: skip


@pytest.mark.parametrize("arch", ["internvl2-76b", "llama4-scout-17b-a16e"] + OTHERS)
def test_moe_and_vlm_inputs_match_the_reference_specs(arch):
    """Every cell's inputs, the VLM's patch and whisper's frame embeddings
    and each family's decode cache among them; and ``make_inputs`` draws
    them at those shapes and dtypes."""
    from repro_torch.configs import SHAPES

    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in SHAPES.values():
        want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                      jreg.input_specs(jcfg, shape))  # fmt: skip
        got = tlayers.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                               treg.input_specs(cfg, shape))  # fmt: skip
        assert got == want, shape.name
    small = dataclasses.replace(SHAPES["train_4k"], seq_len=8, global_batch=2)
    made = treg.make_inputs(cfg.reduced(), small, torch.Generator().manual_seed(0))
    want = treg.input_specs(cfg.reduced(), small)
    frontend = {"vlm": {"patches"}, "encdec": {"frames"}}.get(cfg.family, set())
    assert set(made) == set(want) == {"tokens", "labels"} | frontend
    for name, t in made.items():
        assert t.shape == want[name].shape and t.dtype == want[name].dtype, name
    for name in frontend:
        assert made[name].std().item() > 0.5


def _ring_pair():
    """tests/test_perf_levers.py's ring config: gemma3 reduced to 8 layers,
    a global layer every 3 (two superblocks and a remainder of 2 local
    layers) and a 4-slot window; q and k at unit spread (``_unit_qk``)."""
    kw = dict(remat=False, ring_local_cache=True, local_window=4, global_every=3, n_layers=8)
    jcfg = dataclasses.replace(jax_config("gemma3-27b").reduced(), **kw)
    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(), **kw)
    jparams, params = _unit_qk(cfg, jreg.init_params(jcfg, jax.random.PRNGKey(5)))
    return cfg, jcfg, params, jparams


def test_grouped_ring_cache_matches_forward():
    """Teacher-forced decode on the grouped cache, 12 positions through
    4-slot rings: each step's logits against the port's forward (5e-3, the
    reference test's bound) and the reference's decode (``LOGITS_ATOL``);
    after the last step every cache entry against the reference's
    (``CACHE_ATOL`` on keys and values, positions exactly)."""
    cfg, jcfg, params, jparams = _ring_pair()
    b, t_len = 2, 12
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(5), (b, t_len), 0, cfg.vocab))
    ref, _ = transformer.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jmod = jreg.family_module(jcfg)
    jcache = jmod.init_cache(jcfg, b, t_len, jnp.float32)
    cache = transformer.init_cache(cfg, b, t_len, torch.float32, CPU)
    assert set(cache) == set(jcache) == {"lk", "lv", "lkp", "gk", "gv", "gkp", "rk", "rv", "rkp"}
    for t in range(t_len):
        want, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t : t + 1]), jcache,
                                        jnp.int32(t))  # fmt: skip
        got, cache = transformer.decode_step(cfg, params, torch.from_numpy(tokens[:, t : t + 1]),
                                             cache, t)  # fmt: skip
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL,
                                   err_msg=str(t))  # fmt: skip
        np.testing.assert_allclose(got[:, 0].numpy(), ref[:, t].numpy(), atol=5e-3)
    assert cache["lk"].shape[3] == 4 < t_len  # the rings wrapped
    for key, got in cache.items():
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(jcache[key]), err_msg=key)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(jcache[key]), atol=CACHE_ATOL,
                                       err_msg=key)  # fmt: skip


def test_regrouped_blocks_are_views():
    cfg, _, params, _ = _ring_pair()
    loc, glob, rems = transformer._regroup_blocks(cfg, params["blocks"])
    wq = params["blocks"]["attn"]["wq"]
    assert loc["attn"]["wq"].shape[:2] == (2, 2) and rems["attn"]["wq"].shape[0] == 2
    for tree in (loc, glob, rems):
        assert tree["attn"]["wq"].untyped_storage().data_ptr() == wq.untyped_storage().data_ptr()
    torch.testing.assert_close(loc["attn"]["wq"][1, 0], wq[3], rtol=0, atol=0)
    torch.testing.assert_close(glob["attn"]["wq"][1], wq[5], rtol=0, atol=0)
    torch.testing.assert_close(rems["attn"]["wq"][1], wq[7], rtol=0, atol=0)


def test_grouped_cache_is_smaller():
    """gemma3-27b's grouped cache at batch 128 and 32k: over 4x smaller
    (about 5.3x for 5:1 local:global), and shaped as the reference's."""
    import math

    cfg = dataclasses.replace(get_config("gemma3-27b"), ring_local_cache=True)
    jcfg = dataclasses.replace(jax_config("gemma3-27b"), ring_local_cache=True)
    base = transformer.cache_specs(dataclasses.replace(cfg, ring_local_cache=False), 128, 32768)
    grp = transformer.cache_specs(cfg, 128, 32768)
    want = jreg.family_module(jcfg).cache_specs(jcfg, 128, 32768)
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in grp.items()} == {
        k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()
    }
    assert all(t.device.type == "meta" for t in grp.values())

    def nbytes(sp):
        return sum(math.prod(t.shape) * t.element_size() for t in sp.values())

    assert nbytes(base) / nbytes(grp) > 4.0
