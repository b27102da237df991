"""The port's MoE layer against the reference's, on the same weights.

``layers.moe_fwd`` of both packages on the reduced llama4-scout (top-1 of
4 experts, a shared expert) and dbrx (top-2 of 4, no shared expert), in
float32 on the CPU: at capacities that drop tokens, with two dispatch
groups, and where the router ties.  Weights and inputs are drawn from a
seed with numpy and carried into both packages.

Tolerance, absolute: 1e-5 on outputs up to about 5 in size (float32
products summed in another order; 7e-7 seen); the experts chosen, and so
the tokens dropped, must be equal.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

MOE_ATOL = 1e-5
CPU = torch.device("cpu")


def _moe_params(cfg, seed: int) -> dict:
    """A MoE block's params as numpy arrays at the reference's spreads."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (rng.standard_normal(spec.shape) / np.sqrt(fan_in)).astype(np.float32)

    return tlayers.tree_map(leaf, tlayers.moe_specs(cfg))


def _x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _both(cfg, params: dict, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    want = jlayers.moe_fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), cfg)
    got = tlayers.moe_fwd(params_from_numpy(params, CPU), torch.from_numpy(x), cfg)
    return got.numpy(), np.asarray(want)


def _dropped(cfg, params: dict, x: np.ndarray) -> int:
    """(token, choice) pairs over their expert's capacity, counted from the
    reference's routing."""
    g = max(cfg.dispatch_groups, 1)
    t = x.shape[0] * x.shape[1]
    tg, e, k = t // g, cfg.n_experts, cfg.top_k
    cap = max(int(tg * k / e * cfg.capacity_factor), 4)
    logits = jnp.einsum("gtd,de->gte", x.reshape(g, tg, -1), params["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    counts = np.stack([np.bincount(np.asarray(row).ravel(), minlength=e) for row in idx])
    return int(np.maximum(counts - cap, 0).sum())


CASES = [  # arch, dispatch_groups, capacity_factor
    ("llama4-scout-17b-a16e", 1, 1.0),
    ("llama4-scout-17b-a16e", 2, 1.0),
    ("dbrx-132b", 1, 1.0),
    ("dbrx-132b", 2, 1.0),
]


@pytest.mark.parametrize("arch,groups,factor", CASES)
def test_moe_fwd_matches_the_reference_where_tokens_drop(arch, groups, factor):
    cfg = dataclasses.replace(get_config(arch).reduced(), dispatch_groups=groups,
                              capacity_factor=factor)  # fmt: skip
    assert (cfg.top_k, cfg.shared_expert) in ((1, True), (2, False))
    params = _moe_params(cfg, seed=3)
    x = _x(cfg, 2, 24, seed=4)
    assert _dropped(cfg, params, x) > 0
    got, want = _both(cfg, params, x)
    np.testing.assert_allclose(got, want, atol=MOE_ATOL)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "dbrx-132b"])
@pytest.mark.parametrize("tie", ["all experts", "two columns"])
def test_router_ties_break_as_the_reference(arch, tie):
    """A zero router ties every expert (every token picks experts 0..k-1,
    so they overflow); two equal router columns tie experts 1 and 2 for
    every token.  The port's choices must be ``jax.lax.top_k``'s: the lower
    index first."""
    cfg = get_config(arch).reduced()
    params = _moe_params(cfg, seed=5)
    if tie == "all experts":
        params["router"][:] = 0.0
    else:
        params["router"][:, 2] = params["router"][:, 1]
    x = _x(cfg, 2, 16, seed=6)
    xt = x.reshape(1, 32, cfg.d_model)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.einsum("gtd,de->gte", xt, params["router"])),
                            cfg.top_k)  # fmt: skip
    _, got = tlayers.moe_route(torch.from_numpy(params["router"]), torch.from_numpy(xt),
                               cfg.top_k)  # fmt: skip
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = got.numpy().reshape(-1, cfg.top_k).tolist()
    if tie == "all experts":
        assert all(row == list(range(cfg.top_k)) for row in rows)
    else:  # expert 2 never without expert 1 before it, and the tie decided some
        assert all(1 in row[: row.index(2)] for row in rows if 2 in row)
        assert any(1 in row for row in rows)
    got_out, want_out = _both(cfg, params, x)
    np.testing.assert_allclose(got_out, want_out, atol=MOE_ATOL)


def test_moe_dispatch_groups_parity():
    """tests/test_perf_levers.py's check, on the port: at capacity 8.0 no
    token drops, so two dispatch groups give the one group's logits (atol
    2e-4, the reference's), and each equals the reference's forward within
    1e-4 (float32 through the layers)."""
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), remat=False,
                              capacity_factor=8.0)  # fmt: skip
    jcfg = dataclasses.replace(jax_config("dbrx-132b").reduced(), remat=False,
                               capacity_factor=8.0)  # fmt: skip
    jparams = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, cfg.vocab))
    mod = treg.family_module(cfg)
    o1, _ = mod.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    o2, _ = mod.forward(dataclasses.replace(cfg, dispatch_groups=2), params,
                        {"tokens": torch.from_numpy(toks)})  # fmt: skip
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-4)
    jmod = jreg.family_module(jcfg)
    for groups, got in ((1, o1), (2, o2)):
        want, _ = jmod.forward(dataclasses.replace(jcfg, dispatch_groups=groups), jparams,
                               {"tokens": jnp.asarray(toks)})  # fmt: skip
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_moe_rejects_tokens_that_do_not_split_into_groups():
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), dispatch_groups=3)
    params = params_from_numpy(_moe_params(cfg, seed=1), CPU)
    with pytest.raises(ValueError, match="dispatch groups"):
        tlayers.moe_fwd(params, torch.zeros(2, 5, cfg.d_model), cfg)
