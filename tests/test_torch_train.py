"""The port's training path against the reference's, on the CPU.

Reduced qwen3-4b in float32 (4 layers, d_model 64); the reference draws the
weights and ``models.convert`` carries its train state into the port, so
both start every comparison from the same state.  Inputs come from numpy
with fixed seeds.

Tolerances:
* the optimizer's ``update``, ``schedule`` and ``global_norm``: 1e-6
  relative (float32, sums taken in another order);
* loss: 1e-5 absolute (of order 5); gradients: 2e-5 of each leaf's largest
  entry (float32 sums in another order through four layers: 2.4e-6 seen);
* after a step of AdamW at lr 1e-3: 2e-4 absolute on the params (Adam
  divides each gradient element by its own root mean square, so an element
  whose gradient is near 0 amplifies a last-bit difference: 1.8e-5 seen);
* ``attention_vjp``: 2e-5 absolute (float32, the reference's K9 tolerance);
* ``_grad_digest`` and ``SyntheticStream``: bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import PaxosConfig as JPaxosConfig  # noqa: E402
from repro.core import PaxosContext as JPaxosContext  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as ttl  # noqa: E402
from test_torch_models import _unit_qk  # noqa: E402

CPU = torch.device("cpu")
OPT_RTOL = 1e-6
LOSS_ATOL, GRAD_RTOL, STEP_ATOL, VJP_ATOL = 1e-5, 2e-5, 2e-4, 2e-5
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pair(remat: bool = True, policy: str = "full", seed: int = 0):
    """(port cfg, reference cfg, port state, reference state), reduced
    qwen3-4b in float32, the same weights."""
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(), remat=remat, remat_policy=policy)
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), remat=remat, remat_policy=policy)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, state_from_numpy(_numpy(jstate), CPU), jstate


def _batch(cfg, b: int = 2, s: int = 32, seed: int = 1) -> dict[str, np.ndarray]:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _close_rel(got: torch.Tensor, want, rtol: float, what: str = "") -> None:
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=what)


def _tree(rng, dtype=np.float32) -> dict:
    """A nested param-like tree of rank 1-3 leaves."""
    return {
        "b": {"w": rng.standard_normal((3, 5, 7)).astype(dtype), "a": rng.standard_normal(11)},
        "a": rng.standard_normal((13, 4)).astype(dtype),
        "c": rng.standard_normal((2, 3, 4)).astype(dtype),
    }


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_schedule_and_global_norm_match():
    cfg = topt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    jcfg = jopt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 77):
        got = topt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close_rel(got, jopt.schedule(jcfg, jnp.int32(step)), OPT_RTOL, str(step))
    tree = _tree(np.random.default_rng(0))
    got = topt.global_norm(tlayers.tree_map(lambda x: torch.from_numpy(np.float32(x)), tree))
    _close_rel(got, jopt.global_norm(_jax(tree)), OPT_RTOL)


@pytest.mark.parametrize("count", [0, 3])
def test_optimizer_update_matches(count):
    """One update from a state with moments and a count, float32 params,
    grads both below and above the clip."""
    rng = np.random.default_rng(count)
    params = tlayers.tree_map(np.float32, _tree(rng))
    for gscale in (1e-3, 10.0):
        grads = tlayers.tree_map(lambda x: np.float32(x * gscale), _tree(rng))
        mu = tlayers.tree_map(lambda x: np.float32(x * 1e-3), _tree(rng))
        nu = tlayers.tree_map(lambda x: np.float32(np.abs(x) * 1e-4), _tree(rng))
        jstate = jopt.OptState(_jax(mu), _jax(nu), jnp.int32(count))
        jcfg, cfg = jopt.OptConfig(**OCFG), topt.OptConfig(**OCFG)
        want_p, want_s, want_n = jopt.update(_jax(grads), jstate, _jax(params), jcfg)

        def t(tree):
            return tlayers.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)

        state = topt.OptState(t(mu), t(nu), torch.tensor(count, dtype=torch.int32))
        got_p, got_s, got_n = topt.update(t(grads), state, t(params), cfg)
        _close_rel(got_n, want_n, OPT_RTOL, "grad norm")
        assert int(got_s.count) == int(want_s.count) == count + 1
        for got, want in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
            for g, w in zip(tlayers.tree_leaves(got), jax.tree_util.tree_leaves(want),
                            strict=True):  # fmt: skip
                _close_rel(g, w, OPT_RTOL)


def test_optimizer_keeps_float32_moments_for_bf16_params():
    """bfloat16 params: moments float32, the update computed in float32 and
    cast back; within one bfloat16 rounding of the reference's."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    grads = _tree(rng)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    jgrads = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), grads)
    want_p, want_s, _ = jopt.update(jgrads, jopt.init(jparams), jparams, jopt.OptConfig(**OCFG))
    tparams = tlayers.tree_map(lambda x: torch.from_numpy(np.float32(x)).bfloat16(), params)
    tgrads = tlayers.tree_map(lambda x: torch.from_numpy(np.float32(x)).bfloat16(), grads)
    state = topt.init(tparams)
    assert all(m.dtype == torch.float32 for m in tlayers.tree_leaves(state.mu))
    got_p, got_s, _ = topt.update(tgrads, state, tparams, topt.OptConfig(**OCFG))
    for g, w in zip(tlayers.tree_leaves(got_p), jax.tree_util.tree_leaves(want_p), strict=True):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=2**-8)
    for g, w in zip(tlayers.tree_leaves(got_s.mu), jax.tree_util.tree_leaves(want_s.mu),
                    strict=True):  # fmt: skip
        _close_rel(g, w, OPT_RTOL)


def test_state_shapes_and_axes_match():
    cfg, jcfg = get_config("qwen3-4b"), jax_config("qwen3-4b")
    got = ttl.state_shapes(cfg)
    want = jtl.state_shapes(jcfg)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tlayers.tree_leaves(got)] == [
        (tuple(s.shape), str(s.dtype)) for s in jax.tree_util.tree_leaves(want)
    ]
    assert all(t.device.type == "meta" for t in tlayers.tree_leaves(got))
    assert treg.param_axes(cfg) == jreg.param_axes(jcfg)
    axes, jaxes = ttl.state_axes(cfg), jtl.state_axes(jcfg)
    assert axes.params == jaxes.params and axes.opt.mu == jaxes.opt.mu
    assert axes.opt.count == jaxes.opt.count == () and axes.step == jaxes.step == ()


# ---------------------------------------------------------------------------
# the gradient digest and the data stream: bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grad_digest_is_the_references_bit_for_bit(dtype, seed):
    """Leaves of rank 1-3 in a nested tree; their int32 weighted sums
    overflow int32 many times over, as does the fold across leaves."""
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    tree["z"] = {"big": (rng.standard_normal((64, 96)) * 1e30).astype(np.float32)}
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
    ttree = tlayers.tree_map(lambda x: torch.from_numpy(np.float32(x)).to(getattr(torch, dtype)),
                             tree)  # fmt: skip
    want = int(jtl._grad_digest(jtree))
    got = ttl._grad_digest(ttree)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want


def test_grad_digest_folds_chunks_as_one_leaf(monkeypatch):
    """A leaf taken in many chunks gives the digest of one pass."""
    tree = {"w": torch.from_numpy(np.random.default_rng(5).standard_normal((37, 29)).astype(
        np.float32))}  # fmt: skip
    whole = int(ttl._grad_digest(tree))
    monkeypatch.setattr(ttl, "_DIGEST_CHUNK", 100)
    assert int(ttl._grad_digest(tree)) == whole == int(jtl._grad_digest(_jax(
        {"w": tree["w"].numpy()})))  # fmt: skip


@pytest.mark.parametrize("mode", ["uniform", "arith"])
def test_synthetic_stream_is_the_references_bit_for_bit(mode):
    for stubs in ({}, {"n_patches": 3, "src_len": 5, "d_model": 8}):
        kw = dict(vocab=97, global_batch=3, seq_len=17, seed=4, mode=mode, **stubs)
        got, want = tdata.SyntheticStream(tdata.DataConfig(**kw)), jdata.SyntheticStream(
            jdata.DataConfig(**kw))  # fmt: skip
        for step, (a, b) in enumerate(zip(got, want)):
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key])
                np.testing.assert_array_equal(got.batch_at(step)[key], a[key])
            if step == 3:
                break


# ---------------------------------------------------------------------------
# loss, gradients, steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"), (True, "dots")])
def test_loss_and_gradients_match_value_and_grad(remat, policy):
    """``make_loss_fn`` under ``train_loop.value_and_grad`` against
    ``jax.value_and_grad`` of the reference's, at each remat policy."""
    cfg, jcfg, state, jstate = _pair(remat, policy)
    batch = _batch(cfg)
    want_l, want_g = jax.value_and_grad(jtl.make_loss_fn(jcfg))(jstate.params, _jax(batch))
    loss, grads = ttl.value_and_grad(ttl.make_loss_fn(cfg))(state.params, _torch(batch))
    assert abs(float(loss) - float(want_l)) <= LOSS_ATOL
    for g, w in zip(tlayers.tree_leaves(grads), jax.tree_util.tree_leaves(want_g), strict=True):
        assert g.dtype == torch.float32 and not g.requires_grad
        _close_rel(g, w, GRAD_RTOL)
    assert not any(p.requires_grad for p in tlayers.tree_leaves(state.params))


def test_checkpoint_fn_keeps_the_products_under_dots():
    """``remat_policy="dots"`` saves the products' outputs, so its backward
    pass runs fewer products than ``"full"``'s, which recomputes them; the
    gradients are the same.  ``remat=False``, or gradients off, returns the
    body as it is."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
            return func(*args, **(kwargs or {}))

    def body(x, w):
        return torch.tanh(x @ w) @ w

    cfg = get_config("qwen3-4b").reduced()
    assert tlayers.checkpoint_fn(body, dataclasses.replace(cfg, remat=False)) is body
    with torch.no_grad():
        assert tlayers.checkpoint_fn(body, cfg) is body
    x, w = torch.randn(4, 8, requires_grad=True), torch.randn(8, 8, requires_grad=True)
    want = torch.autograd.grad(body(x, w).sum(), (x, w))
    counts = {}
    for policy in ("full", "dots"):
        wrapped = tlayers.checkpoint_fn(body, dataclasses.replace(cfg, remat_policy=policy))
        out = wrapped(x, w).sum()
        with CountProducts() as products:
            got = torch.autograd.grad(out, (x, w))
        counts[policy] = products.n
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b)
    assert counts["dots"] < counts["full"], counts


def test_inference_steps_run_without_remat_or_history(monkeypatch):
    """The prefill and serve steps run with gradients off: even on weights
    that require grad, no layer goes through ``torch.utils.checkpoint`` and
    no output carries autograd history; ``forward`` under grad still wraps
    every layer."""
    from repro_torch.serve import engine

    wrapped = []
    real = tlayers.ckpt.checkpoint

    def counted(*args, **kw):
        wrapped.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tlayers.ckpt, "checkpoint", counted)
    cfg = get_config("qwen3-4b").reduced()
    params = tlayers.tree_map(lambda t: t.requires_grad_(),
                              treg.init_params(cfg, torch.Generator().manual_seed(3)))  # fmt: skip
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))
    last, cache = engine.make_prefill_step(cfg)(params, {"tokens": toks})
    assert not wrapped and not last.requires_grad
    assert not any(t.requires_grad for t in tlayers.tree_leaves(cache))
    logits, _ = engine.make_serve_step(cfg)(params, toks[:, :1], cache, 16)
    assert not wrapped and not logits.requires_grad
    from repro_torch.models import transformer

    out, _ = transformer.forward(cfg, params, {"tokens": toks})
    assert len(wrapped) == cfg.n_layers and out.requires_grad


def test_train_step_matches_the_references():
    cfg, jcfg, state, jstate = _pair()
    batch = _batch(cfg, b=4)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.OptConfig(**OCFG)))
    want_s, want_m = jstep(jstate, _jax(batch))
    got_s, got_m = ttl.make_train_step(cfg, topt.OptConfig(**OCFG))(state, _torch(batch))
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= LOSS_ATOL
    _close_rel(got_m["grad_norm"], want_m["grad_norm"], 1e-5)
    assert int(got_s.step) == int(want_s.step) == 1 and int(got_s.opt.count) == 1
    for g, w in zip(tlayers.tree_leaves(got_s.params), jax.tree_util.tree_leaves(want_s.params),
                    strict=True):  # fmt: skip
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STEP_ATOL)
    assert got_m["digest"].dtype == torch.int32
    # the step updates the state in place, as the reference donates it
    assert got_s.params["embed"].data_ptr() == state.params["embed"].data_ptr()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b", "whisper-base"])
def test_train_steps_of_every_family_match_the_references(arch):
    """``tests/test_models_smoke.py``'s ``test_train_step_reduces_loss_no_nans``
    for the families outside the transformer, held against the reference:
    three steps of AdamW at lr 5e-3 on one batch (whisper's with seeded
    frames), each step's loss and gradient norm, and the loss falling.
    Remat on; griffin at 8 layers, so its 2 remainder rec layers run under
    their own full remat as at 26 layers; griffin's and whisper's attention
    at unit q and k spread (``tests/test_torch_models.py::_unit_qk``).
    Autograd carries the gradient through the scans (the RG-LRU's
    associative scan, the WKV loop).  The first loss is held at
    ``LOSS_ATOL``, the later ones at 1e-4 (after an AdamW step each
    parameter moves by about lr whatever its gradient's size, so a
    last-bit difference in a small gradient moves the next loss: 1.5e-5
    seen), the gradient norm at 1e-4 relative (3.1e-5 seen)."""
    kw = {"remat": True, **({"n_layers": 8} if arch == "recurrentgemma-2b" else {})}
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(1))
    jstate = jstate._replace(params=_unit_qk(cfg, jstate.params)[0])
    state = state_from_numpy(_numpy(jstate), CPU)
    batch = _batch(cfg, b=2, s=16, seed=4)
    if cfg.family == "encdec":
        shape = (2, cfg.src_len, cfg.d_model)
        batch["frames"] = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ocfg = dict(lr=5e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.OptConfig(**ocfg)))
    step = ttl.make_train_step(cfg, topt.OptConfig(**ocfg))
    losses = []
    for i in range(3):
        jstate, want = jstep(jstate, _jax(batch))
        state, got = step(state, _torch(batch))
        assert abs(float(got["loss"]) - float(want["loss"])) <= (1e-4 if i else LOSS_ATOL), i
        _close_rel(got["grad_norm"], want["grad_norm"], 1e-4, f"step {i}")
        losses.append(float(got["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_grad_accum_equivalence():
    """grad_accum=2 must match grad_accum=1 on the same global batch
    (``tests/test_models_smoke.py``'s check, on the port)."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), remat=False)
    start = state_to_numpy(ttl.init_state(cfg, torch.Generator().manual_seed(3)))
    batch = _torch(_batch(cfg, b=2, s=16, seed=3))
    ocfg = topt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    s1, m1 = ttl.make_train_step(cfg, ocfg, grad_accum=1)(state_from_numpy(start, CPU), batch)
    s2, m2 = ttl.make_train_step(cfg, ocfg, grad_accum=2)(state_from_numpy(start, CPU), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(tlayers.tree_leaves(s1.params), tlayers.tree_leaves(s2.params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_grad_accum_matches_the_references():
    """Micro-gradients summed in float32: the loss and the digest's input
    dtype as the reference's."""
    cfg, jcfg, state, jstate = _pair(remat=False)
    batch = _batch(cfg, b=4, s=16, seed=2)
    step = jax.jit(jtl.make_train_step(jcfg, jopt.OptConfig(**OCFG), grad_accum=2))
    want_s, want_m = step(jstate, _jax(batch))
    step = ttl.make_train_step(cfg, topt.OptConfig(**OCFG), grad_accum=2)
    got_s, got_m = step(state, _torch(batch))
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= LOSS_ATOL
    for g, w in zip(tlayers.tree_leaves(got_s.params), jax.tree_util.tree_leaves(want_s.params),
                    strict=True):  # fmt: skip
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STEP_ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0)])
def test_attention_vjp_matches_jax_vjp(causal, window):
    """``attention_vjp`` (the backward pass of ``K9Attention``) against
    ``jax.vjp`` of the reference's model attention, over several 512-row
    chunks (Sq = Sk = 700)."""
    rng = np.random.default_rng(8)
    b, s, kvh, g, d = 1, 700, 2, 2, 16
    q = rng.standard_normal((b, s, kvh, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, s, kvh, g, d)).astype(np.float32)
    scale = d**-0.5

    def attend(q, k, v):
        return jlayers.flash_attention(q, k, v, causal=causal, window=window)

    _, pull = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = pull(jnp.asarray(dout))
    got = k_flash.attention_vjp(*(torch.from_numpy(x) for x in (q, k, v, dout)), causal,
                                window, scale)  # fmt: skip
    for name, a, w in zip("qkv", got, want, strict=True):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=VJP_ATOL, err_msg=name)


def test_run_loop_commits_as_the_reference_does():
    """Six steps with stragglers at 0.5, each side on its own staged
    context: ``committed`` and ``straggled`` bit for bit (the same draws),
    the delivered ``step:`` records in order, one for each committed step,
    each with its own step's digest."""
    cfg, jcfg, state, jstate = _pair()
    kw = dict(vocab=cfg.vocab, global_batch=2, seq_len=16, seed=5)
    loop = dict(steps=6, straggler_prob=0.5)
    jctx = JPaxosContext(JPaxosConfig(n_acceptors=3, n_instances=512, batch=16))
    _, want = jtl.run_loop(jcfg, jstate, iter(jdata.SyntheticStream(jdata.DataConfig(**kw))),
                           loop=jtl.LoopConfig(**loop), paxos_ctx=jctx, rng_seed=7)  # fmt: skip
    ctx = PaxosContext(PaxosConfig(n_acceptors=3, n_instances=512, batch=16), device=CPU)
    step, digests = ttl.make_train_step(cfg), []

    def recorded(s, batch):
        s, m = step(s, batch)
        digests.append(int(m["digest"]))
        return s, m

    state, got = ttl.run_loop(cfg, state, iter(tdata.SyntheticStream(tdata.DataConfig(**kw))),
                              loop=ttl.LoopConfig(**loop), train_step=recorded, paxos_ctx=ctx,
                              rng_seed=7)  # fmt: skip
    assert got["committed"] == want["committed"] and got["straggled"] == want["straggled"]
    assert 0 < sum(got["committed"]) < 6
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)
    assert int(state.step) == 6

    def records(log):
        return [(int.from_bytes(p[5:9], "little"), int.from_bytes(p[9:13], "little", signed=True))
                for _, p in log if p.startswith(b"step:")]  # fmt: skip

    committed = [i + 1 for i, c in enumerate(got["committed"]) if c]
    assert [s for s, _ in records(ctx.delivered_log)] == committed
    assert [s for s, _ in records(jctx.delivered_log)] == committed
    assert records(ctx.delivered_log) == [(s, digests[s - 1]) for s in committed]


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    args = ["--arch", "qwen3-4b", "--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--straggler-prob", "0.2"]  # fmt: skip
    launch_train.main(args)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("4 steps in") and "committed=" in out and "consensus_delivered=" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    launch_train.main(args + ["--resume"])
    assert "resumed from committed step 4" in capsys.readouterr().out
    # the default --mesh host ran above, a (1, 1) mesh in this world of one;
    # the production meshes refuse it, naming both sizes
    for mesh, ranks in (("prod", 256), ("prod-multi", 512)):
        with pytest.raises(ValueError, match=f"needs a world of {ranks} ranks, this one has 1"):
            launch_train.main(["--arch", "qwen3-4b", "--smoke", "--mesh", mesh, "--device", "cpu"])
    launch_train.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--mesh", "host"])  # fmt: skip
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("1 steps in")


def test_launch_train_means_the_card_by_default(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        launch_train.main(["--arch", "qwen3-4b", "--smoke"])
