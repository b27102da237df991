"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention.

The port of ``repro.models.griffin``.  Block pattern (rec, rec, attn); the
recurrent mixer:

    gate = gelu(x W_gate)
    u    = causal_conv1d(x W_x, width 4)
    r_t  = sigmoid(u W_a + b_a);  i_t = sigmoid(u W_i + b_i)
    a_t  = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t  = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    out  = (gate * h) W_o

The linear recurrence runs as ``jax.lax.associative_scan`` runs it
(``_assoc_scan``: pairs combined, the half-length scan recursed, the evens
filled in), so its float32 products and sums come in the reference's order
and the scan stays log-depth in T; PyTorch ops, as the reference's are jnp
outside any Pallas kernel.  The local attention of each superblock runs K9
on the card (``layers.flash_attention``).

Layers are grouped into *superblocks* of the pattern length, run by a
Python loop where the reference scans, each wrapped by
``layers.checkpoint_fn``; the remainder layers (26 mod 3 = 2) run after
them as rec blocks, under full remat when ``cfg.remat`` is set.

``decode_step`` writes the conv states, the recurrences' states and the
attention ring (``pos % C``) of the cache in place and returns the same
dict, as ``transformer.decode_step`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import PSpec

RG_C = 8.0


def _rec_block_specs(cfg) -> dict[str, Any]:
    d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
    return {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "w_gate": PSpec((d, dr), ("embed", "rnn")),
        "w_x": PSpec((d, dr), ("embed", "rnn")),
        "conv": PSpec((cfg.conv_width, dr), (None, "rnn"), init="zeros"),
        "w_a": PSpec((dr, dr), ("rnn", "rnn_out")),
        "w_i": PSpec((dr, dr), ("rnn", "rnn_out")),
        "lam": PSpec((dr,), ("rnn",), init="ones"),
        "w_o": PSpec((dr, d), ("rnn", "embed")),
        "mlp": L.mlp_specs(cfg),
    }


def _attn_block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "attn": L.attention_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def _layout(cfg) -> tuple[int, int]:
    """(n_super, n_rem): superblocks of len(pattern) + remainder rec layers."""
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def specs(cfg) -> dict[str, Any]:
    n_super, n_rem = _layout(cfg)
    n_rec_per = cfg.block_pattern.count("rec")
    rec = L.tree_map(lambda s: L.stacked(L.stacked(s, n_rec_per), n_super), _rec_block_specs(cfg))
    attn = L.tree_map(lambda s: L.stacked(s, n_super), _attn_block_specs(cfg))
    sp: dict[str, Any] = {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "super": {"rec": rec, "attn": attn},
        "ln_f": PSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    if n_rem:
        sp["rem_rec"] = L.tree_map(lambda s: L.stacked(s, n_rem), _rec_block_specs(cfg))
    return sp


# ---------------------------------------------------------------------------
# RG-LRU mixer
# ---------------------------------------------------------------------------
def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (``F.gelu``'s is erf)."""
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. u: (B,T,C); kernel: (W,C); state: (B,W-1,C)."""
    w = kernel.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], w - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)  # (B, T+W-1, C)
    out = sum(ext[:, i : i + u.shape[1]] * kernel[i][None, None, :] for i in range(w))
    new_state = ext[:, -(w - 1) :] if w > 1 else None
    return out, new_state


def _combine(a1, b1, a2, b2):
    """The recurrence's combine: step (a1, b1) then step (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... on dim 1 (``even`` as long as ``odd``
    or one longer)."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.associative_scan(combine, (a, b), axis=1)``, in its order:
    combine adjacent pairs, scan the half-length sequence (the odd outputs),
    combine each odd output with the next even input (the even outputs, the
    first input first), interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _assoc_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        even_a, even_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        even_a, even_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rg_lru(u: torch.Tensor, p, h0: torch.Tensor | None = None):
    """u: (B,T,C) conv output.  Returns (h: (B,T,C), h_T float32)."""
    r = torch.sigmoid(torch.einsum("btc,ce->bte", u, p["w_a"]).float())
    i = torch.sigmoid(torch.einsum("btc,ce->bte", u, p["w_i"]).float())
    log_a = -RG_C * _softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    if h0 is not None:
        # fold the initial state in as a virtual step at t=0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.float()[:, None], b], dim=1)
    _, h = _assoc_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(u.dtype), h[:, -1]


def _rec_mixer(p, x, cfg, conv_state=None, h0=None):
    """x: (B, T, D) normalized input.  Returns (out, (conv_state', h_T))."""
    gate = _gelu(torch.einsum("btd,dr->btr", x, p["w_gate"]))
    u = L.shard(torch.einsum("btd,dr->btr", x, p["w_x"]), ("batch", "act_seq", "rnn"))
    u, conv_state = _causal_conv(u, p["conv"] + _conv_id(p["conv"]), conv_state)
    h, h_last = _rg_lru(u, p, h0)
    out = torch.einsum("btr,rd->btd", gate * h, p["w_o"])
    return out, (conv_state, h_last)


def _conv_id(kernel: torch.Tensor) -> torch.Tensor:
    """Identity-init helper: zero-initialized kernel + delta at the last tap.
    A (W, 1) column that broadcasts over the channels, built out of place
    (a DTensor kernel has no in-place fill)."""
    w = kernel.shape[0]
    taps = torch.arange(w, device=kernel.device)
    return L.replicated_like((taps == w - 1).to(kernel.dtype)[:, None], kernel)


def _rec_block(blk, x, cfg, state=None):
    conv_state = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    mix, (conv_state, h_last) = _rec_mixer(
        blk, L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, conv_state, h0
    )
    x = x + mix
    x = x + L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))
    return x, {"conv": conv_state, "h": h_last}


def _attn_block(blk, x, cfg):
    a, (kk, vv) = L.attention_fwd(
        blk["attn"], L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, window=cfg.local_window
    )
    x = x + a
    x = x + L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))
    return x, (kk, vv)


def _at(tree, *idx) -> Any:
    """The params at ``idx`` of every stacked leaf: views, no copies."""
    return L.layer(tree, *idx)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _super_block(cfg, x, blk):
    """One superblock: its rec blocks, then its attention block.  Returns
    the residual, the rec blocks' conv and recurrence states (stacked) and
    the attention's keys and values."""
    n_rec_per = cfg.block_pattern.count("rec")
    states = []
    for r in range(n_rec_per):
        x, st = _rec_block(_at(blk["rec"], r), x, cfg)
        states.append(st)
    x, (kk, vv) = _attn_block(blk["attn"], x, cfg)
    x = L.shard(x, ("batch", "act_seq", None))
    conv = torch.stack([s["conv"] for s in states])
    return x, conv, torch.stack([s["h"] for s in states]), kk, vv


def _rem_block(cfg, x, blk):
    x, st = _rec_block(blk, x, cfg)
    return x, st["conv"], st["h"]


def forward(cfg, params, batch, *, collect_cache: bool = False):
    """batch = {tokens: (B, T)}.  Returns (logits (B, T, V), cache or None)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    n_super, n_rem = _layout(cfg)
    h = L.shard(L.embed_lookup(params["embed"], tokens), ("batch", "act_seq", None))

    body = L.checkpoint_fn(lambda x, blk: _super_block(cfg, x, blk), cfg)
    outs, rem_outs = [], []
    for i in range(n_super):
        h, *ys = body(h, _at(params["super"], i))
        if collect_cache:
            outs.append(ys)
    if n_rem:
        # the reference wraps the remainder in plain ``jax.checkpoint``: full remat
        full = dataclasses.replace(cfg, remat_policy="full")
        rem = L.checkpoint_fn(lambda x, blk: _rem_block(cfg, x, blk), full)
        for j in range(n_rem):
            h, *ys = rem(h, _at(params["rem_rec"], j))
            if collect_cache:
                rem_outs.append(ys)

    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", h, params["embed"].T.to(h.dtype))
    logits = L.shard(logits, ("batch", "act_seq", "vocab"))

    cache = None
    if collect_cache:
        conv, hs, kk, vv = (torch.stack(ys) for ys in zip(*outs, strict=True))
        s = kk.shape[2]
        kpos = L.replicated_like(torch.arange(s, dtype=torch.int32, device=kk.device), kk)
        cache = {
            "rec_conv": conv,
            "rec_h": hs,
            "k": kk,
            "v": vv,
            "kpos": kpos.repeat(n_super, b, 1),
        }
        if n_rem:
            rem_conv, rem_h = (torch.stack(ys) for ys in zip(*rem_outs, strict=True))
            cache["rem_conv"], cache["rem_h"] = rem_conv, rem_h
    return logits, cache


def prefill(cfg, params, batch):
    return forward(cfg, params, batch, collect_cache=True)


def attention_calls(cfg) -> int:
    """Attention calls of one forward or prefill: one a superblock."""
    return _layout(cfg)[0]


# ---------------------------------------------------------------------------
# Cache / decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """An empty cache on ``device`` (``None``: the card): zero states, keys
    and values, positions -1."""
    return L.empty_cache(cache_specs(cfg, batch, max_len, dtype), device)


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Meta tensors of the cache's shapes (no allocation): the attention's
    ring holds ``min(max_len, local_window)`` slots."""
    n_super, n_rem = _layout(cfg)
    n_rec_per = cfg.block_pattern.count("rec")
    dr = cfg.d_rnn or cfg.d_model
    w = cfg.conv_width
    kv, hd = cfg.n_kv_heads, cfg.hd
    c = min(max_len, cfg.local_window) if cfg.local_window else max_len

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    sp = {
        "rec_conv": meta((n_super, n_rec_per, batch, w - 1, dr)),
        "rec_h": meta((n_super, n_rec_per, batch, dr), torch.float32),
        "k": meta((n_super, batch, c, kv, hd)),
        "v": meta((n_super, batch, c, kv, hd)),
        "kpos": meta((n_super, batch, c), torch.int32),
    }
    if n_rem:
        sp["rem_conv"] = meta((n_rem, batch, w - 1, dr))
        sp["rem_h"] = meta((n_rem, batch, dr), torch.float32)
    return sp


CACHE_AXES = {
    "rec_conv": ("layers", None, "batch", None, "rnn"),
    "rec_h": ("layers", None, "batch", "rnn"),
    "k": ("layers", "batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    "kpos": ("layers", "batch", "cache_seq"),
    "rem_conv": ("layers", "batch", None, "rnn"),
    "rem_h": ("layers", "batch", "rnn"),
}


def _rec_step(cfg, blk, x, conv, hs) -> torch.Tensor:
    """One rec block of decode; writes its conv and recurrence states in place."""
    x, st = _rec_block(blk, x, cfg, {"conv": conv, "h": hs})
    conv.copy_(st["conv"])
    hs.copy_(st["h"])
    return x


def _attn_step(cfg, blk, x, kc, vc, kp, pos: int) -> torch.Tensor:
    """One local attention block of decode on the ring ``kc``, ``vc``, ``kp``,
    written at ``pos % C`` in place."""
    b = x.shape[0]
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    slot = pos % kc.shape[1]
    xn = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    p = blk["attn"]
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", xn, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", xn, p["wv"])
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = L.rope(q, posv, cfg.rope_theta)
    kk = L.rope(kk, posv, cfg.rope_theta)
    kc[:, slot] = kk[:, 0].to(kc.dtype)
    vc[:, slot] = vv[:, 0].to(vc.dtype)
    kp[:, slot].fill_(pos)
    out = L.decode_attention(q.reshape(b, 1, kvh, g, hd), kc, vc, kp, pos, window=cfg.local_window)
    out = torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, cfg.n_heads, hd), p["wo"])
    x = x + out
    return x + L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))


def decode_step(cfg, params, tokens, cache, pos):
    """One-token decode (tokens (B, 1)) at absolute position ``pos``; every
    cache entry written in place."""
    pos = int(pos)
    n_super, n_rem = _layout(cfg)
    n_rec_per = cfg.block_pattern.count("rec")
    h = L.embed_lookup(params["embed"], tokens)  # (B, 1, D)
    for i in range(n_super):
        blk = _at(params["super"], i)
        for r in range(n_rec_per):
            h = _rec_step(cfg, _at(blk["rec"], r), h, cache["rec_conv"][i, r],
                          cache["rec_h"][i, r])  # fmt: skip
        h = _attn_step(cfg, blk["attn"], h, cache["k"][i], cache["v"][i], cache["kpos"][i], pos)
    for j in range(n_rem):
        h = _rec_step(cfg, _at(params["rem_rec"], j), h, cache["rem_conv"][j], cache["rem_h"][j])
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", h, params["embed"].T.to(h.dtype))
    return logits, cache
