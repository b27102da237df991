"""Decoder-only transformer LM: dense GQA, MoE and the VLM backbone.

The port of ``repro.models.transformer``: gemma3 (5:1 local:global
sliding window), yi, mistral-nemo and qwen3 (dense GQA), llama4-scout and
dbrx (MoE blocks, ``layers.moe_fwd``) and internvl2 (patch embeddings in
front of the tokens).  Layers are stacked (a leading
``layers`` dim on every block param, the reference's parameter tree) and
run by a Python loop over the layers where the reference scans, each
layer wrapped by ``layers.checkpoint_fn`` as the reference wraps its scan
body.  Prefill's and training's attention runs K9 on the card
(``layers.flash_attention``); decode attends over the cache in plain
PyTorch, as the reference does.

``decode_step`` writes the new token's key and value into the cache in
place and returns the same dict: the reference returns an updated copy, so
a caller that keeps the cache it passed in sees it change.

With ``ring_local_cache`` the decode cache is grouped (``grouped_*``):
local layers keep a ring of ``local_window`` slots, global ones the whole
sequence; the same in-place writes.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from . import layers as L
from .layers import PSpec


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    sp: dict[str, Any] = {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "attn": L.attention_specs(cfg),
    }
    if cfg.n_experts:
        sp["moe"] = L.moe_specs(cfg)
    else:
        sp["mlp"] = L.mlp_specs(cfg)
    return sp


def specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    blocks = L.tree_map(lambda s: L.stacked(s, cfg.n_layers), block_specs(cfg))
    sp = {
        "embed": PSpec((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "blocks": blocks,
        "ln_f": PSpec((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        sp["head"] = PSpec((d, cfg.vocab), ("embed", "vocab"))
    return sp


def window_schedule(cfg) -> list[int]:
    """Per-layer sliding window (0 = global/full attention)."""
    if cfg.local_window == 0:
        return [0] * cfg.n_layers
    if cfg.global_every == 0:
        return [cfg.local_window] * cfg.n_layers
    every = cfg.global_every
    return [0 if (i + 1) % every == 0 else cfg.local_window for i in range(cfg.n_layers)]


def _layer(blocks: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer ``i``'s params: views into the stacked block params."""
    return L.layer(blocks, i)


def _head(cfg, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def _ffn(blk, x, cfg):
    if cfg.n_experts:
        return L.moe_fwd(blk["moe"], x, cfg)
    return L.mlp_fwd(blk["mlp"], x)


def _block(cfg, h, blk, win: int):
    """One layer: attention, then the feed-forward, each on its normed
    residual.  Returns the new residual and the layer's keys and values."""
    a, (kk, vv) = L.attention_fwd(
        blk["attn"], L.rms_norm(h, blk["ln1"], cfg.norm_eps), cfg, window=win
    )
    h = h + a
    h = h + _ffn(blk, L.rms_norm(h, blk["ln2"], cfg.norm_eps), cfg)
    return L.shard(h, ("batch", "act_seq", None)), kk, vv


def _embed_inputs(cfg, params, batch) -> tuple[torch.Tensor, int]:
    """Token (+ modality-prefix) embedding.  Returns (h, n_prefix)."""
    h = L.embed_lookup(params["embed"], batch["tokens"])
    if cfg.n_patches and "patches" in batch:
        patches = batch["patches"]
        return torch.cat([patches.to(h.dtype), h], dim=1), patches.shape[1]
    return h, 0


def forward(
    cfg, params, batch: dict[str, torch.Tensor], *, collect_cache: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Full-sequence forward.  batch = {tokens: (B, S) [, patches: (B, P, D)]}.

    The patches go in front of the tokens, positions count from the first
    patch, and the cache holds the prefix too.  Returns (logits of the
    tokens (B, S, V), cache or None).
    """
    h, n_prefix = _embed_inputs(cfg, params, batch)
    h = L.shard(h, ("batch", "act_seq", None))
    body = L.checkpoint_fn(functools.partial(_block, cfg), cfg)
    ks, vs = [], []
    for i, win in enumerate(window_schedule(cfg)):
        h, kk, vv = body(h, _layer(params["blocks"], i), win)
        if collect_cache:
            ks.append(kk)
            vs.append(vv)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(cfg, params).to(h.dtype))
    logits = L.shard(logits, ("batch", "act_seq", "vocab"))

    cache = None
    if collect_cache:
        kk, vv = torch.stack(ks), torch.stack(vs)
        b, s = kk.shape[1], kk.shape[2]
        kpos = L.replicated_like(torch.arange(s, dtype=torch.int32, device=kk.device), kk)
        cache = {"k": kk, "v": vv, "kpos": kpos.repeat(cfg.n_layers, b, 1)}
    return logits[:, n_prefix:], cache


def prefill(cfg, params, batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    return forward(cfg, params, batch, collect_cache=True)


def attention_calls(cfg) -> int:
    """Attention calls of one forward or prefill: one a layer."""
    return cfg.n_layers


# ---------------------------------------------------------------------------
# KV cache / decode
# ---------------------------------------------------------------------------
def _grouped(cfg) -> bool:
    return bool(cfg.ring_local_cache and cfg.local_window and cfg.global_every)


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Meta tensors of the cache's shapes (no allocation)."""
    if _grouped(cfg):
        return grouped_cache_specs(cfg, batch, max_len, dtype)
    l, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.empty((l, batch, max_len, kv, hd), dtype=dtype, device="meta"),
        "v": torch.empty((l, batch, max_len, kv, hd), dtype=dtype, device="meta"),
        "kpos": torch.empty((l, batch, max_len), dtype=torch.int32, device="meta"),
    }


def init_cache(
    cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> dict[str, torch.Tensor]:
    """An empty cache on ``device`` (``None``: the card, as for
    ``ServeLoop``): zero keys and values, positions -1."""
    if _grouped(cfg):
        return grouped_init_cache(cfg, batch, max_len, dtype, device)
    return L.empty_cache(cache_specs(cfg, batch, max_len, dtype), device)


CACHE_AXES = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    "kpos": ("layers", "batch", "cache_seq"),
    # grouped ring-cache layout (ring_local_cache)
    "lk": ("layers", None, "batch", "cache_seq", "kv_heads", None),
    "lv": ("layers", None, "batch", "cache_seq", "kv_heads", None),
    "lkp": ("layers", None, "batch", "cache_seq"),
    "gk": ("layers", "batch", "cache_seq", "kv_heads", None),
    "gv": ("layers", "batch", "cache_seq", "kv_heads", None),
    "gkp": ("layers", "batch", "cache_seq"),
    "rk": ("layers", "batch", "cache_seq", "kv_heads", None),
    "rv": ("layers", "batch", "cache_seq", "kv_heads", None),
    "rkp": ("layers", "batch", "cache_seq"),
}


def _decode_layer(cfg, blk, h, kc, vc, kp, pos: int, win: int):
    """One layer of single-token decode; writes the cache slices in place."""
    b = h.shape[0]
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    slot = pos % kc.shape[1]
    x = L.rms_norm(h, blk["ln1"], cfg.norm_eps)
    p = blk["attn"]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        kk = L.rms_norm(kk, p["k_norm"], cfg.norm_eps)
    posv = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    q = L.rope(q, posv, cfg.rope_theta)
    kk = L.rope(kk, posv, cfg.rope_theta)
    kc[:, slot] = kk[:, 0].to(kc.dtype)
    vc[:, slot] = vv[:, 0].to(vc.dtype)
    kp[:, slot].fill_(pos)
    out = L.decode_attention(q.reshape(b, 1, kvh, g, hd), kc, vc, kp, pos, window=win)
    out = torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, cfg.n_heads, hd), p["wo"])
    h = h + out
    return h + _ffn(blk, L.rms_norm(h, blk["ln2"], cfg.norm_eps), cfg)


def decode_step(
    cfg,
    params,
    tokens: torch.Tensor,  # (B, 1)
    cache: dict[str, torch.Tensor],
    pos: int,  # absolute position of this token
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode with the ring KV cache written at ``pos % C``, in place."""
    pos = int(pos)
    if _grouped(cfg):
        return _decode_step_grouped(cfg, params, tokens, cache, pos)
    h = L.shard(L.embed_lookup(params["embed"], tokens), ("batch", None, None))
    for i, win in enumerate(window_schedule(cfg)):
        h = _decode_layer(cfg, _layer(params["blocks"], i), h, cache["k"][i], cache["v"][i],
                          cache["kpos"][i], pos, win)  # fmt: skip
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(cfg, params).to(h.dtype))
    return logits, cache


# ---------------------------------------------------------------------------
# Grouped ring caches (ring_local_cache)
#
# Local (sliding-window) layers only ever attend to the last ``window``
# positions, so their cache needs window slots, not seq_len.  Layers are
# grouped into superblocks of ``global_every`` (gemma3: 5 local + 1 global);
# the remainder layers are local.  For gemma3-27b at 32k this shrinks the KV
# cache from 62*S to 52*W + 10*S slots a sequence (about 5.3x), and decode
# attention, which reads the whole cache every token, reads as much less.
# ---------------------------------------------------------------------------
def _grouped_layout(cfg) -> tuple[int, int, int]:
    ge = cfg.global_every
    return cfg.n_layers // ge, ge, cfg.n_layers % ge


def grouped_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """Meta tensors of the grouped cache's shapes (no allocation)."""
    n_super, ge, rem = _grouped_layout(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    w = min(cfg.local_window, max_len)

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    sp = {
        "lk": meta((n_super, ge - 1, batch, w, kv, hd)),
        "lv": meta((n_super, ge - 1, batch, w, kv, hd)),
        "lkp": meta((n_super, ge - 1, batch, w), torch.int32),
        "gk": meta((n_super, batch, max_len, kv, hd)),
        "gv": meta((n_super, batch, max_len, kv, hd)),
        "gkp": meta((n_super, batch, max_len), torch.int32),
    }
    if rem:
        sp["rk"] = meta((rem, batch, w, kv, hd))
        sp["rv"] = meta((rem, batch, w, kv, hd))
        sp["rkp"] = meta((rem, batch, w), torch.int32)
    return sp


def grouped_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """An empty grouped cache on ``device`` (``None``: the card)."""
    return L.empty_cache(grouped_cache_specs(cfg, batch, max_len, dtype), device)


def _regroup_blocks(cfg, blocks):
    """Split the (L, ...)-stacked block params into (super-local, super-global,
    remainder-local) views of the same storage: no copies."""
    n_super, ge, rem = _grouped_layout(cfg)

    def main(x):
        return x[: n_super * ge].view((n_super, ge) + x.shape[1:])

    locals_ = L.tree_map(lambda x: main(x)[:, : ge - 1], blocks)
    globals_ = L.tree_map(lambda x: main(x)[:, ge - 1], blocks)
    rems = L.tree_map(lambda x: x[n_super * ge :], blocks) if rem else None
    return locals_, globals_, rems


def _decode_step_grouped(cfg, params, tokens, cache, pos: int):
    """``decode_step`` on the grouped cache: each superblock's local layers
    on their rings, then its global layer, then the remainder's local
    layers; every cache slice written in place."""
    n_super, ge, rem = _grouped_layout(cfg)
    w = cfg.local_window
    h = L.shard(L.embed_lookup(params["embed"], tokens), ("batch", None, None))
    loc, glob, rems = _regroup_blocks(cfg, params["blocks"])
    lk, lv, lkp = cache["lk"], cache["lv"], cache["lkp"]
    gk, gv, gkp = cache["gk"], cache["gv"], cache["gkp"]
    for i in range(n_super):
        for j in range(ge - 1):
            blk = L.layer(loc, i, j)
            h = _decode_layer(cfg, blk, h, lk[i, j], lv[i, j], lkp[i, j], pos, w)
        h = _decode_layer(cfg, _layer(glob, i), h, gk[i], gv[i], gkp[i], pos, 0)
    for r in range(rem):
        h = _decode_layer(cfg, _layer(rems, r), h, cache["rk"][r], cache["rv"][r],
                          cache["rkp"][r], pos, w)  # fmt: skip
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(cfg, params).to(h.dtype))
    return logits, cache
