"""Decoder-only transformer LM, the dense family (gemma3, yi, mistral-nemo, qwen3).

The port of ``repro.models.transformer``.  Layers are stacked (a leading
``layers`` dim on every block param, the reference's parameter tree) and
run by a Python loop over the layers where the reference scans, each
layer wrapped by ``layers.checkpoint_fn`` as the reference wraps its scan
body.  Prefill's and training's attention runs K9 on the card
(``layers.flash_attention``); decode attends over the cache in plain
PyTorch, as the reference does.

``decode_step`` writes the new token's key and value into the cache in
place and returns the same dict: the reference returns an updated copy, so
a caller that keeps the cache it passed in sees it change.

MoE blocks (``moe_fwd``) and the grouped ring cache (``ring_local_cache``)
wait for ``ROADMAP.md`` queue 1, item 8: each raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ..core.device import resolve_device
from . import layers as L
from .layers import PSpec

_RING_TODO = (
    "the grouped ring cache (ring_local_cache) is not ported yet: ROADMAP.md queue 1, item 8"
)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _stack(spec: PSpec, n: int) -> PSpec:
    return PSpec((n,) + spec.shape, ("layers",) + spec.axes, spec.init, spec.scale)


def block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    sp: dict[str, Any] = {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "attn": L.attention_specs(cfg),
    }
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE blocks (moe_fwd) are not ported yet: ROADMAP.md queue 1, item 8"
        )
    sp["mlp"] = L.mlp_specs(cfg)
    return sp


def specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    blocks = L.tree_map(lambda s: _stack(s, cfg.n_layers), block_specs(cfg))
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
    return L.tree_map(lambda x: x[i], blocks)


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
    return h, kk, vv


def forward(
    cfg, params, batch: dict[str, torch.Tensor], *, collect_cache: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Full-sequence forward.  batch = {tokens: (B, S)}.

    Returns (logits (B, S, V), cache or None).
    """
    if cfg.n_patches and "patches" in batch:
        raise NotImplementedError(
            "the VLM patch prefix is not ported yet: ROADMAP.md queue 1, item 8"
        )
    h = params["embed"][batch["tokens"]]
    body = L.checkpoint_fn(functools.partial(_block, cfg), cfg)
    ks, vs = [], []
    for i, win in enumerate(window_schedule(cfg)):
        h, kk, vv = body(h, _layer(params["blocks"], i), win)
        if collect_cache:
            ks.append(kk)
            vs.append(vv)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(cfg, params).to(h.dtype))

    cache = None
    if collect_cache:
        kk, vv = torch.stack(ks), torch.stack(vs)
        b, s = kk.shape[1], kk.shape[2]
        kpos = torch.arange(s, dtype=torch.int32, device=kk.device)
        cache = {"k": kk, "v": vv, "kpos": kpos.repeat(cfg.n_layers, b, 1)}
    return logits, cache


def prefill(cfg, params, batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    return forward(cfg, params, batch, collect_cache=True)


# ---------------------------------------------------------------------------
# KV cache / decode
# ---------------------------------------------------------------------------
def _grouped(cfg) -> bool:
    return bool(cfg.ring_local_cache and cfg.local_window and cfg.global_every)


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Meta tensors of the cache's shapes (no allocation)."""
    if _grouped(cfg):
        raise NotImplementedError(_RING_TODO)
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
    device = resolve_device(device)
    specs_ = cache_specs(cfg, batch, max_len, dtype)
    return {
        name: torch.full(s.shape, -1, dtype=s.dtype, device=device)
        if name == "kpos"
        else torch.zeros(s.shape, dtype=s.dtype, device=device)
        for name, s in specs_.items()
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
    kp[:, slot] = pos
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
    if _grouped(cfg):
        raise NotImplementedError(_RING_TODO)
    pos = int(pos)
    h = params["embed"][tokens]
    for i, win in enumerate(window_schedule(cfg)):
        h = _decode_layer(cfg, _layer(params["blocks"], i), h, cache["k"][i], cache["v"][i],
                          cache["kpos"][i], pos, win)  # fmt: skip
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(cfg, params).to(h.dtype))
    return logits, cache
