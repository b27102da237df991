"""RWKV6 "Finch" (attention-free SSM with data-dependent decay).

The port of ``repro.models.rwkv6``.  Time-mix: token-shift interpolated
projections r/k/v/g plus the RWKV6 signature feature, a *data-dependent*
per-channel decay ``w_t`` produced by a low-rank (LoRA) head; the WKV
recurrence per head is

    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``_wkv_scan`` runs it as a Python loop over time of float32 PyTorch ops,
step for step the reference's ``lax.scan`` (which too runs outside any
Pallas kernel): O(T) sequential steps, O(1) state.  No kernel runs here.

Layers run by a Python loop where the reference scans, each wrapped by
``layers.checkpoint_fn``.  ``decode_step`` is one recurrence step a layer;
it writes the state and the last raw inputs of the cache in place and
returns the same dict, as ``transformer.decode_step`` does.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import PSpec

LORA_R = 64


def block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    h = cfg.n_heads
    hd = cfg.rwkv_head_dim
    dh = h * hd
    return {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "tm": {
            # token-shift interpolation factors
            "mu_r": PSpec((d,), ("embed",), init="zeros"),
            "mu_k": PSpec((d,), ("embed",), init="zeros"),
            "mu_v": PSpec((d,), ("embed",), init="zeros"),
            "mu_g": PSpec((d,), ("embed",), init="zeros"),
            "mu_w": PSpec((d,), ("embed",), init="zeros"),
            "wr": PSpec((d, dh), ("embed", "heads_flat")),
            "wk": PSpec((d, dh), ("embed", "heads_flat")),
            "wv": PSpec((d, dh), ("embed", "heads_flat")),
            "wg": PSpec((d, dh), ("embed", "heads_flat")),
            # data-dependent decay (LoRA)
            "w0": PSpec((dh,), ("heads_flat",), init="zeros"),
            "wa": PSpec((d, LORA_R), ("embed", None)),
            "wb": PSpec((LORA_R, dh), (None, "heads_flat")),
            "u": PSpec((dh,), ("heads_flat",), init="zeros"),
            "ln_x": PSpec((dh,), ("heads_flat",), init="zeros"),
            "wo": PSpec((dh, d), ("heads_flat", "embed")),
        },
        "cm": {
            "mu_k": PSpec((d,), ("embed",), init="zeros"),
            "mu_r": PSpec((d,), ("embed",), init="zeros"),
            "wk": PSpec((d, cfg.d_ff), ("embed", "mlp")),
            "wv": PSpec((cfg.d_ff, d), ("mlp", "embed")),
            "wr": PSpec((d, d), ("embed", "embed_out")),
        },
    }


def specs(cfg) -> dict[str, Any]:
    return {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "blocks": L.tree_map(lambda s: L.stacked(s, cfg.n_layers), block_specs(cfg)),
        "ln_f": PSpec((cfg.d_model,), ("embed",), init="zeros"),
        "head": PSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------
def _wkv_scan(r, k, v, w, u, s0):
    """r/k/v/w: (B, T, H, hd) float32; u: (H, hd); s0: (B, H, hd, hd).

    Returns (y: (B, T, H, hd), s_T)."""
    s, ys = s0, []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, hd)
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhj,bhji->bhi", rt, s + bonus * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv(r, k, v, w, u, s0):
    """``_wkv_scan``; on DTensors each rank scans its own batch rows and
    heads (``local_map``), every other split gathered first, so the loop
    over time runs on local tensors."""
    if not L.is_dtensor(r):
        return _wkv_scan(r, k, v, w, u, s0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    placed = []  # on each mesh dim: r, k, v, w; u; u's gradient; the states
    for p in r.placements:
        if p == Shard(0):  # batch rows: the bonus's gradient sums over them
            placed.append((p, Replicate(), Partial(), p))
        elif p == Shard(2):  # heads
            placed.append((p, Shard(0), Shard(0), Shard(1)))
        else:
            placed.append((Replicate(),) * 4)
    seq, uu, ug, state = (tuple(x) for x in zip(*placed, strict=True))
    fn = local_map(_wkv_scan, out_placements=(seq, state),
                   in_placements=(seq, seq, seq, seq, uu, state),
                   in_grad_placements=(seq, seq, seq, seq, ug, state),
                   redistribute_inputs=True)  # fmt: skip
    return fn(r, k, v, w, u, s0)


def _time_mix(p, x, xprev, cfg, s0):
    """x: (B, T, D); xprev: token-shifted x; s0: (B,H,hd,hd)."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.rwkv_head_dim

    def mix(mu):
        return x + (xprev - x) * mu

    r = torch.einsum("btd,de->bte", mix(p["mu_r"]), p["wr"])
    k = torch.einsum("btd,de->bte", mix(p["mu_k"]), p["wk"])
    v = torch.einsum("btd,de->bte", mix(p["mu_v"]), p["wv"])
    g = F.silu(torch.einsum("btd,de->bte", mix(p["mu_g"]), p["wg"]))
    # data-dependent decay in (0, 1): exp(-exp(.)); the LoRA's two products
    # in the order the reference's einsum contracts them
    lora = torch.einsum("btd,dr->btr", torch.tanh(mix(p["mu_w"])), p["wa"])
    wlog = p["w0"] + torch.einsum("btr,re->bte", lora, p["wb"])
    acc = L.wide(x.dtype)  # float32, as the reference's casts (float64 in a float64 run)
    w = torch.exp(-torch.exp(wlog.to(acc)))

    shp = (h, hd)
    y, s = _wkv(
        L.split_last(r, shp).to(acc),
        L.split_last(k, shp).to(acc),
        L.split_last(v, shp).to(acc),
        L.split_last(w, shp),
        L.split_last(1.0 + p["u"].to(acc), shp),
        s0,
    )
    y = y.reshape(b, t, h * hd)
    y = L.rms_norm(y.to(x.dtype), p["ln_x"], cfg.norm_eps)
    return torch.einsum("bte,ed->btd", y * g, p["wo"]), s


def _channel_mix(p, x, xprev):
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    k = torch.square(F.relu(torch.einsum("btd,df->btf", xk, p["wk"])))
    kv = torch.einsum("btf,fd->btd", k, p["wv"])
    return torch.sigmoid(torch.einsum("btd,de->bte", xr, p["wr"])) * kv


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x one step later in time, a zero row first."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------
def cache_specs(cfg, batch: int, max_len: int = 0, dtype=torch.bfloat16):
    """Meta tensors of the cache's shapes (no allocation): each layer's WKV
    state and the last raw inputs of its time-mix and channel-mix."""
    l, h, hd, d = cfg.n_layers, cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "s": torch.empty((l, batch, h, hd, hd), dtype=L.wide(dtype), device="meta"),
        "x_tm": torch.empty((l, batch, d), dtype=dtype, device="meta"),
        "x_cm": torch.empty((l, batch, d), dtype=dtype, device="meta"),
    }


def init_cache(cfg, batch: int, max_len: int = 0, dtype=torch.bfloat16, device=None):
    """An empty (zero) cache on ``device`` (``None``: the card)."""
    return L.empty_cache(cache_specs(cfg, batch, max_len, dtype), device)


CACHE_AXES = {
    "s": ("layers", "batch", "heads", None, None),
    "x_tm": ("layers", "batch", None),
    "x_cm": ("layers", "batch", None),
}


def _block(cfg, x, blk):
    """One layer over the whole sequence, from a zero state.  Returns the
    residual, the final WKV state and the last raw inputs of the time-mix
    and the channel-mix (the cache's)."""
    b = x.shape[0]
    x_in_last = x[:, -1]
    hd = cfg.rwkv_head_dim
    s0 = x.new_zeros((b, cfg.n_heads, hd, hd), dtype=L.wide(x.dtype))
    y, s = _time_mix(blk["tm"], L.rms_norm(x, blk["ln1"], cfg.norm_eps),
                     L.rms_norm(_shift(x), blk["ln1"], cfg.norm_eps), cfg, s0)  # fmt: skip
    x = x + y
    x_mid_last = x[:, -1]
    xn = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    x = x + _channel_mix(blk["cm"], xn, _shift(xn))
    return L.shard(x, ("batch", "act_seq", None)), s, x_in_last, x_mid_last


def forward(cfg, params, batch, *, collect_cache: bool = False):
    """batch = {tokens: (B, T)}.  Returns (logits (B, T, V), cache or None)."""
    h = L.shard(L.embed_lookup(params["embed"], batch["tokens"]), ("batch", "act_seq", None))
    body = L.checkpoint_fn(lambda x, blk: _block(cfg, x, blk), cfg)
    caches = []
    for i in range(cfg.n_layers):
        h, *ys = body(h, L.layer(params["blocks"], i))
        if collect_cache:
            caches.append(ys)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", h, params["head"].to(h.dtype))
    logits = L.shard(logits, ("batch", "act_seq", "vocab"))

    cache = None
    if collect_cache:
        s, x_tm, x_cm = (torch.stack(ys) for ys in zip(*caches, strict=True))
        cache = {"s": s, "x_tm": x_tm.to(h.dtype), "x_cm": x_cm.to(h.dtype)}
    return logits, cache


def prefill(cfg, params, batch):
    return forward(cfg, params, batch, collect_cache=True)


def attention_calls(cfg) -> int:
    """Attention calls of one forward or prefill: none, attention-free."""
    return 0


def decode_step(cfg, params, tokens, cache, pos):
    """One-token step (tokens (B, 1)): an O(1) state update a layer, no KV
    cache.  ``pos`` is unused, as in the reference."""
    h = L.embed_lookup(params["embed"], tokens[:, 0])  # (B, D)
    for i in range(cfg.n_layers):
        blk = L.layer(params["blocks"], i)
        s, x_tm, x_cm = cache["s"][i], cache["x_tm"][i], cache["x_cm"][i]
        xn = L.rms_norm(h, blk["ln1"], cfg.norm_eps)
        xp = L.rms_norm(x_tm, blk["ln1"], cfg.norm_eps)
        y, s_new = _time_mix(blk["tm"], xn[:, None], xp[:, None], cfg, s)
        x_tm.copy_(h)
        h = h + y[:, 0]
        xn2 = L.rms_norm(h, blk["ln2"], cfg.norm_eps)
        xp2 = L.rms_norm(x_cm, blk["ln2"], cfg.norm_eps)
        cmix = _channel_mix(blk["cm"], xn2[:, None], xp2[:, None])
        x_cm.copy_(h)
        s.copy_(s_new)
        h = h + cmix[:, 0]
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h, params["head"].to(h.dtype))
    return logits[:, None], cache
