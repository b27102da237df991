"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed).

The port of ``repro.models.whisper``.  ``registry.input_specs`` supplies
precomputed frame embeddings (B, F, D): the conv frontend is a stub, as in
the reference.  Encoder: non-causal self-attention with sinusoidal
positions.  Decoder: causal self-attention + cross-attention over the
encoder output, GELU (tanh form, ``jax.nn.gelu``'s default) MLPs, tied
embeddings.  Every prefill attention (the encoder's, the decoder's self-
and cross-attention) runs K9 on the card (``layers.flash_attention``).

JAX promotes a float32 operand against a bf16 one to float32: float32
frames over bf16 weights run the encoder, and the cross keys and values,
in float32.  ``torch.einsum`` does not promote, so the encoder's weights
and the cross projections are cast up where the reference's products
promote (an exact cast).

Layers run by a Python loop where the reference scans, each wrapped by
``layers.checkpoint_fn``.  ``decode_step`` writes the self-attention cache
at ``pos % C`` in place and returns the same dict, as
``transformer.decode_step`` does; the cross cache is read only.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import PSpec


def _gelu_mlp_specs(cfg) -> dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": PSpec((d, f), ("embed", "mlp")),
        "wo": PSpec((f, d), ("mlp", "embed")),
    }


def _gelu_mlp(p, x):
    h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"]), approximate="tanh")
    h = L.shard(h, ("batch", None, "mlp_act"))
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


def _enc_block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "attn": L.attention_specs(cfg),
        "mlp": _gelu_mlp_specs(cfg),
    }


def _dec_block_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": PSpec((d,), ("embed",), init="zeros"),
        "lnx": PSpec((d,), ("embed",), init="zeros"),
        "ln2": PSpec((d,), ("embed",), init="zeros"),
        "attn": L.attention_specs(cfg),
        "cross": L.attention_specs(cfg),
        "mlp": _gelu_mlp_specs(cfg),
    }


def specs(cfg) -> dict[str, Any]:
    return {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "enc": L.tree_map(lambda s: L.stacked(s, cfg.n_enc_layers), _enc_block_specs(cfg)),
        "dec": L.tree_map(lambda s: L.stacked(s, cfg.n_layers), _dec_block_specs(cfg)),
        "ln_enc": PSpec((cfg.d_model,), ("embed",), init="zeros"),
        "ln_f": PSpec((cfg.d_model,), ("embed",), init="zeros"),
    }


def _promoted(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the dtype that JAX promotes ``t`` and a ``dtype`` operand to."""
    return t.to(torch.promote_types(t.dtype, dtype))


def _enc_block(cfg, x, blk):
    a, _ = L.attention_fwd(
        blk["attn"], L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, causal=False, use_rope=False
    )
    x = x + a
    return x + _gelu_mlp(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, D) stub embeddings -> encoder output (B, F, D), in the
    dtype JAX promotes the frames and the weights to."""
    _, f, d = frames.shape
    h = frames.to(params["ln_enc"].dtype)
    h = h + L.replicated_like(L.sinusoidal_pos(f, d, device=frames.device).to(frames.dtype), h)
    h = L.shard(h, ("batch", None, None))
    enc = L.tree_map(lambda t: _promoted(t, h.dtype), params["enc"])
    body = L.checkpoint_fn(lambda x, blk: _enc_block(cfg, x, blk), cfg)
    for i in range(cfg.n_enc_layers):
        h = body(h, L.layer(enc, i))
    return L.rms_norm(h, params["ln_enc"], cfg.norm_eps)


def _dec_block(cfg, x, blk, enc_out):
    """One decoder layer.  Returns the residual, the self-attention's keys
    and values and the cross keys and values."""
    a, (kk, vv) = L.attention_fwd(
        blk["attn"], L.rms_norm(x, blk["ln1"], cfg.norm_eps), cfg, causal=True, use_rope=False
    )
    x = x + a
    # cross-attention: kv from encoder output
    xq = L.rms_norm(x, blk["lnx"], cfg.norm_eps)
    ck = torch.einsum("bfd,dhk->bfhk", enc_out, _promoted(blk["cross"]["wk"], enc_out.dtype))
    cv = torch.einsum("bfd,dhk->bfhk", enc_out, _promoted(blk["cross"]["wv"], enc_out.dtype))
    c, _ = L.attention_fwd(
        blk["cross"], xq, cfg, causal=False, use_rope=False, kv_override=(ck, cv)
    )
    x = x + c
    x = x + _gelu_mlp(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))
    return x, kk, vv, ck, cv


def forward(cfg, params, batch, *, collect_cache: bool = False):
    """batch = {frames: (B, F, D), tokens: (B, S)}.  Returns (logits
    (B, S, V), cache or None); the cache keeps the cross keys and values."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = L.embed_lookup(params["embed"], tokens)
    h = h + L.replicated_like(L.sinusoidal_pos(s, cfg.d_model, device=h.device).to(h.dtype), h)
    h = L.shard(h, ("batch", "act_seq", None))
    body = L.checkpoint_fn(lambda x, blk: _dec_block(cfg, x, blk, enc_out), cfg)
    caches = []
    for i in range(cfg.n_layers):
        h, *ys = body(h, L.layer(params["dec"], i))
        if collect_cache:
            caches.append(ys)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["embed"].T.to(h.dtype))
    logits = L.shard(logits, ("batch", "act_seq", "vocab"))

    cache = None
    if collect_cache:
        kk, vv, ck, cv = (torch.stack(ys) for ys in zip(*caches, strict=True))
        kpos = L.replicated_like(torch.arange(s, dtype=torch.int32, device=kk.device), kk)
        cache = {
            "k": kk,
            "v": vv,
            "kpos": kpos.repeat(cfg.n_layers, b, 1),
            "cross_k": ck,
            "cross_v": cv,
        }
    return logits, cache


def prefill(cfg, params, batch):
    return forward(cfg, params, batch, collect_cache=True)


def attention_calls(cfg) -> int:
    """Attention calls of one forward or prefill: one an encoder layer, two
    (self and cross) a decoder layer."""
    return cfg.n_enc_layers + 2 * cfg.n_layers


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Meta tensors of the cache's shapes (no allocation)."""
    l, kv, hd, f = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.src_len

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    return {
        "k": meta((l, batch, max_len, kv, hd)),
        "v": meta((l, batch, max_len, kv, hd)),
        "kpos": meta((l, batch, max_len), torch.int32),
        "cross_k": meta((l, batch, f, kv, hd)),
        "cross_v": meta((l, batch, f, kv, hd)),
    }


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """An empty cache on ``device`` (``None``: the card): zero keys and
    values (the cross ones too), positions -1."""
    return L.empty_cache(cache_specs(cfg, batch, max_len, dtype), device)


CACHE_AXES = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    "kpos": ("layers", "batch", "cache_seq"),
    "cross_k": ("layers", "batch", None, "kv_heads", None),
    "cross_v": ("layers", "batch", None, "kv_heads", None),
}


def _decode_layer(cfg, blk, x, kc, vc, kp, ck, cv, pos: int):
    """One decoder layer of single-token decode; writes the self-attention
    cache slices at ``pos % C`` in place."""
    b = x.shape[0]
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    slot = pos % kc.shape[1]
    xn = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    p = blk["attn"]
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", xn, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", xn, p["wv"])
    kc[:, slot] = kk[:, 0].to(kc.dtype)
    vc[:, slot] = vv[:, 0].to(vc.dtype)
    kp[:, slot].fill_(pos)
    out = L.decode_attention(q.reshape(b, 1, kvh, g, hd), kc, vc, kp, pos)
    x = x + torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, cfg.n_heads, hd), p["wo"])
    # cross-attention over the fixed encoder cache: every frame valid
    xq = L.rms_norm(x, blk["lnx"], cfg.norm_eps)
    pc = blk["cross"]
    qx = torch.einsum("bsd,dhk->bshk", xq, pc["wq"])
    f = ck.shape[1]
    fpos = L.replicated_like(torch.arange(f, dtype=torch.int32, device=x.device).expand(b, f), ck)
    outx = L.decode_attention(qx.reshape(b, 1, kvh, g, hd), ck, cv, fpos, f)
    x = x + torch.einsum("bshk,hkd->bsd", outx.reshape(b, 1, cfg.n_heads, hd), pc["wo"])
    return x + _gelu_mlp(blk["mlp"], L.rms_norm(x, blk["ln2"], cfg.norm_eps))


def decode_step(cfg, params, tokens, cache, pos):
    """One-token decode (tokens (B, 1)) at absolute position ``pos``."""
    pos = int(pos)
    h = L.embed_lookup(params["embed"], tokens)
    h = h + L.replicated_like(_pos_embed_at(pos, cfg.d_model, h.device).to(h.dtype), h)
    for i in range(cfg.n_layers):
        blk = L.layer(params["dec"], i)
        h = _decode_layer(cfg, blk, h, cache["k"][i], cache["v"][i], cache["kpos"][i],
                          cache["cross_k"][i], cache["cross_v"][i], pos)  # fmt: skip
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["embed"].T.to(h.dtype))
    return logits, cache


def _pos_embed_at(pos: int, d: int, device=None) -> torch.Tensor:
    """(1, 1, d) sinusoidal position embedding of one position."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = float(pos) / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d][None]
