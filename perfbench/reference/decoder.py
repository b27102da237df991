"""A plain dense decoder and its loss, in float32, written from the published
architecture and independent of the program under test.

One layer: ``h += Wo · attn(rope(qk_norm(Wq x)), rope(qk_norm(Wk x)), Wv x)``
with ``x = rms_norm(h)``, then ``h += W_down (silu(W_gate x) * W_up x)`` with
``x = rms_norm(h)``.  Attention is causal grouped-query attention: query
head ``j`` reads key head ``j // (H / KV)``, scores scaled by ``D ** -0.5``.
RoPE rotates the two halves of each head (the Llama/Qwen convention) at
angles ``pos * theta ** (-2i / D)``.  The logits are ``rms_norm(h) · head``,
with ``head = embed.T`` where the embeddings are tied, and the loss is the
mean cross-entropy of every token.

Parameters arrive as the tree the benchmark hands to both sides: every
matrix stacked over the layers, and each norm's weight stored as its offset
from one (``x * (1 + w)``; the published initialisation of ones is a zero
offset).  Everything is computed in float32 with TF32 off; the layers and
the loss's rows run under activation checkpointing, and attention in blocks
of query rows, so the reference fits beside its float32 state on one card.

``Precision`` lets every matrix product see its operands rounded to a lower
precision: the control of ``lowp.py``.  ``EXACT`` rounds nothing.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch
from torch.utils.checkpoint import checkpoint

# Model types whose attention normalises each head's queries and keys (RMS
# over the head dim) before the rotary embedding: Qwen3's architecture.
QK_NORM_MODEL_TYPES = ("qwen3",)

ROW_BLOCK = 512  # query rows an attention block takes
LOSS_ROWS = 1024  # tokens whose logits exist at once


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool
    tied: bool
    eps: float
    theta: float

    @classmethod
    def from_config(cls, conf: dict) -> Dims:
        """From a published ``config.json``'s keys."""
        heads = conf["num_attention_heads"]
        return cls(
            layers=conf["num_hidden_layers"],
            d_model=conf["hidden_size"],
            heads=heads,
            kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
            d_ff=conf["intermediate_size"],
            vocab=conf["vocab_size"],
            qk_norm=conf["model_type"] in QK_NORM_MODEL_TYPES,
            tied=bool(conf["tie_word_embeddings"]),
            eps=float(conf["rms_norm_eps"]),
            theta=float(conf["rope_theta"]),
        )


@dataclasses.dataclass(frozen=True)
class Precision:
    """How a matrix product's operands are rounded: ``operand`` on each input
    in the forward pass, ``result`` on its output (whose backward rounds the
    gradient that flows into the product)."""

    operand: Callable[[torch.Tensor], torch.Tensor]
    result: Callable[[torch.Tensor], torch.Tensor]

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.result(torch.einsum(spec, self.operand(a), self.operand(b)))


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


EXACT = Precision(_same, _same)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions 0..S-1.  Angles in float64, then float32."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int, prec: Precision):
    """Rows ``start .. start + c`` of causal attention: q (B, c, KV, G, D)
    over the keys and values (B, S, KV, D) up to the last row's position."""
    c, d = q.shape[1], q.shape[-1]
    end = start + c
    s = prec.einsum("bqkgd,bskd->bkgqs", q, k[:, :end]) * (d**-0.5)
    rows = torch.arange(start, end, device=q.device)[:, None]
    cols = torch.arange(end, device=q.device)[None, :]
    s = s.masked_fill(cols > rows, -math.inf)
    p = torch.softmax(s, dim=-1)
    return prec.einsum("bkgqs,bskd->bqkgd", p, v[:, :end])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal GQA: q (B, S, H, D), k and v (B, S, KV, D) -> (B, S, H, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    blocks = [
        checkpoint(_attend_rows, qg[:, i : i + ROW_BLOCK], k, v, i, prec, use_reentrant=False)
        for i in range(0, s, ROW_BLOCK)
    ]
    return torch.cat(blocks, dim=1).reshape(b, s, h, d)


def _layer(dims: Dims, prec: Precision, h: torch.Tensor, p: dict) -> torch.Tensor:
    b, s, _ = h.shape
    a = p["attn"]
    x = rms_norm(h, p["ln1"], dims.eps)
    q = prec.einsum("bsd,dhk->bshk", x, a["wq"])
    k = prec.einsum("bsd,dhk->bshk", x, a["wk"])
    v = prec.einsum("bsd,dhk->bshk", x, a["wv"])
    if dims.qk_norm:
        q = rms_norm(q, a["q_norm"], dims.eps)
        k = rms_norm(k, a["k_norm"], dims.eps)
    o = attention(rope(q, dims.theta), rope(k, dims.theta), v, prec)
    h = h + prec.einsum("bshk,hkd->bsd", o, a["wo"])
    m = p["mlp"]
    x = rms_norm(h, p["ln2"], dims.eps)
    gate = torch.nn.functional.silu(prec.einsum("bsd,df->bsf", x, m["wg"]))
    up = prec.einsum("bsd,df->bsf", x, m["wi"])
    return h + prec.einsum("bsf,fd->bsd", gate * up, m["wo"])


def _layer_params(blocks: dict, i: int) -> dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i]) for k, v in blocks.items()}


def _xent_rows(prec: Precision, h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor):
    logits = prec.einsum("nd,dv->nv", h, head)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss(dims: Dims, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: Precision = EXACT) -> torch.Tensor:  # fmt: skip
    """Mean next-token cross-entropy of ``tokens`` (B, S) against ``labels``."""
    h = params["embed"][tokens.long()]
    for i in range(dims.layers):
        lp = _layer_params(params["blocks"], i)
        h = checkpoint(_layer, dims, prec, h, lp, use_reentrant=False)
    h = rms_norm(h, params["ln_f"], dims.eps).reshape(-1, dims.d_model)
    head = params["embed"].T if dims.tied else params["head"]
    flat = labels.reshape(-1)
    total = sum(
        checkpoint(_xent_rows, prec, h[r : r + LOSS_ROWS], head, flat[r : r + LOSS_ROWS],
                   use_reentrant=False)  # fmt: skip
        for r in range(0, flat.numel(), LOSS_ROWS)
    )
    return total / flat.numel()
