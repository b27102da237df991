"""Layer library: param specs, norms, rotary, attention, MLP, MoE.

The port of ``repro.models.layers``.  Params are nested dicts of tensors
built from ``PSpec`` trees with the reference's keys and stacked shapes;
every param carries logical axis names (a parallel tree).  ``shard`` is the
identity: the sharding hook comes with ``launch/`` (``ROADMAP.md`` queue 1,
item 9).  ``checkpoint_fn`` is the reference's remat policy on
``torch.utils.checkpoint``.

``flash_attention`` runs K9 (``kernels.flash_attention``) on a CUDA tensor,
under autograd through ``K9Attention``, and a plain twin of the reference's
chunked online softmax on a CPU one.  ``moe_fwd`` is the reference's
capacity-based dispatch in PyTorch ops: the reference too computes the
router, the scatter and the expert products outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch.kernels import flash_attention as _k9

NEG_INF = -1e30


def shard(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Annotate an activation with logical axes: the identity without a mesh."""
    return x


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier (fan-in applied below)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _rebuild(tree: tuple, items) -> tuple:
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts and tuples (named tuples
    keep their type); a leaf is anything else (``PSpec``, tensor, array)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(tree, [tree_map(fn, sub) for sub in tree])
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    tuples (named tuples too) in order, depth first.  The one flattening of
    the port: the gradient digest, checkpoints and the weight carry-over all
    read leaves in this order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError(f"more leaves than {type(like).__name__} holds")
    return out


_INIT_CHUNK = 1 << 26  # elements drawn at a time: 256 MiB of float32


def _init_leaf(spec: PSpec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    # Filled in place, a chunk at a time, so that the float32 draws of a
    # stacked leaf never exist whole beside it: a full-depth model's weights
    # then need only their own size on the device.
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for chunk in out.view(-1).split(_INIT_CHUNK):
        x = torch.randn(chunk.numel(), generator=gen, dtype=torch.float32, device=device)
        chunk.copy_(x.mul_(std))
    return out


def materialize(spec_tree, gen: torch.Generator, dtype, device) -> Any:
    """Turn a PSpec tree into a param tree on ``device`` (``gen``'s), drawing
    each normal leaf from ``gen`` in the reference's leaf order."""
    if isinstance(spec_tree, dict):
        return {key: materialize(spec_tree[key], gen, dtype, device) for key in sorted(spec_tree)}
    return _init_leaf(spec_tree, gen, dtype, device)


def axes_tree(spec_tree) -> Any:
    """Extract the logical-axes tree (same structure as params)."""
    return tree_map(lambda s: s.axes, spec_tree)


def spec_shapes(spec_tree, dtype) -> Any:
    """Meta tensors of every param's shape and dtype (no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), spec_tree)


# ---------------------------------------------------------------------------
# Remat policy selection
# ---------------------------------------------------------------------------
# the matrix products' outputs, which ``jax.checkpoint_policies.checkpoint_dots``
# saves: ``torch.einsum`` reaches them as these operators
_PRODUCTS = {
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
}


def _save_products(ctx, op, *args, **kwargs):
    policy = ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _PRODUCTS else policy.PREFER_RECOMPUTE


def checkpoint_fn(body, cfg):
    """Wrap a layer body with the configured rematerialization policy:
    ``"full"`` keeps only the body's inputs and recomputes the rest in the
    backward pass, ``"dots"`` also keeps the products' outputs.  With
    gradients off (prefill, serving) there is no backward pass to save for,
    so the body is returned as it is."""
    if not cfg.remat or not torch.is_grad_enabled():
        return body
    kw = {}
    if getattr(cfg, "remat_policy", "full") == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_products)  # fmt: skip
    return functools.partial(ckpt.checkpoint, body, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Normalization / rotary
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embeddings.  x: (..., S, H, D), pos: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    if pos.dim() == 1:
        ang = pos[:, None].float() * freqs[None, :]  # (S, half)
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = pos[..., None].float() * freqs  # (B, S, half)
        ang = ang[:, :, None, :]  # (B, S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style attention
# ---------------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,  # (B, Sq, KV, G, D)  G = heads per kv group
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unbounded
    q_offset: int = 0,  # absolute position of q[0]
    k_positions: torch.Tensor | None = None,  # (Sk,) absolute key positions
    chunk_q: int = 512,
    chunk_k: int = 512,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention that never materializes (Sq, Sk).

    On a CUDA tensor: K9 for the models' call (``q_offset == 0``, no
    ``k_positions``, as every model of the reference makes it), through
    ``kernels.flash_attention.K9Attention``: K9 forward on ``(B, H, S, D)``
    views of the ``(B, S, H, D)`` tensors, no copies, and under autograd
    the gradient of the chunked softmax below.  Other offsets or key
    positions raise ``NotImplementedError`` there.  On a CPU tensor: the
    reference's chunked online softmax, padding and key-validity mask
    included, differentiated by autograd.
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cuda":
        if q_offset != 0 or k_positions is not None:
            raise NotImplementedError(
                "flash_attention on the card takes q_offset 0 and no k_positions, the models' "
                "call: K9 masks by row and column index (ROADMAP.md queue 1, item 8)"
            )
        return _k9.K9Attention.apply(q, k, v, causal, int(window), scale)
    return _chunked_attention(q, k, v, causal, int(window), int(q_offset), k_positions,
                              chunk_q, chunk_k, scale)  # fmt: skip


def _chunked_attention(q, k, v, causal, window, q_offset, k_positions, chunk_q, chunk_k, scale):
    """The reference's double-chunked online softmax, step for step."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    dev = q.device
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    pq, pk = (-sq) % cq, (-sk) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (sq + pq) // cq, (sk + pk) // ck
    if k_positions is None:
        kpos_all = torch.arange(sk + pk, dtype=torch.int32, device=dev)
        kvalid_all = kpos_all < sk
    else:
        kpos_all = F.pad(k_positions.to(torch.int32), (0, pk), value=-1)
        kvalid_all = kpos_all >= 0
    out = []
    for qi in range(nq):
        q_blk = q[:, qi * cq : (qi + 1) * cq]
        qpos = q_offset + qi * cq + torch.arange(cq, dtype=torch.int32, device=dev)
        acc = torch.zeros((b, cq, kvh, g, d), dtype=torch.float32, device=dev)
        m = torch.full((b, cq, kvh, g), -math.inf, dtype=torch.float32, device=dev)
        lse = torch.zeros((b, cq, kvh, g), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk, v_blk = k[:, ki * ck : (ki + 1) * ck], v[:, ki * ck : (ki + 1) * ck]
            kpos = kpos_all[ki * ck : (ki + 1) * ck]
            s = torch.einsum("bqkgd,bskd->bqkgs", q_blk.float(), k_blk.float()) * scale
            mask = kvalid_all[ki * ck : (ki + 1) * ck][None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lse = lse * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_blk.dtype).float(), v_blk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out.append(acc / torch.clamp(lse[..., None], min=1e-30))
    full = torch.cat(out, dim=1)
    return full[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, KV, G, D)
    k_cache: torch.Tensor,  # (B, L_cache, KV, D)
    v_cache: torch.Tensor,  # (B, L_cache, KV, D)
    k_pos: torch.Tensor,  # (B, L_cache) absolute positions (-1 = empty)
    pos: int,  # current absolute position
    *,
    window: int = 0,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bqkgs", q.float(), k_cache.float()) * scale
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window > 0:
        valid = valid & (k_pos > pos - window)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (GQA + optional qk_norm + rope)
# ---------------------------------------------------------------------------
def attention_specs(cfg, d_model: int | None = None) -> dict[str, PSpec]:
    d = d_model or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sp = {
        "wq": PSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = PSpec((hd,), ("head_dim",), init="zeros")
        sp["k_norm"] = PSpec((hd,), ("head_dim",), init="zeros")
    return sp


def attention_fwd(
    p: dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    cfg,
    *,
    causal: bool = True,
    window: int = 0,
    positions: torch.Tensor | None = None,  # (S,) absolute positions
    use_rope: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    if positions is None:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
    else:
        pos = positions

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        kk = rms_norm(kk, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        kk = rope(kk, pos, cfg.rope_theta)

    qg = q.reshape(b, s, kv, g, hd)
    out = flash_attention(
        qg, kk, vv, causal=causal, window=window,
        q_offset=int(pos[0]) if positions is not None else 0,
    )  # fmt: skip
    out = out.reshape(b, s, h, hd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (kk, vv)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_specs(cfg, d_ff: int | None = None) -> dict[str, PSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": PSpec((d, f), ("embed", "mlp")),
        "wg": PSpec((d, f), ("embed", "mlp")),
        "wo": PSpec((f, d), ("mlp", "embed")),
    }


def mlp_fwd(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"])) * torch.einsum("bsd,df->bsf", x, p["wi"])
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# ---------------------------------------------------------------------------
# MoE (capacity-based, sort-free dispatch)
# ---------------------------------------------------------------------------
def moe_specs(cfg) -> dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    sp: dict[str, Any] = {
        "router": PSpec((d, e), ("embed", None)),
        "wi": PSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wg": PSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wo": PSpec((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.shared_expert:
        sp["shared"] = mlp_specs(cfg)
    return sp


def moe_capacity(cfg, tg: int) -> int:
    """The slots each expert takes in a dispatch group of ``tg`` tokens:
    ``max(int(tg * top_k / E * capacity_factor), 4)``, in Python floats as
    the reference computes it."""
    return max(int(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Each token's ``k`` experts and their gates, ``(g, tg, k)`` each.

    The router's logits are taken in the input's dtype and softmaxed in
    float32.  The experts come in ``jax.lax.top_k``'s order: descending, the
    lower index first on a tie (``torch.topk`` promises no order on a tie,
    a stable sort does).  The gates are normalised by their sum."""
    probs = torch.softmax(torch.einsum("gtd,de->gte", xt, router).float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), idx


def moe_fwd(p: dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-based sort-free MoE dispatch (one-hot position ranking).

    Tokens above an expert's capacity (``moe_capacity``) are dropped: their
    choice goes to a pad slot and weighs 0.  With ``cfg.dispatch_groups`` =
    G > 1 the T tokens are split into G groups of T/G, each with its own
    capacity, ranked within the group.  A (token, choice) pair's rank is
    the exclusive count of earlier pairs for the same expert in (token,
    choice) order."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = max(cfg.dispatch_groups, 1)
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} dispatch groups")
    tg = t // g
    cap = moe_capacity(cfg, tg)
    xt = x.reshape(g, tg, d)
    gate, idx = moe_route(p["router"], xt, k)

    eidx = idx.reshape(g, tg * k)
    flat = F.one_hot(eidx, e)  # (g, tg*k, e)
    rank = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)  # exclusive prefix
    keep = rank < cap
    slot = torch.where(keep, rank, cap)  # overflow -> pad slot

    # scatter into (g, e, cap+1, d) buffers: each (expert, slot) below cap
    # takes one pair; the pad slot may take several and is dropped
    gi = torch.arange(g, device=x.device)[:, None]
    tokens_rep = xt.reshape(g * tg, d).repeat_interleave(k, dim=0).reshape(g, tg * k, d)
    buf = x.new_zeros((g, e, cap + 1, d))
    buf[gi, eidx, slot] = tokens_rep
    buf = buf[:, :, :cap]

    hg = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    hi = torch.einsum("gecd,edf->gecf", buf, p["wi"])
    out_buf = torch.einsum("gecf,efd->gecd", hg * hi, p["wo"])  # (g, e, cap, d)

    out_tok = out_buf[gi, eidx, torch.clamp(slot, max=cap - 1)]  # (g, tg*k, d)
    w = (gate.reshape(g, tg * k) * keep).to(out_tok.dtype)
    out = (out_tok * w[..., None]).reshape(g, tg, k, d).sum(dim=2).reshape(t, d)
    if cfg.shared_expert:
        out = out + mlp_fwd(p["shared"], x).reshape(t, d)
    return out.reshape(b, s, d)
