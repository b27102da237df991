"""Layer library, the dense subset: param specs, norms, rotary, attention, MLP.

The port of ``repro.models.layers``.  Params are nested dicts of tensors
built from ``PSpec`` trees with the reference's keys and stacked shapes;
every param carries logical axis names (a parallel tree).  ``shard`` is the
identity: the sharding hook comes with ``launch/`` (``ROADMAP.md`` queue 1,
item 9).  Inference only, so there is no ``checkpoint_fn``.

``flash_attention`` runs K9 (``kernels.flash_attention``) on a CUDA tensor
and a plain twin of the reference's chunked online softmax on a CPU one.
MoE (``moe_fwd``) waits for ``ROADMAP.md`` queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

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


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (``PSpec`` or tensor)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


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
    ``k_positions``, as every model of the reference makes it), handed
    ``(B, H, S, D)`` views of the ``(B, S, H, D)`` tensors, no copies; its
    output, laid out as q is, reshapes back for free.  Other offsets or key
    positions raise ``NotImplementedError`` there.  On a CPU tensor: the
    reference's chunked online softmax, padding and key-validity mask
    included.
    """
    b, sq, kvh, g, d = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cuda":
        if q_offset != 0 or k_positions is not None:
            raise NotImplementedError(
                "flash_attention on the card takes q_offset 0 and no k_positions, the models' "
                "call: K9 masks by row and column index (ROADMAP.md queue 1, item 8)"
            )
        # .contiguous() copies only a tensor that is not dense in its own
        # (B, S, ., D) layout; the permutes are views
        qh = q.contiguous().reshape(b, sq, kvh * g, d).permute(0, 2, 1, 3)
        kh = k.contiguous().permute(0, 2, 1, 3)
        vh = v.contiguous().permute(0, 2, 1, 3)
        out = _k9.flash_attention(
            qh, kh, vh, window=int(window), causal=causal, softmax_scale=scale
        )  # (B, H, Sq, D), dense as (B, Sq, H, D)
        return out.permute(0, 2, 1, 3).reshape(b, sq, kvh, g, d)
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


def moe_fwd(p, x, cfg):
    raise NotImplementedError("MoE blocks (moe_fwd) are not ported yet: ROADMAP.md queue 1, item 8")
