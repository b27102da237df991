"""Layer library: param specs, norms, rotary and sinusoidal positions,
attention, MLP, MoE.

The port of ``repro.models.layers``.  Params are nested dicts of tensors
built from ``PSpec`` trees with the reference's keys and stacked shapes;
every param carries logical axis names (a parallel tree) that
``launch/sharding.py`` maps onto mesh axes.  Model code annotates
activations with ``shard`` calls: the identity on a plain tensor or with no
sharder installed, and under ``launch.sharding.install`` a redistribution
of a DTensor activation to its resolved placements.  Tensors the layers
make themselves (positions, rotary angles, masks) meet DTensor activations
through ``replicated_like``.  ``checkpoint_fn`` is the reference's remat
policy on ``torch.utils.checkpoint``.

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
from collections.abc import Callable
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch.core.device import resolve_device
from repro_torch.kernels import flash_attention as _k9

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Activation sharding hook (installed by launch/sharding.py)
# ---------------------------------------------------------------------------
_ACTIVATION_SHARDER: Callable[[torch.Tensor, tuple], torch.Tensor] | None = None
_FSDP_AXES: tuple[str, ...] = ()  # mesh axes whose param splits ``layer`` gathers


def set_activation_sharder(fn: Callable | None, fsdp_axes: tuple[str, ...] = ()) -> None:
    """Install ``fn`` as ``shard``'s sharder (``None``: none), and the mesh
    axes that split params FSDP-wise, which ``layer`` gathers."""
    global _ACTIVATION_SHARDER, _FSDP_AXES
    _ACTIVATION_SHARDER = fn
    _FSDP_AXES = tuple(fsdp_axes)


def shard(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Annotate an activation with logical axes (no-op without a sharder)."""
    if _ACTIVATION_SHARDER is None:
        return x
    return _ACTIVATION_SHARDER(x, axes)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, made alike on every rank, as a replicated DTensor on ``ref``'s
    mesh where ``ref`` is a DTensor; else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def gathered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim`` on every rank: a DTensor split there is
    gathered (its other splits kept); a plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.dim()
    return x.redistribute(placements=[Replicate() if p == Shard(dim) else p for p in x.placements])


def whole(x: torch.Tensor) -> torch.Tensor:
    """The full tensor of a DTensor, the same on every rank; else ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (``Partial`` made
    ``Replicate``); else ``x``."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(placements=[Replicate() if p.is_partial() else p for p in x.placements])


def shard_box(shape, placements, mesh, coord) -> tuple[tuple[int, ...], tuple[int, ...], bool]:
    """Where the rank at mesh coordinate ``coord`` holds a tensor of
    ``shape`` placed by ``placements`` (no ``Partial``) on ``mesh``: the
    global index of its shard's first element and the shard's shape, split
    major to minor over the mesh dims as DTensor splits (every split even),
    and whether its copy is the one counted, coordinate 0 on every mesh dim
    that does not split the tensor."""
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways evenly")
            size[p.dim] //= n
            off[p.dim] += coord[i] * size[p.dim]
    counted = all(c == 0 for c, p in zip(coord, placements, strict=True) if not p.is_shard())
    return tuple(off), tuple(size), counted


def layer(tree: Any, *idx) -> Any:
    """The params at ``idx`` of every stacked leaf: views, no copies.  A
    DTensor's split over the FSDP axes that the installed sharder named is
    gathered, as FSDP gathers a layer's weights before running it (its
    gradient is then scattered back); its other splits stay."""

    def at(x):
        x = x[idx]
        if not is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate

        names = x.device_mesh.mesh_dim_names
        keep = [Replicate() if n in _FSDP_AXES else p
                for n, p in zip(names, x.placements, strict=True)]  # fmt: skip
        return x.redistribute(placements=keep)

    return tree_map(at, tree)


def split_last(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``x`` with its last dim cut into ``shape``.  A DTensor split of that
    dim which ``shape[0]`` does not divide is gathered first: DTensor cannot
    cut a split dim unevenly."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        last = Shard(x.dim() - 1)
        ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements) if p == last)
        if shape[0] % ways:
            x = gathered(x, -1)
    return x.reshape(*x.shape[:-1], *shape)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is gathered whole and each rank
    looks up its own tokens (``local_map``): DTensor's own strategies for a
    lookup into a split table and for its gradient differ between torch
    releases and fail on some.  The rows come out split as the tokens are,
    and the table's gradient is a partial sum over the mesh dims that split
    the tokens."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    whole_table = (Replicate(),) * table.device_mesh.ndim
    rows = tuple(tokens.placements)
    grad = tuple(Replicate() if p == Replicate() else Partial() for p in rows)
    fn = local_map(lambda t, i: t[i], out_placements=(rows,), in_placements=(whole_table, rows),
                   in_grad_placements=(grad, rows), redistribute_inputs=True)  # fmt: skip
    return fn(table, tokens)


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
    """``like``'s structure with ``leaves`` in ``tree_leaves`` order (a
    dict's leaves filled in its sorted keys' order, whatever its own)."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            filled = {key: build(tree[key]) for key in sorted(tree)}
            return {key: filled[key] for key in tree}
        if isinstance(tree, tuple):
            return _rebuild(tree, [build(sub) for sub in tree])
        return next(it)

    out = build(like)
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


def stacked(spec: PSpec, n: int) -> PSpec:
    """``spec`` for ``n`` layers at once: a leading ``layers`` dim."""
    return PSpec((n,) + spec.shape, ("layers",) + spec.axes, spec.init, spec.scale)


def empty_cache(specs: dict[str, torch.Tensor], device=None) -> dict[str, torch.Tensor]:
    """A decode cache of ``specs``' shapes and dtypes on ``device`` (``None``:
    the card, as for ``ServeLoop``): zero keys, values and states, int32
    positions -1."""
    dev = resolve_device(device)
    return {
        name: torch.full(sp.shape, -1, dtype=sp.dtype, device=dev)
        if sp.dtype == torch.int32
        else torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
        for name, sp in specs.items()
    }


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
def wide(dtype: torch.dtype) -> torch.dtype:
    """float32, or ``dtype`` where that is wider: the type the reference
    takes norms and recurrences in (float32), kept float64 in a float64 run."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(wide(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.to(x32.dtype))).to(x.dtype)


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
    sin, cos = replicated_like(torch.sin(ang), x), replicated_like(torch.cos(ang), x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(seq, d) float32 sinusoidal embeddings of positions ``offset`` on:
    the sines of the even dims' angles, then their cosines."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


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
    positions raise ``NotImplementedError`` there.  q, k and v of mixed
    dtypes (whisper's bf16 queries on float32 encoder keys) go to K9 in the
    wider one, as the reference's products promote them, and the output
    comes back in q's dtype.  On a CPU tensor: the
    reference's chunked online softmax, padding and key-validity mask
    included, differentiated by autograd.  On a ``meta`` tensor (the dry
    run's trace) the whole sequence is one chunk: the same products, as
    every block is computed, in far fewer operations to trace.
    """
    d = q.shape[-1]
    if q.device.type == "meta":
        chunk_q, chunk_k = q.shape[1], k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cuda":
        if q_offset != 0 or k_positions is not None:
            raise NotImplementedError(
                "flash_attention on the card takes q_offset 0 and no k_positions, the models' "
                "call: K9 masks by row and column index (ROADMAP.md queue 1, item 8)"
            )
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        out = _k9.K9Attention.apply(q.to(dt), k.to(dt), v.to(dt), causal, int(window), scale)
        return out.to(q.dtype)
    return _chunked_attention(q, k, v, causal, int(window), int(q_offset), k_positions,
                              chunk_q, chunk_k, scale)  # fmt: skip


def _grouped_attention(q, k, v, kv: int, **kw) -> torch.Tensor:
    """``flash_attention`` of (B, S, H, D) queries over (B, Sk, KV, D) keys
    and values, grouped as the reference groups them (H = KV x G, head
    ``j`` on key head ``j // G``); returns (B, S, H, D).

    On DTensors it runs through ``local_map``: K9 on the card, or the plain
    route on the CPU, sees each rank's local batch and heads.  A mesh dim
    that shards q's batch (dim 0) or heads (dim 2) keeps that split, the
    keys' batch alike; any other split is gathered first.  Where the heads
    take a mesh dim the key heads could not (KV indivisible, so the keys
    are whole on every rank), each rank's query heads meet their own key
    heads: the slice of them its heads use, or, where its heads straddle a
    group's edge, one key head a query head.  Their gradients are then
    partial sums over that mesh dim."""
    if not is_dtensor(q):
        return _local_gqa(q, k, v, None, 0, **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    g = q.shape[2] // kv
    head0 = None
    qp, kp, kgrad = [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements, strict=True)):
        if pq == Shard(0) or (pq == Shard(2) and pk == Shard(2)):
            qp.append(pq)
            kp.append(pq)
            kgrad.append(pq)
        elif pq == Shard(2):
            qp.append(pq)
            kp.append(Replicate())
            kgrad.append(Partial())
            head0 = mesh.get_local_rank(i) * (q.shape[2] // mesh.size(i))
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    qp, kp, kgrad = tuple(qp), tuple(kp), tuple(kgrad)
    fn = local_map(
        functools.partial(_local_gqa, head0=head0, g=g, **kw),
        out_placements=(qp,),
        in_placements=(qp, kp, kp),
        in_grad_placements=(qp, kgrad, kgrad),
        redistribute_inputs=True,
    )
    return fn(q, k, v)


def _local_gqa(q, k, v, head0: int | None, g: int, **kw) -> torch.Tensor:
    """One rank's grouped attention.  ``head0`` is the global index of its
    first query head where its keys are every key head (``g`` heads a
    group), ``None`` where its keys are exactly its heads' groups."""
    b, s, hl, hd = q.shape
    if head0 is None:
        lo, n = 0, k.shape[2]
    else:
        lo, hi = head0 // g, (head0 + hl - 1) // g + 1
        n = hi - lo
    if head0 is None or (head0 % g == 0 and hl == n * g) or n == 1:
        if head0 is not None:
            k, v = k[:, :, lo : lo + n], v[:, :, lo : lo + n]
        qg = q.reshape(b, s, n, hl // n, hd)
    else:
        idx = torch.arange(head0, head0 + hl, device=q.device) // g
        k, v = k[:, :, idx], v[:, :, idx]
        qg = q.reshape(b, s, hl, 1, hd)
    return flash_attention(qg, k, v, **kw).reshape(b, s, hl, hd)


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
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, (k, v)).

    With ``kv_override`` the keys and values are taken as given, (B, Sk,
    KVH, D): no projection and no rope, but ``qk_norm`` where set."""
    s = x.shape[1]
    if positions is None:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
    else:
        pos = positions

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv_override is None:
        kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    else:
        kk, vv = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        kk = rms_norm(kk, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        if kv_override is None:
            kk = rope(kk, pos, cfg.rope_theta)
    q = shard(q, ("batch", None, "heads", None))
    kk = shard(kk, ("batch", None, "kv_heads", None))
    vv = shard(vv, ("batch", None, "kv_heads", None))

    out = _grouped_attention(
        q, kk, vv, cfg.n_kv_heads, causal=causal, window=window,
        q_offset=int(pos[0]) if positions is not None else 0,
    )  # fmt: skip
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return shard(out, ("batch", None, "embed_act")), (kk, vv)


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
    h = shard(h, ("batch", None, "mlp_act"))
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
    xt = shard(x.reshape(g, tg, d), ("batch", None, None))
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
    buf = shard(buf[:, :, :cap], ("batch", "expert", None, None))

    hg = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    hi = torch.einsum("gecd,edf->gecf", buf, p["wi"])
    hh = shard(hg * hi, ("batch", "expert", None, "expert_mlp"))
    out_buf = torch.einsum("gecf,efd->gecd", hh, p["wo"])  # (g, e, cap, d)

    out_tok = out_buf[gi, eidx, torch.clamp(slot, max=cap - 1)]  # (g, tg*k, d)
    w = (gate.reshape(g, tg * k) * keep).to(out_tok.dtype)
    out = (out_tok * w[..., None]).reshape(g, tg, k, d).sum(dim=2).reshape(t, d)
    if cfg.shared_expert:
        out = out + mlp_fwd(p["shared"], x).reshape(t, d)
    return out.reshape(b, s, d)
