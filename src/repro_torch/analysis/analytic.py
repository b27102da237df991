"""Analytic per-device FLOPs / HBM-bytes models for the roofline.

Why this exists: the port runs eagerly in PyTorch, so no compiled program
states a step's work, and a profiler counts only what one run launched,
not what the architecture must do.  The compute and memory terms are
therefore derived analytically from the architecture, the step's shape and
the placement (``MeshInfo``), as the reference derives them (its own
reason: XLA:CPU's ``cost_analysis`` counts a ``while`` body once, whatever
its trip count).  Nothing here depends on the hardware: the rates live in
``analysis.roofline``.  The arithmetic is the reference's, operation for
operation, so both packages give the same floats; ``ModelConfig.n_params``
stays the reference's approximate count for that reason.

Conventions:
  * FLOPs count multiply-adds as 2.
  * train  = fwd + bwd (3x fwd matmul FLOPs) + optimizer elementwise.
  * remat: the fwd is recomputed once inside bwd (policy: save only layer
    boundaries), so matmul FLOPs = 4x fwd instead of 3x.
  * bytes: parameter traffic (fwd read + bwd read + recompute read + Adam
    read/write) + activation traffic (layer-boundary saves r/w) + batch IO,
    all divided by the sharded degree where applicable.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    chips: int
    dp: int  # batch-sharding degree (pod*data) actually dividing batch
    fsdp: int  # parameter-sharding degree over 'data'
    tp: int  # tensor degree over 'model'

    @classmethod
    def for_mesh(cls, multi_pod: bool, global_batch: int, rules: str = "base") -> MeshInfo:
        chips = 512 if multi_pod else 256
        dp_axes = 32 if multi_pod else 16
        dp = dp_axes if global_batch % dp_axes == 0 else 1
        # serve rules are weight-stationary: params shard over TP only
        fsdp = 1 if rules == "serve" else 16
        return cls(chips=chips, dp=dp, fsdp=fsdp, tp=16)


def _attn_flops_per_layer(cfg: ModelConfig, s: int, window: int) -> float:
    """Score+PV matmul FLOPs for one layer, one sequence (fwd)."""
    eff = min(window, s) if window else s
    # causal halves the full-window part; sliding window is ~s*eff
    pairs = s * eff / (2 if not window else 1)
    return 2.0 * 2.0 * pairs * cfg.n_heads * cfg.hd


def _layer_windows(cfg: ModelConfig) -> tuple[int, int]:
    """(n_global_layers, n_local_layers)."""
    if cfg.local_window == 0:
        return cfg.n_layers, 0
    if cfg.global_every == 0:
        return 0, cfg.n_layers
    n_global = cfg.n_layers // cfg.global_every
    return n_global, cfg.n_layers - n_global


def _seq_mix_flops(cfg: ModelConfig, s: int, batch: int, kind: str) -> float:
    """Sequence-mixing FLOPs beyond the 6N/2N param term (global, fwd)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        n_g, n_l = _layer_windows(cfg)
        per_seq = n_g * _attn_flops_per_layer(cfg, s, 0) + n_l * _attn_flops_per_layer(
            cfg, s, cfg.local_window
        )
        return batch * per_seq
    if fam == "ssm":
        # wkv: per token per layer: state update + readout ~ 4*H*hd^2
        h, hd = cfg.n_heads, cfg.rwkv_head_dim
        return batch * s * cfg.n_layers * 4.0 * h * hd * hd
    if fam == "hybrid":
        n_attn = cfg.n_layers // len(cfg.block_pattern)
        per_seq = n_attn * _attn_flops_per_layer(cfg, s, cfg.local_window)
        # RG-LRU elementwise + conv: ~ (2*conv_width + 10) * d_rnn per token
        rec = cfg.n_layers - n_attn
        per_seq += s * rec * (2.0 * cfg.conv_width + 10.0) * (cfg.d_rnn or cfg.d_model)
        return batch * per_seq
    if fam == "encdec":
        dec_self = cfg.n_layers * _attn_flops_per_layer(cfg, s, 0)
        f = cfg.src_len
        dec_cross = cfg.n_layers * 2.0 * 2.0 * s * f * cfg.n_heads * cfg.hd
        enc = cfg.n_enc_layers * 2.0 * 2.0 * f * f * cfg.n_heads * cfg.hd
        return batch * (dec_self + dec_cross + enc)
    raise ValueError(fam)


def _decode_seq_mix_flops(cfg: ModelConfig, ctx: int, batch: int) -> float:
    """One-token sequence mixing (fwd only)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        n_g, n_l = _layer_windows(cfg)
        eff_l = min(cfg.local_window or ctx, ctx)
        per_tok = (n_g * ctx + n_l * eff_l) * 4.0 * cfg.n_heads * cfg.hd
        return batch * per_tok
    if fam == "ssm":
        h, hd = cfg.n_heads, cfg.rwkv_head_dim
        return batch * cfg.n_layers * 4.0 * h * hd * hd
    if fam == "hybrid":
        n_attn = cfg.n_layers // len(cfg.block_pattern)
        eff = min(cfg.local_window, ctx)
        per_tok = n_attn * eff * 4.0 * cfg.n_heads * cfg.hd
        per_tok += (cfg.n_layers - n_attn) * (2.0 * cfg.conv_width + 10.0) * (
            cfg.d_rnn or cfg.d_model
        )
        return batch * per_tok
    if fam == "encdec":
        per_tok = cfg.n_layers * (ctx + cfg.src_len) * 4.0 * cfg.n_heads * cfg.hd
        return batch * per_tok
    raise ValueError(fam)


def _param_bytes(cfg: ModelConfig) -> float:
    return float(cfg.n_params) * 2.0  # bf16


def _cache_bytes(cfg: ModelConfig, batch: int, ctx: int) -> float:
    fam = cfg.family
    if fam == "ssm":
        h, hd = cfg.n_heads, cfg.rwkv_head_dim
        return batch * cfg.n_layers * (h * hd * hd * 4.0 + 2 * cfg.d_model * 2.0)
    if fam == "hybrid":
        n_super = cfg.n_layers // len(cfg.block_pattern)
        c = min(cfg.local_window, ctx)
        kv = n_super * batch * c * cfg.n_kv_heads * cfg.hd * 2 * 2.0
        rec = (cfg.n_layers - n_super) * batch * (cfg.d_rnn or cfg.d_model) * 4.0
        return kv + rec
    extra = 0.0
    if fam == "encdec":
        extra = cfg.n_layers * batch * cfg.src_len * cfg.n_kv_heads * cfg.hd * 2 * 2.0
    if cfg.ring_local_cache and cfg.local_window and cfg.global_every:
        # local layers keep window-length ring caches
        n_g, n_l = _layer_windows(cfg)
        cells = n_g * ctx + n_l * min(cfg.local_window, ctx)
        return batch * cells * cfg.n_kv_heads * cfg.hd * 2 * 2.0 + extra
    # baseline: full-length KV for every layer
    return cfg.n_layers * batch * ctx * cfg.n_kv_heads * cfg.hd * 2 * 2.0 + extra


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshInfo) -> dict[str, float]:
    """Returns per-device {flops, hbm_bytes, model_flops} for the step."""
    b, s = shape.global_batch, shape.seq_len
    n_active = float(cfg.n_active_params)
    p_bytes = _param_bytes(cfg)
    shard = mesh.fsdp * mesh.tp  # parameter sharding degree
    d = cfg.d_model

    if shape.kind == "train":
        tokens = b * s
        matmul = 2.0 * n_active * tokens  # fwd
        mix = _seq_mix_flops(cfg, s, b, "train")
        # remat policy: full = fwd recomputed in bwd (4x fwd total);
        # dots = matmul outputs saved, no recompute (3x), more act traffic
        if cfg.remat and cfg.remat_policy == "full":
            flops_mult, act_mult = 4.0, 1.0
        else:
            flops_mult, act_mult = 3.0, 4.5
        flops_global = flops_mult * (matmul + mix)
        flops_global += 10.0 * (p_bytes / 2.0)  # Adam elementwise
        # memory per device: params fwd+recompute+bwd grads rw + Adam state
        p_loc = p_bytes / shard
        # reads fwd/remat/bwd + mu,nu rw(f32) + grad rw
        param_traffic = p_loc * (1 + 1 + 1) + (p_loc / 2) * (4 + 4) * 2 + p_loc * 2
        act_save = cfg.n_layers * (b / mesh.dp) * s * d * 2.0 * 2 * act_mult
        io = (b / mesh.dp) * s * 4.0 * 2
        logits = (b / mesh.dp) * s * (cfg.vocab / mesh.tp) * 2.0 * 2
        bytes_dev = param_traffic + act_save + io + logits
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = b * s
        flops_global = 2.0 * n_active * tokens + _seq_mix_flops(cfg, s, b, "prefill")
        p_loc = p_bytes / shard
        act = cfg.n_layers * (b / mesh.dp) * s * d * 2.0
        cache = _cache_bytes(cfg, b, s) / mesh.chips
        bytes_dev = p_loc + act + cache
        model_flops = 2.0 * n_active * tokens
    else:  # decode
        tokens = b
        flops_global = 2.0 * n_active * tokens + _decode_seq_mix_flops(cfg, s, b)
        p_loc = p_bytes / shard
        cache = _cache_bytes(cfg, b, s) / mesh.chips
        bytes_dev = p_loc + cache * 1.0  # read cache + write 1 slot (~read)
        model_flops = 2.0 * n_active * tokens

    return {
        "flops": flops_global / mesh.chips,
        "hbm_bytes": bytes_dev,
        "model_flops": model_flops,
    }
