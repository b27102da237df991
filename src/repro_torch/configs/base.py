"""Model / shape configuration dataclasses for the assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    # attention pattern: every `global_every`-th layer is global, others use
    # a sliding window of `local_window` (0 = all layers global/full)
    local_window: int = 0
    global_every: int = 0           # e.g. 6 -> pattern LLLLLG (5:1)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # RWKV6
    rwkv_head_dim: int = 64
    # RecurrentGemma / Griffin
    d_rnn: int = 0                  # RG-LRU recurrence width (0 = d_model)
    conv_width: int = 4
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    # encoder-decoder (whisper): n_layers = decoder layers
    n_enc_layers: int = 0
    src_len: int = 1500             # stub frontend (frames / patches) length
    # vlm
    n_patches: int = 0
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True
    # ---- §Perf hillclimb levers (see EXPERIMENTS.md) ----
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    dispatch_groups: int = 1       # MoE: shard-local dispatch groups (EP a2a)
    ring_local_cache: bool = False # decode: window-length cache for local layers

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        d, nl = self.d_model, self.n_layers
        emb = self.vocab * d
        attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * d
        if self.family == "ssm":  # rwkv6: time-mix (r,k,v,g,o) + channel-mix
            attn = 5 * d * d
        mlp = 3 * d * self.d_ff
        if self.n_experts:
            mlp = self.n_experts * 3 * d * self.d_ff_expert
            if self.shared_expert:
                mlp += 3 * d * self.d_ff
        core = nl * (attn + mlp)
        if self.family == "hybrid" and self.block_pattern:
            # recurrent blocks replace attention with RG-LRU (~4 d*d_rnn)
            rnn = self.d_rnn or d
            frac_rec = self.block_pattern.count("rec") / len(self.block_pattern)
            rec_blk = 4 * d * rnn + mlp
            attn_blk = attn + mlp
            core = int(nl * (frac_rec * rec_blk + (1 - frac_rec) * attn_blk))
        if self.family == "encdec":
            # GELU MLPs (2 matrices); decoder = self+cross attn, encoder = self
            mlp_e = 2 * d * self.d_ff
            core = nl * (2 * attn + mlp_e) + self.n_enc_layers * (attn + mlp_e)
        return emb + core

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.n_params
        d, nl = self.d_model, self.n_layers
        dense = self.n_params - nl * self.n_experts * 3 * d * self.d_ff_expert
        active_mlp = nl * self.top_k * 3 * d * self.d_ff_expert
        return dense + active_mlp

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        pattern = self.block_pattern[: 3] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if not pattern else 2 * len(pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128,
            d_ff_expert=96 if self.n_experts else 0,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            local_window=min(self.local_window, 8) if self.local_window else 0,
            d_rnn=32 if self.d_rnn else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            src_len=16 if self.n_enc_layers or self.n_patches else self.src_len,
            n_patches=8 if self.n_patches else 0,
            rwkv_head_dim=16,
            dtype="float32",
            block_pattern=pattern,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing; only these families run it
# (see DESIGN.md §5 for the skip rationale per arch).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")
