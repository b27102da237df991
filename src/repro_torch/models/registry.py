"""Model registry: one uniform interface per architecture family.

The port of ``repro.models.registry``.  Every family module exports
``specs``, ``forward``, ``prefill``, ``decode_step``, ``init_cache`` and
``cache_specs``.  The port holds the transformer families (``dense``,
``moe`` and ``vlm``, all ``transformer``); ``family_module`` raises
``NotImplementedError`` for the others, naming the ``ROADMAP.md`` item that
brings them.

``input_specs`` gives meta tensors for every input of an (arch x shape)
cell, the VLM's patch embeddings (a stub frontend, as in the reference)
among them; ``make_inputs`` concrete ones, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

from . import layers as L
from . import transformer

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer}
_TODO = {
    "ssm": "rwkv6",
    "hybrid": "griffin (recurrentgemma)",
    "encdec": "whisper",
}


def family_module(cfg: ModelConfig):
    if cfg.family in _TODO:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family ({_TODO[cfg.family]}) is not ported yet: "
            "ROADMAP.md queue 1, item 8"
        )
    return _FAMILY[cfg.family]


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    return dtype or getattr(torch, cfg.dtype)


def model_specs(cfg: ModelConfig):
    return family_module(cfg).specs(cfg)


def param_axes(cfg: ModelConfig):
    """The logical axes of every param (the params' tree of axis-name tuples)."""
    return L.axes_tree(model_specs(cfg))


def param_shapes(cfg: ModelConfig, dtype=None):
    """Meta tensors of every param (no allocation)."""
    return L.spec_shapes(model_specs(cfg), _dtype(cfg, dtype))


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=None):
    """Random params on ``gen``'s device, in the reference's tree; every
    normal leaf scaled by its fan-in."""
    return L.materialize(model_specs(cfg), gen, _dtype(cfg, dtype), gen.device)


def count_params(cfg: ModelConfig) -> int:
    return int(sum(t.numel() for t in L.tree_leaves(param_shapes(cfg))))


# ---------------------------------------------------------------------------
# Input specs per (arch x shape) cell
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta tensors for every input of the cell's step function.

    train:   {tokens, labels [, patches]}
    prefill: {tokens [, patches]}
    decode:  {tokens (B,1), cache, pos}
    """
    mod = family_module(cfg)
    b, s = shape.global_batch, shape.seq_len
    dt = _dtype(cfg, None)

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    def frontend() -> dict[str, Any]:
        if cfg.family == "vlm":
            return {"patches": meta((b, cfg.n_patches, cfg.d_model), dt)}
        return {}

    if shape.kind == "train":
        return {"tokens": meta((b, s)), "labels": meta((b, s)), **frontend()}
    if shape.kind == "prefill":
        return {"tokens": meta((b, s)), **frontend()}
    if shape.kind == "decode":
        return {"tokens": meta((b, 1)), "cache": mod.cache_specs(cfg, b, s, dt), "pos": meta(())}
    raise ValueError(shape.kind)


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator) -> dict[str, Any]:
    """Concrete (small-scale) inputs matching ``input_specs``, on ``gen``'s
    device: token ids uniform over the vocab, patch embeddings standard
    normal in float32 cast to the model's dtype."""
    device = gen.device
    out: dict[str, Any] = {}
    for name, sp in input_specs(cfg, shape).items():
        if name == "cache":
            out[name] = family_module(cfg).init_cache(
                cfg, shape.global_batch, shape.seq_len, _dtype(cfg, None), device
            )
        elif name == "pos":
            out[name] = 0
        elif sp.dtype == torch.int32:
            out[name] = torch.randint(
                0, cfg.vocab, sp.shape, generator=gen, dtype=torch.int32, device=device
            )
        else:
            x = torch.randn(sp.shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = x.to(sp.dtype)
    return out
