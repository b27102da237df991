"""AdamW with warmup-cosine schedule, over a parameter tree of tensors.

The port of ``repro.train.optimizer``.  Moments are kept in float32 whatever
the parameter dtype; the update is computed in float32 and cast back to the
parameter's dtype.  ``update`` writes the moments and the parameters in
place (under ``torch.no_grad()``) and returns them: the reference donates
the train state to its step, so the old state is gone there too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, 0-d


def init(params) -> OptState:
    """Zero moments in float32 beside each param, on its device."""

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    count = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(mu=tree_map(f32, params), nu=tree_map(f32, params), count=count)


def init_shapes(param_shapes) -> OptState:
    """The state's shapes and dtypes on the ``meta`` device (no allocation)."""

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return OptState(
        mu=tree_map(f32, param_shapes),
        nu=tree_map(f32, param_shapes),
        count=torch.empty((), dtype=torch.int32, device="meta"),
    )


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), in float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, cfg: OptConfig) -> tuple[Any, OptState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the params and moments
    are updated in place and returned."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, count)
    c32 = count.float()
    bias1, bias2 = 1 - cfg.b1**c32, 1 - cfg.b2**c32
    for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu), tree_leaves(params),
        strict=True,
    ):  # fmt: skip
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        upd = (m / bias1) / (torch.sqrt(v / bias2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * upd)
    return params, OptState(state.mu, state.nu, count), gnorm
