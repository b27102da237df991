"""AdamW with global-norm clipping and a warmup-cosine schedule, written from
its definition over a dict tree of float32 tensors.

Per step ``t`` (counting from 1), with ``g`` every leaf's gradient:

    n     = sqrt(sum over leaves of sum(g * g))
    g    *= min(clip / max(n, 1e-9), 1)
    lr    = lr_max * min(t / max(warmup, 1), 1) * (0.1 + 0.9 * (1 + cos(pi * f)) / 2)
            with f = clamp((t - warmup) / max(total - warmup, 1), 0, 1)
    m     = b1 * m + (1 - b1) * g
    v     = b2 * v + (1 - b2) * g * g
    p    -= lr * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

Moments are float32.  ``round_to`` gives the dtype the parameters are
stored in: after the update each parameter is rounded to it (and kept as
float32 holding that value), as a model stored in bfloat16 would be.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    grad_clip: float


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in sorted-key order, depth first."""
    out = []
    for key in sorted(tree):
        sub = tree[key]
        path = f"{prefix}{key}"
        out.extend(leaves(sub, path + "/") if isinstance(sub, dict) else [(path, sub)])
    return out


def learning_rate(hp: Hyper, t: int) -> float:
    warm = min(t / max(hp.warmup_steps, 1), 1.0)
    frac = min(max((t - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1), 0.0), 1.0)
    return hp.lr * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))


@torch.no_grad()
def step(hp: Hyper, t: int, params: dict, grads: dict, m: dict, v: dict,
         round_to: torch.dtype) -> None:  # fmt: skip
    """Update ``params``, ``m`` and ``v`` (float32 trees) in place at step ``t``."""
    gs = dict(leaves(grads))
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in gs.values()))
    scale = min(hp.grad_clip / max(norm, 1e-9), 1.0)
    lr = learning_rate(hp, t)
    bias1, bias2 = 1.0 - hp.b1**t, 1.0 - hp.b2**t
    ms, vs = dict(leaves(m)), dict(leaves(v))
    for path, p in leaves(params):
        g = gs[path] * scale
        ms[path].mul_(hp.b1).add_(g, alpha=1.0 - hp.b1)
        vs[path].mul_(hp.b2).addcmul_(g, g, value=1.0 - hp.b2)
        upd = (ms[path] / bias1) / (torch.sqrt(vs[path] / bias2) + hp.eps) + hp.weight_decay * p
        p.sub_(lr * upd)
        p.copy_(p.to(round_to).float())
