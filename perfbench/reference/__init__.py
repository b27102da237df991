"""The plain reference of the training cells: a dense decoder, its loss, AdamW
and the gradient digest, in plain PyTorch.  It imports nothing of the
program under test and takes from the benchmark only the inputs the
benchmark made: the weights, the token batches and the hyperparameters.

``train`` runs the first steps of a cell from those inputs and returns the
readings that ``correct`` compares with the program's (``Readings``).
"""

from __future__ import annotations

import dataclasses

import torch

from .adamw import Hyper, leaves, step
from .decoder import EXACT, Dims, Precision, loss


@dataclasses.dataclass
class Readings:
    """What a side reports of its first steps.

    ``losses``: each step's loss.  ``grad1``: each leaf's norm of the first
    gradient as the optimizer gets it, clipped, worked out from the first
    moment after one step (``m / (1 - b1)``).  ``delta``: each leaf's norm of
    its change over the steps.  ``raw1`` (the reference only): each leaf's
    norm of the first step's unclipped gradient."""

    losses: list[float]
    grad1: dict[str, float]
    delta: dict[str, float]
    raw1: dict[str, float] = dataclasses.field(default_factory=dict)


def _tree_map(fn, tree: dict) -> dict:
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def _unflatten(like: dict, flat: dict, prefix: str = "") -> dict:
    return {
        k: (_unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, dict) else flat[prefix + k])
        for k, v in like.items()
    }


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x))


def train(dims: Dims, hp: Hyper, weights: dict, batches: list, *, prec: Precision = EXACT,
          half_batch: bool = False) -> Readings:  # fmt: skip
    """Run ``len(batches)`` steps from ``weights`` (the stored parameters, left
    untouched) on ``batches`` (``(tokens, labels)`` pairs on the weights'
    device).  ``half_batch`` plants a fault: each step's loss is the mean over
    the first half of the batch's rows only."""
    stored = leaves(weights)[0][1].dtype
    with _no_tf32():
        params = _tree_map(lambda w: w.detach().float().clone(), weights)
        m = _tree_map(torch.zeros_like, params)
        v = _tree_map(torch.zeros_like, params)
        losses, grad1, raw1 = [], {}, {}
        for t, (tokens, labels) in enumerate(batches, start=1):
            if half_batch:
                rows = tokens.shape[0] // 2
                tokens, labels = tokens[:rows], labels[:rows]
            flat = leaves(params)
            watched = [p.requires_grad_() for _, p in flat]
            tree = _unflatten(params, {k: p for (k, _), p in zip(flat, watched)})
            value = loss(dims, tree, tokens, labels, prec)
            grads = torch.autograd.grad(value, watched)
            for p in watched:
                p.requires_grad_(False)
            losses.append(float(value.detach()))
            gtree = _unflatten(params, {k: g for (k, _), g in zip(flat, grads)})
            if t == 1:
                raw1 = {k: _norm(g) for (k, _), g in zip(flat, grads)}
            del grads
            step(hp, t, params, gtree, m, v, stored)
            del gtree
            if t == 1:
                grad1 = {k: _norm(x) / (1.0 - hp.b1) for k, x in leaves(m)}
        delta = {k: _norm(p - w.float()) for (k, p), (_, w) in zip(leaves(params), leaves(weights))}
    return Readings(losses, grad1, delta, raw1)


class _no_tf32:
    """Float32 products in float32: TF32 off for the block, as it was after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
