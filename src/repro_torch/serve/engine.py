"""Serving engine, the LM half: batched prefill and decode over the registry.

The port of the LM half of ``repro.serve.engine``.  ``make_prefill_step``
and ``make_serve_step`` are the two entry points of the inference shapes;
``ServeLoop`` runs greedy continuous batching over ``serve_step`` on the
host.  The consensus half (``ConsensusService``, sessions and routing)
lives in ``serve.service``, which does not depend on this half; its names
are re-exported here, where the reference defines them.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.service import (  # noqa: F401
    ConsensusService,
    Session,
    Ticket,
    session_group,
    session_group_live,
    session_hash,
)


def make_prefill_step(cfg) -> Callable:
    """The prefill step, run with gradients off: no autograd history, and no
    remat wrapper around the layers (``layers.checkpoint_fn``).  It returns
    a copy of the last position's logits, (B, V) in storage of its own, so
    the (B, S, V) logits are freed with the step, as the reference's new
    array lets them be."""
    mod = registry.family_module(cfg)

    @torch.no_grad()
    def prefill_step(params, batch: dict[str, torch.Tensor]):
        logits, cache = mod.prefill(cfg, params, batch)
        return logits[:, -1].clone(), cache

    return prefill_step


def make_serve_step(cfg) -> Callable:
    mod = registry.family_module(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        logits, cache = mod.decode_step(cfg, params, tokens, cache, pos)
        return logits.reshape(tokens.shape[0], -1), cache

    return serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    generated: list[int] | None = None


class ServeLoop:
    """Greedy continuous-batching loop (host side) on ``device``: the card
    unless the caller passes another; ``params`` must live there."""

    def __init__(self, cfg, params, batch_size: int, max_len: int, device=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self.mod = registry.family_module(cfg)
        self._decode = make_serve_step(cfg)
        self.steps = 0

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        """Teacher-forced prefill via decode steps, then greedy generation.

        Mixed prompt lengths never see padding: every row feeds a real token
        at every step, its prompt while the shared position counter is inside
        the prompt and its own greedy continuation afterwards, so the shared
        counter is per-row exact and generations match per-request decode.
        An empty prompt seeds token 0 as an implicit BOS.
        """
        out: dict[int, list[int]] = {}
        dtype = getattr(torch, self.cfg.dtype)
        for chunk_start in range(0, len(requests), self.batch):
            chunk = requests[chunk_start : chunk_start + self.batch]
            lens = [max(1, len(r.prompt)) for r in chunk]
            cache = self.mod.init_cache(self.cfg, self.batch, self.max_len, dtype, self.device)
            gen: list[list[int]] = [[] for _ in chunk]
            cur = np.zeros((self.batch, 1), np.int32)
            for i, r in enumerate(chunk):
                if len(r.prompt):
                    cur[i, 0] = r.prompt[0]
            total = max(ln + r.max_new for ln, r in zip(lens, chunk, strict=True))
            for t in range(total - 1):
                tokens = torch.from_numpy(cur).to(self.device)
                last, cache = self._decode(self.params, tokens, cache, t)
                self.steps += 1
                nxt = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
                for i, r in enumerate(chunk):
                    k = t + 1 - lens[i]  # generation index this step
                    if k < 0:
                        cur[i, 0] = r.prompt[t + 1]  # still teacher-forcing
                    elif k < r.max_new:
                        gen[i].append(int(nxt[i]))
                        cur[i, 0] = nxt[i]
            for i, r in enumerate(chunk):
                out[r.rid] = gen[i]
        return out
