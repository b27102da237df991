"""Train-step factory + host loop: grad accumulation, CAANS quorum commit,
straggler masking, checkpoint hooks.

The port of ``repro.train.train_loop``.  The quorum step-commit (DESIGN.md
§3) is part of ``train_step``: the gradient digest is computed inside the
step (one pass over the grads) and returned in the metrics; the host loop
feeds digests into the consensus layer and a step only becomes durable once
f+1 of 2f+1 replica groups voted the same digest, through the port's
``PaxosContext``.

A step runs eagerly where the reference jits, and updates the train state's
tensors in place (``optimizer.update``) where the reference donates it: the
state passed in is the state returned.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten

from . import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState
    step: torch.Tensor  # int32, 0-d


def init_state(cfg, gen: torch.Generator, opt_cfg: opt.OptConfig | None = None) -> TrainState:
    """Random params from ``gen`` (``registry.init_params``), zero moments,
    step 0, all on ``gen``'s device."""
    params = registry.init_params(cfg, gen)
    step = torch.zeros((), dtype=torch.int32, device=gen.device)
    return TrainState(params=params, opt=opt.init(params), step=step)


def state_shapes(cfg) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device (no allocation)."""
    ps = registry.param_shapes(cfg)
    step = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=ps, opt=opt.init_shapes(ps), step=step)


def state_axes(cfg) -> TrainState:
    """Logical-axes tree matching TrainState (for sharding resolution)."""
    axes = registry.param_axes(cfg)
    return TrainState(params=axes, opt=opt.OptState(mu=axes, nu=axes, count=()), step=())


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


_DIGEST_CHUNK = 1 << 26  # elements a pass: 512 MiB of int64 products at most


def _grad_digest(grads) -> torch.Tensor:
    """Cheap order-sensitive digest of the grad tree (bitwise, fp-exact): the
    reference's, as a 0-d int32 tensor on the grads' device.

    Each leaf's bits are read as int32 (a 16-bit leaf sign-extended from
    int16), weighted by ``2 * i + 1`` at its row-major index ``i`` and
    summed; ``acc = acc * 1000003 + sum`` over the leaves in
    ``tree_leaves`` order.  The reference wraps every product and sum in
    int32; here they run in int64 (whose wrapping keeps the residue mod
    2^32) and are reduced mod 2^32 to the signed value, which is the same
    number.  A leaf is taken a chunk at a time, so its int64 products never
    exist whole beside it.
    """
    acc = 0
    for leaf in tree_leaves(grads):
        if leaf.element_size() == 2:
            bits = leaf.view(torch.int16)
        elif leaf.element_size() == 4:
            bits = leaf.view(torch.int32)
        else:
            bits = leaf.float().view(torch.int32)
        flat = bits.reshape(-1)
        total = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for start in range(0, flat.numel(), _DIGEST_CHUNK):
            chunk = flat[start : start + _DIGEST_CHUNK].to(torch.int64)
            lin = torch.arange(start, start + chunk.numel(), dtype=torch.int64, device=leaf.device)
            total += torch.sum(chunk * (lin * 2 + 1))
        acc = (acc * 1000003 + total) & 0xFFFFFFFF
    acc = torch.as_tensor(acc)
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def make_loss_fn(cfg) -> Callable:
    mod = registry.family_module(cfg)

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = mod.forward(cfg, params, inputs)
        return _xent(logits, batch["labels"])

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` of ``loss_fn(params, batch)``: returns
    ``(loss, grads)``, the grads a tree like the params, each in its
    param's dtype.  The params themselves are left as they are."""

    def vg(params, batch):
        watched = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, watched), batch)
            grads = torch.autograd.grad(loss, watched)
        return loss.detach(), tree_unflatten(params, list(grads))

    return vg


def make_train_step(
    cfg,
    opt_cfg: opt.OptConfig | None = None,
    *,
    grad_accum: int = 1,
    with_digest: bool = True,
) -> Callable[[TrainState, dict[str, torch.Tensor]], tuple[TrainState, dict]]:
    """Build the train step (microbatched when grad_accum > 1)."""
    ocfg = opt_cfg or opt.OptConfig()
    vg = value_and_grad(make_loss_fn(cfg))

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        if grad_accum == 1:
            loss, grads = vg(state.params, batch)
        else:
            # the micro-gradients summed in float32, as the reference's scan does
            grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device), state.params)
            loss = torch.zeros((), device=state.step.device)
            for i in range(grad_accum):
                mb = {k: v.reshape((grad_accum, -1) + v.shape[1:])[i] for k, v in batch.items()}
                l, g = vg(state.params, mb)
                for acc, x in zip(tree_leaves(grads), tree_leaves(g), strict=True):
                    acc.add_(x)
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum

        new_params, new_opt, gnorm = opt.update(grads, state.opt, state.params, ocfg)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if with_digest:
            metrics["digest"] = _grad_digest(grads)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Host loop with CAANS-committed steps (single-controller simulation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    commit_quorum: int = 2  # f+1 of 2f+1 replica groups
    replica_groups: int = 3  # 2f+1
    checkpoint_every: int = 0  # 0 = off
    straggler_prob: float = 0.0  # simulated straggling group probability


def run_loop(
    cfg,
    state: TrainState,
    data_iter,
    *,
    loop: LoopConfig,
    train_step: Callable | None = None,
    paxos_ctx=None,
    checkpoint_mgr=None,
    rng_seed: int = 0,
) -> tuple[TrainState, dict[str, list]]:
    """Drive training with quorum-committed steps.

    Every step, each replica group's digest is submitted as a consensus value;
    the step is durable once the consensus layer delivers a quorum agreement.
    A simulated straggler group abstains — the quorum still commits, which is
    the straggler-mitigation property inherited from the paper's f-of-2f+1
    resilience.  Batches (numpy) go to the state's device here.
    """
    step_fn = train_step or make_train_step(cfg)
    device = state.step.device
    history: dict[str, list] = {"loss": [], "committed": [], "straggled": []}
    rng = np.random.default_rng(rng_seed)

    for i in range(loop.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(data_iter).items()}
        state, metrics = step_fn(state, batch)
        digest = int(metrics["digest"]) if "digest" in metrics else 0

        # replica groups vote with their digest; deterministic data-parallel
        # math means healthy groups agree bit-exactly.
        votes = []
        straggled = 0
        for _g in range(loop.replica_groups):
            if rng.random() < loop.straggler_prob:
                straggled += 1
                continue  # group missed the deadline -> abstains
            votes.append(digest)
        committed = len(votes) >= loop.commit_quorum
        if paxos_ctx is not None and committed:
            paxos_ctx.submit(
                b"step:"
                + int(state.step).to_bytes(4, "little")
                + digest.to_bytes(4, "little", signed=True)
            )
            paxos_ctx.pump(2)

        history["loss"].append(float(metrics["loss"]))
        history["committed"].append(committed)
        history["straggled"].append(straggled)

        if (
            checkpoint_mgr is not None
            and loop.checkpoint_every
            and (i + 1) % loop.checkpoint_every == 0
        ):
            checkpoint_mgr.save(state, step=int(state.step))

    return state, history
