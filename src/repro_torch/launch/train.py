"""End-to-end training from the command line, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 50
    python -m repro_torch.launch.train --arch qwen3-4b --steps 20 \\
        --batch 4 --seq 2048 --ckpt-dir ckpt --ckpt-every 10

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch qwen3-4b --smoke \
        --device cpu --steps 4 --batch 8 --seq 16

The port of ``repro.launch.train``: the same flags, plus ``--device``.
Fault-tolerance path: consensus-committed checkpoints, quorum step-commit
through a staged ``PaxosContext`` on the same device, restart from the
latest committed step.

``--mesh host`` builds ``make_host_mesh()`` over the world's ranks (one
process without ``torchrun`` is a world of one: a (1, 1) mesh), ``prod``
and ``prod-multi`` the (16, 16) and (2, 16, 16) production meshes, which
need a world of 256 or 512 ranks.  Each rank is one process on one device
(NCCL on the cards, gloo with ``--device cpu``).  The state and each batch
are placed as DTensors by ``BASE_RULES`` (``launch.sharding``), which is
also installed as the activation sharder.  Every rank draws the same
initial state and batches from ``--seed``; only rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import PaxosConfig, PaxosContext
from repro_torch.core.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--mesh", choices=["host", "prod", "prod-multi"], default="host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    try:
        if args.mesh == "host":
            mesh = make_host_mesh(device=dev)
        else:
            mesh = make_production_mesh(multi_pod=args.mesh == "prod-multi", device=dev)
        rules = sh.BASE_RULES
        with sh.use_rules(mesh, rules):
            _train(args, cfg, dev, mesh, rules)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, dev: torch.device, mesh, rules) -> None:
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    state = train_loop.init_state(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    state_sh = sh.tree_shardings(
        train_loop.state_shapes(cfg), train_loop.state_axes(cfg), rules, mesh
    )
    state = sh.place_tree(state, state_sh)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    batch_sh = sh.batch_shardings(registry.input_specs(cfg, shape), cfg, rules, mesh)
    opt_cfg = opt_mod.OptConfig(lr=args.lr, total_steps=max(args.steps, 10))
    step_fn = train_loop.make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)

    dcfg = data_mod.DataConfig(
        vocab=cfg.vocab,
        global_batch=args.batch,
        seq_len=args.seq,
        seed=args.seed,
        n_patches=cfg.n_patches,
        src_len=cfg.src_len if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )
    stream = data_mod.SyntheticStream(dcfg)

    paxos = PaxosContext(PaxosConfig(n_acceptors=3, n_instances=4096, batch=16), device=dev)
    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir, paxos_ctx=paxos)
        if args.resume and mgr.latest_committed():
            state, start_step = mgr.restore(state, shardings=state_sh)
            if dist.get_rank() == 0:
                print(f"resumed from committed step {start_step}")

    loop_cfg = train_loop.LoopConfig(
        steps=args.steps,
        checkpoint_every=args.ckpt_every,
        straggler_prob=args.straggler_prob,
    )
    t0 = time.time()
    state, hist = train_loop.run_loop(
        cfg,
        state,
        iter(stream),
        loop=loop_cfg,
        train_step=step_fn,
        paxos_ctx=paxos,
        checkpoint_mgr=mgr,
        rng_seed=args.seed,
        batch_shardings=batch_sh,
    )
    dt = time.time() - t0
    committed = sum(hist["committed"])
    if dist.get_rank() == 0:
        print(
            f"{args.steps} steps in {dt:.1f}s ({dt / max(args.steps, 1) * 1e3:.1f} ms/step) "
            f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
            f"committed={committed}/{args.steps} "
            f"consensus_delivered={paxos.stats['delivered']}"
        )


if __name__ == "__main__":
    main()
