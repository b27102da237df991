"""Batched LM serving from the command line, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --requests 8
    python -m repro_torch.launch.serve --arch gemma3-27b

Weights are random, drawn from a ``torch.Generator`` seeded by ``--seed`` on
the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.api import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeLoop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = registry.init_params(cfg, gen)
    rng = np.random.default_rng(args.seed)

    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
            max_new=args.max_new,
        )
        for i in range(args.requests)
    ]
    loop = ServeLoop(cfg, params, batch_size=args.batch,
                     max_len=args.prompt_len + args.max_new, device=dev)  # fmt: skip
    t0 = time.time()
    out = loop.run(reqs)
    dt = time.time() - t0
    tok = sum(len(v) for v in out.values())
    print(
        f"served {len(reqs)} requests, {tok} tokens in {dt:.2f}s "
        f"({tok / max(dt, 1e-9):.1f} tok/s, {loop.steps} decode steps) on {dev}"
    )
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]}")


if __name__ == "__main__":
    main()
