"""Batched serving on the PyTorch port: continuous batching over a reduced qwen3.

    python examples/torch_serve_batch.py                 # on the card
    python examples/torch_serve_batch.py --device cpu    # no card

The port of ``examples/serve_batch.py``: the same model, requests, batch
and cache length, and the same closing assertion (a second ``ServeLoop``
gives the same tokens).  Weights are random, drawn on the device from a
seeded ``torch.Generator``.  Without ``--device`` the card is used, and the
script raises where there is none.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve.engine import Request, ServeLoop  # noqa: E402


def main(argv: list[str] | None = None) -> dict[int, list[int]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("qwen3-4b").reduced()
    params = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)

    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32), max_new=8)
        for i in range(12)
    ]
    loop = ServeLoop(cfg, params, batch_size=4, max_len=24, device=dev)
    t0 = time.time()
    out = loop.run(requests)
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(requests)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {loop.steps} decode steps) on {dev}")  # fmt: skip
    for rid in sorted(out)[:3]:
        print(f"  req {rid}: {out[rid]}")
    # determinism across batches with identical prompts
    again = ServeLoop(cfg, params, batch_size=4, max_len=24, device=dev).run(requests)
    assert again == out
    print("deterministic across re-serve: OK")
    return out


if __name__ == "__main__":
    main()
