"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors.

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_out

The counterpart of ``repro.launch.dryrun``.  The reference forces 512 host
devices and lowers and compiles each cell's step with the production
shardings; here the process joins a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, private to torch: where
it cannot be imported the run raises, it does not fall back), builds the
production ``DeviceMesh`` over it, places the state, params, caches and
inputs as DTensors of ``meta`` tensors by the sharding rules and runs the
step once on them, as rank 0.  No data moves and no device is touched: this
is an analysis path, it needs no card.

Per cell the JSON record keeps the reference's keys where they mean the same:

  * ``arg_bytes_per_dev_est``: one rank's share of the step's arguments,
    from their shapes and resolved placements;
  * ``flops``, ``bytes_accessed`` and ``model_flops`` from
    ``analysis.analytic``, and ``roofline`` from
    ``analysis.roofline.from_record``;
  * ``ok``, or ``error`` with a ``traceback``; ``skipped`` where
    ``cell_is_applicable`` says so.

In place of the reference's HLO columns it records what the traced step
did on rank 0: ``flops_counted`` (the local matrix-product FLOPs that
``torch.utils.flop_counter`` counts, the attention's masked blocks, the
remat recompute, the backward pass and the optimizer included),
``collective_counts`` (the collectives DTensor issued, by op, seen by a
dispatch mode that, as ``CommDebugMode`` does, lets DTensor run and counts
what it issues) and ``collective_bytes`` (the bytes of the local tensors
handed to them).  These are not comparable with the reference's
HLO-parsed bytes: XLA's partitioner places and fuses collectives in
another way.  Nothing is compiled, so a record has no compile time and no
``memory_analysis`` keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from collections import defaultdict
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import analytic as analytic_mod
from repro_torch.analysis import roofline as roofline_mod
from repro_torch.configs import SHAPES, cell_is_applicable, get_config, list_archs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.train import train_loop

# Named config transforms stacked on the baseline.
VARIANTS = {
    "base": lambda cfg, mp: cfg,
    "dots_remat": lambda cfg, mp: dataclasses.replace(cfg, remat_policy="dots"),
    "ring_cache": lambda cfg, mp: dataclasses.replace(cfg, ring_local_cache=True),
    "moe_local": lambda cfg, mp: dataclasses.replace(cfg, dispatch_groups=32 if mp else 16),
    "moe_local_dots": lambda cfg, mp: dataclasses.replace(
        cfg, dispatch_groups=32 if mp else 16, remat_policy="dots"
    ),
}


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of ``world_size``
    ranks (replacing a fake group of another size)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this torch does not have"
        ) from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run runs in its own process, not beside a real group")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _arg_bytes_per_device(shardings_tree, shapes_tree) -> float:
    """One rank's bytes of the arguments: each leaf's bytes over the number
    of pieces its spec cuts it into."""
    total = 0.0
    for t, s in zip(L.tree_leaves(shapes_tree), L.tree_leaves(shardings_tree), strict=True):
        total += t.numel() * t.element_size() / s.shard_factor()
    return total


_COLLECTIVES = {
    "all_reduce",
    "all_reduce_coalesced",
    "all_gather_into_tensor",
    "all_gather_into_tensor_coalesced",
    "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced",
    "all_to_all_single",
    "broadcast",
}


class _LocalCounts(TorchDispatchMode):
    """One rank's matrix-product FLOPs and collectives.  A DTensor op is
    passed on to DTensor (``NotImplemented``), so only the local ops it
    runs, and the collectives it issues, are seen and counted."""

    def __init__(self) -> None:
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import FlopCounterMode

        self._dtensor = DTensor
        self._registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        count = self._registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.namespace in ("_c10d_functional", "c10d_functional") and (
            packet.__name__ in _COLLECTIVES
        ):
            self.counts[packet.__name__] += 1
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [t for a in args if isinstance(a, (list, tuple)) for t in a
                        if isinstance(t, torch.Tensor)]  # fmt: skip
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    rules_name: str = "base",
    variant: str = "base",
    cfg=None,
) -> dict[str, Any]:
    """One cell's record; ``cfg`` replaces ``get_config(arch)`` (a reduced
    config, say)."""
    cfg = VARIANTS[variant](cfg or get_config(arch), multi_pod)
    shape = SHAPES[shape_name]
    rec: dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules_name,
        "variant": variant,
        "chips": 512 if multi_pod else 256,
    }
    if not cell_is_applicable(cfg, shape):
        rec["skipped"] = (
            "long_500k requires sub-quadratic sequence mixing; "
            f"family '{cfg.family}' is full-attention (see DESIGN.md §5)"
        )
        return rec

    rules = sh.RULES[rules_name]
    t0 = time.time()
    try:
        fake_world(rec["chips"])
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        counts = _LocalCounts()
        with sh.use_rules(mesh, rules):
            specs = registry.input_specs(cfg, shape)
            in_batch_sh = sh.batch_shardings(specs, cfg, rules, mesh)
            if shape.kind == "train":
                state_shapes = train_loop.state_shapes(cfg)
                state_sh = sh.tree_shardings(
                    state_shapes, train_loop.state_axes(cfg), rules, mesh
                )
                rec["arg_bytes_per_dev_est"] = _arg_bytes_per_device(
                    (state_sh, in_batch_sh), (state_shapes, specs)
                )
                state = sh.place_tree(state_shapes, state_sh)
                batch = sh.place_tree(specs, in_batch_sh)
                with counts:
                    train_loop.make_train_step(cfg)(state, batch)
            else:
                pshapes = registry.param_shapes(cfg)
                psh = sh.tree_shardings(pshapes, registry.param_axes(cfg), rules, mesh)
                rec["arg_bytes_per_dev_est"] = _arg_bytes_per_device(psh, pshapes)
                params = sh.place_tree(pshapes, psh)
                if shape.kind == "prefill":
                    batch = sh.place_tree(specs, in_batch_sh)
                    with counts:
                        make_prefill_step(cfg)(params, batch)
                else:  # decode
                    tokens = in_batch_sh["tokens"].place(specs["tokens"])
                    cache = sh.place_tree(specs["cache"], in_batch_sh["cache"])
                    with counts:
                        make_serve_step(cfg)(params, tokens, cache, shape.seq_len - 1)
            rec["lower_s"] = time.time() - t0
            rec["flops_counted"] = float(counts.flops)
            rec["collective_counts"] = dict(counts.counts)
            rec["collective_bytes"] = float(counts.bytes)
        minfo = analytic_mod.MeshInfo.for_mesh(multi_pod, shape.global_batch, rules_name)
        at = analytic_mod.analytic_terms(cfg, shape, minfo)
        rec["flops"] = at["flops"]
        rec["bytes_accessed"] = at["hbm_bytes"]
        rec["model_flops"] = at["model_flops"]
        rec["roofline"] = roofline_mod.from_record(rec).row()
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--rules", choices=sorted(sh.RULES), default="base")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="base")
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}__{args.rules}"
                if args.variant != "base":
                    tag += f"__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        old = json.load(f)
                    if old.get("ok") or old.get("skipped"):
                        print(f"[cached] {tag}")
                        n_ok += 1 if old.get("ok") else 0
                        n_skip += 1 if old.get("skipped") else 0
                        continue
                rec = lower_cell(
                    arch, shape, multi_pod=mp, rules_name=args.rules, variant=args.variant
                )
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("skipped"):
                    n_skip += 1
                    print(f"[skip] {tag}: {rec['skipped'][:60]}")
                elif rec.get("ok"):
                    n_ok += 1
                    rl = rec.get("roofline", {})
                    print(
                        f"[ok]   {tag}: trace={rec.get('lower_s', 0):.1f}s "
                        f"flops/dev={rec.get('flops', 0):.3g} "
                        f"coll={rec.get('collective_bytes', 0):.3g}B "
                        f"dominant={rl.get('dominant')}"
                    )
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec.get('error')}")
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    if dist.is_initialized():
        dist.destroy_process_group()
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
