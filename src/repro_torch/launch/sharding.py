"""Logical-axis sharding rules (DP / FSDP / TP / SP / EP + pod) on DTensor.

The port of ``repro.launch.sharding``.  Every parameter / activation / cache
dim carries a *logical* axis name; this module maps names onto mesh axes
with the reference's t5x-style rules, subject to:

  * divisibility: a dim is only sharded if the mesh-axis product divides it
    (otherwise the rule falls through to the next candidate, ending at
    replication).  This is what lets one rule set serve kv_heads=16 (sharded
    16-way) and kv_heads=4 (replicated) without per-arch special cases, and
    it keeps every DTensor shard even.
  * no axis reuse: a mesh axis is consumed by the first dim that takes it.

A resolved spec is a tuple with one entry a dim, ``None`` (replicated), a
mesh axis name or a tuple of names, trailing ``None``s trimmed: the
reference's ``PartitionSpec`` read as a tuple.  ``placements`` turns it into
DTensor placements on a ``DeviceMesh``: a dim whose entry names a mesh axis
is ``Shard(dim)`` on that mesh dim, so ``("pod", "data")`` is ``Shard(d)``
on both, pod-major, as JAX splits it.  ``MeshSharding`` (mesh, spec,
placements) is the counterpart of a ``NamedSharding``.

``install`` puts an activation sharder into ``models.layers``: it
``redistribute``s a DTensor activation to its resolved placements, the
counterpart of ``with_sharding_constraint``, and leaves a plain tensor as
it is.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.models import layers as L

AxisCandidate = None | str | tuple[str, ...]
Spec = tuple[AxisCandidate, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered candidates per logical axis name."""

    rules: dict[str, tuple[AxisCandidate, ...]]

    def candidates(self, name: str | None) -> tuple[AxisCandidate, ...]:
        if name is None:
            return (None,)
        return self.rules.get(name, (None,))


# Paper-faithful baseline: DP+FSDP+TP+EP, no sequence parallelism.
BASE_RULES = ShardingRules(
    {
        # data / batch
        "batch": (("pod", "data"), "data", None),
        # FSDP: parameter embed dim over the data axis
        "embed": ("data", None),
        "embed_out": (None,),
        # tensor parallel
        "heads": ("model", None),
        "kv_heads": ("model", None),
        "heads_flat": ("model", None),
        "mlp": ("model", None),
        "expert_mlp": (None,),
        "vocab": ("model", None),
        "rnn": ("model", None),
        "rnn_out": (None,),
        # expert parallel
        "expert": ("model", None),
        # activations
        "act_seq": (None,),
        "mlp_act": ("model", None),
        "embed_act": (None,),
        # caches: kv_heads first, else shard the cache sequence dim
        "cache_seq": (None,),
        # never sharded
        "layers": (None,),
        "head_dim": (None,),
    }
)

# Optimized rules: + sequence parallelism on the residual stream and
# sequence-sharded KV caches when kv_heads cannot take the model axis.
OPT_RULES = ShardingRules(
    {
        **BASE_RULES.rules,
        "act_seq": ("model", None),
        "cache_seq": ("model", None),
    }
)

# Small-model training rules: TP=16 charges a per-layer activation
# all-reduce that dwarfs a <3B model's compute; run pure DP+FSDP instead
# (the model axis still shards the vocab/logits).
NOTP_RULES = ShardingRules(
    {
        **BASE_RULES.rules,
        "heads": (None,),
        "kv_heads": (None,),
        "heads_flat": (None,),
        "mlp": (None,),
        "mlp_act": (None,),
        "rnn": (None,),
        "expert": ("model", None),
    }
)

# Serving rules: weight-stationary inference.  Params shard over `model`
# only (replicated across `data`).
SERVE_RULES = ShardingRules(
    {
        **BASE_RULES.rules,
        "embed": (None,),  # no FSDP: weights resident
        "cache_seq": (None,),
    }
)

RULES = {"base": BASE_RULES, "opt": OPT_RULES, "serve": SERVE_RULES, "notp": NOTP_RULES}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, as a ``DeviceMesh`` reports them
    (``shape`` a tuple, ``mesh_dim_names``), with no devices and no
    process group behind it: enough to resolve specs and placements."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """A shape-only mesh: no device or process group is touched."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not match names {tuple(axis_names)}")
    return AbstractMesh(tuple(int(n) for n in shape), tuple(axis_names))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape), strict=True))


def resolve_spec(
    shape: Sequence[int], axes: Sequence[str | None], rules: ShardingRules, mesh
) -> Spec:
    """Resolve one array's logical axes to a spec tuple."""
    assert len(shape) == len(axes), (shape, axes)
    sizes = axis_sizes(mesh)
    used: set = set()
    parts: list[AxisCandidate] = []
    for dim, name in zip(shape, axes, strict=True):
        chosen: AxisCandidate = None
        for cand in rules.candidates(name):
            if cand is None:
                chosen = None
                break
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used for a in cand_t):
                continue
            if any(a not in sizes for a in cand_t):
                continue
            if dim % math.prod(sizes[a] for a in cand_t) != 0:
                continue
            chosen = cand if isinstance(cand, str) else tuple(cand)
            used.update(cand_t)
            break
        parts.append(chosen)
    # trim trailing Nones for a tidy spec
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others.  A tuple entry must name its axes in the mesh's order (the
    rules' ``("pod", "data")`` does), so that the split is major to minor
    as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """One leaf's sharding: the counterpart of a ``NamedSharding``."""

    mesh: Any
    spec: Spec
    placements: tuple

    def shard_factor(self) -> int:
        """How many pieces the leaf is cut into (its replicas not counted)."""
        sizes = axis_sizes(self.mesh)
        return math.prod(
            sizes[a] for entry in self.spec if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)
        )  # fmt: skip

    def place(self, t: torch.Tensor):
        """``t`` (the same on every rank) as a DTensor with these placements,
        on the mesh's device type (a ``meta`` tensor stays on ``meta``)."""
        from torch.distributed.tensor import distribute_tensor

        if t.device.type not in ("meta", self.mesh.device_type):
            t = t.to(self.mesh.device_type)
        return distribute_tensor(t, self.mesh, list(self.placements))


def sharding(mesh, spec: Spec) -> MeshSharding:
    return MeshSharding(mesh, tuple(spec), placements(spec, mesh))


def _is_shape_leaf(x) -> bool:
    return hasattr(x, "shape") or x is None


def tree_shardings(shapes_tree, axes_tree, rules: ShardingRules, mesh):
    """A ``MeshSharding`` tree for a (shapes, axes) tree pair: the shapes
    tree (tensors, meta or not) gives the structure; the axes tree holds one
    tuple of logical names in each leaf's place (``()`` or ``None``:
    replicated)."""

    def walk(shapes, axes):
        if _is_shape_leaf(shapes):
            shape = getattr(shapes, "shape", None)
            if shape is None or not axes:
                return sharding(mesh, ())
            return sharding(mesh, resolve_spec(tuple(shape), axes, rules, mesh))
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], axes[k]) for k in shapes}
        if isinstance(shapes, tuple):
            items = [walk(s, a) for s, a in zip(shapes, axes, strict=True)]
            return type(shapes)(*items) if hasattr(shapes, "_fields") else tuple(items)
        raise TypeError(f"not a tensor, dict or tuple: {type(shapes).__name__}")

    return walk(shapes_tree, axes_tree)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed by the ``MeshSharding`` in its place."""
    leaves = L.tree_leaves(tree)
    shs = L.tree_leaves(shardings)
    return L.tree_unflatten(tree, [s.place(t) for t, s in zip(leaves, shs, strict=True)])


# ---------------------------------------------------------------------------
# Activation sharder installation
# ---------------------------------------------------------------------------
calls = 0  # activations the installed sharder constrained (DTensors only)


def fsdp_axes(rules: ShardingRules, mesh) -> tuple[str, ...]:
    """The mesh axes that the rules split the batch over: a param split over
    one of them is split FSDP-wise, and is gathered before its layer runs."""
    names = set(mesh.mesh_dim_names)
    out: list[str] = []
    for entry in rules.candidates("batch"):
        for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            if a in names and a not in out:
                out.append(a)
    return tuple(out)


def install(mesh, rules: ShardingRules = BASE_RULES) -> None:
    """Install the activation-constraint hook used by model code, and the
    rules' FSDP axes (``fsdp_axes``) beside it."""

    def sharder(x: torch.Tensor, axes: tuple) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        global calls
        calls += 1
        spec = resolve_spec(tuple(x.shape), axes, rules, mesh)
        return x.redistribute(mesh, placements(spec, mesh))

    L.set_activation_sharder(sharder, fsdp_axes(rules, mesh))


def uninstall() -> None:
    L.set_activation_sharder(None)


class use_rules:
    """Context manager: install/uninstall activation sharding."""

    def __init__(self, mesh, rules: ShardingRules = BASE_RULES):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        install(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        uninstall()
        return False


# ---------------------------------------------------------------------------
# Batch (input) shardings
# ---------------------------------------------------------------------------
BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "patches": ("batch", None, None),
    "frames": ("batch", None, None),
    "pos": (),
}


def batch_shardings(input_specs: dict[str, Any], cfg, rules, mesh) -> dict[str, Any]:
    """Shardings for a train/prefill/decode input-spec dict."""
    from repro_torch.models import registry

    out: dict[str, Any] = {}
    for k, v in input_specs.items():
        if k == "cache":
            cache_axes = registry.family_module(cfg).CACHE_AXES
            out[k] = {
                name: sharding(mesh, resolve_spec(tuple(t.shape), cache_axes[name], rules, mesh))
                for name, t in v.items()
            }
        else:
            out[k] = sharding(mesh, resolve_spec(tuple(v.shape), BATCH_AXES[k], rules, mesh))
    return out
