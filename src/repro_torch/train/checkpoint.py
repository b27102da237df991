"""Checkpointing with consensus-committed manifests.

The port of ``repro.train.checkpoint``, with the same layout per step::

    <dir>/step_<N>/
        manifest.json     {step, n_leaves, leaves: [{file, shape, dtype}], digest}
        leaf_00000.npy ...
        COMMITTED         (written only after the manifest digest is decided
                           through the consensus log)

The two-phase structure is the paper's checkpoint/trim protocol applied to
training state: the leaves are written first (phase: data), then the
manifest digest is proposed as a consensus value (phase: commit).  On
restart, only checkpoints whose COMMITTED marker exists are eligible, so a
crash mid-write can never yield a half-restored model.

Leaves are read in ``tree_leaves`` order, the reference's, so a float32
checkpoint written by either package restores in the other.  numpy has no
bfloat16 without ``ml_dtypes``, which the port does not use: a bfloat16 leaf
is stored as its raw bits in a ``uint16`` array, with ``"bfloat16"`` (the
reference's dtype name) in the manifest; the digest reads the same bytes.

A state of DTensors (a meshed run's) is saved whole, once for the world,
and gathered nowhere: rank 0 writes each split leaf into a memory-mapped
``.npy`` a shard at a time, its own and then each other rank's, which it
receives from that rank (one copy of a replicated shard is sent), commits,
and the others wait for it at a barrier.  ``restore(...,
shardings=...)`` places each leaf by the ``launch.sharding.MeshSharding``
in its place, onto whatever mesh those name, each rank reading only its
own shard: the elastic restart onto another mesh that the reference does
with ``jax.device_put``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.layers import is_dtensor, settled, shard_box, tree_leaves, tree_unflatten

_SAMPLED_BYTES = 4096  # of each leaf, in the manifest's content hash


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _save_meshed(leaf, file: str, writer: bool) -> tuple[np.ndarray | None, str | None]:
    """Write DTensor ``leaf`` (no ``Partial``) to ``file`` from the writer,
    rank 0, with no rank holding more than its own shard: an unsplit leaf
    is rank 0's copy; a split one goes into a memory-mapped array a shard
    at a time, each rank that holds a counted shard (``shard_box``) sending
    it to rank 0.  A collective over the leaf's mesh.  Returns the writer's
    array (memory-mapped where split) and its dtype name."""
    local = leaf.to_local()
    if not any(p.is_shard() for p in leaf.placements):
        if not writer:
            return None, None
        arr, dtype = _to_numpy(local)
        np.save(file, arr)
        return arr, dtype
    mesh, me = leaf.device_mesh, dist.get_rank()
    if not writer:
        if shard_box(leaf.shape, leaf.placements, mesh, mesh.get_coordinate())[2]:
            dist.send(local.contiguous(), dst=0)
        return None, None
    mine, dtype = _to_numpy(local)
    out = np.lib.format.open_memmap(file, mode="w+", dtype=mine.dtype, shape=tuple(leaf.shape))
    buf = torch.empty_like(local, memory_format=torch.contiguous_format)
    for rank in mesh.mesh.flatten().tolist():
        coord = [int(c) for c in (mesh.mesh == rank).nonzero()[0]]
        offsets, _, counted = shard_box(leaf.shape, leaf.placements, mesh, coord)
        if not counted:
            continue
        if rank == me:
            arr = mine
        else:
            dist.recv(buf, src=rank)
            arr = _to_numpy(buf)[0]
        out[tuple(slice(o, o + n) for o, n in zip(offsets, arr.shape, strict=True))] = arr
    out.flush()
    return out, dtype


def _restore_meshed(file: str, dtype: str, sharding) -> torch.Tensor:
    """The leaf in ``file`` as a DTensor placed by ``sharding`` (a
    ``MeshSharding``): each rank reads only its own shard, from the array
    memory-mapped."""
    from torch.distributed.tensor import DTensor

    arr = np.load(file, mmap_mode="r")
    mesh, places = sharding.mesh, list(sharding.placements)
    offsets, size, _ = shard_box(arr.shape, places, mesh, mesh.get_coordinate())
    block = np.array(arr[tuple(slice(o, o + n) for o, n in zip(offsets, size))], order="C")
    local = _from_numpy(block, dtype).to(mesh.device_type)
    return DTensor.from_local(local, mesh, places, run_check=False)


class CheckpointManager:
    def __init__(self, directory: str, paxos_ctx=None):
        self.dir = directory
        self.ctx = paxos_ctx
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state: Any, step: int) -> str:
        """Write ``state`` as step ``step`` and commit it.  A state with
        DTensor leaves is a collective: every rank of their mesh calls it."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        leaves = tree_leaves(state)
        meshed = any(is_dtensor(leaf) for leaf in leaves)
        writer = not meshed or dist.get_rank() == 0
        if writer:
            os.makedirs(path, exist_ok=True)
        manifest = {"step": step, "n_leaves": len(leaves), "leaves": []}
        h = hashlib.sha256()
        for i, leaf in enumerate(leaves):
            fn = f"leaf_{i:05d}.npy"
            if is_dtensor(leaf):
                arr, dtype = _save_meshed(settled(leaf), os.path.join(path, fn), writer)
            elif writer:
                arr, dtype = _to_numpy(leaf)
                np.save(os.path.join(path, fn), arr)
            if not writer:
                continue
            h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:_SAMPLED_BYTES])
            manifest["leaves"].append({"file": fn, "shape": list(arr.shape), "dtype": dtype})
        if writer:
            manifest["digest"] = h.hexdigest()[:16]
            with open(os.path.join(path, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            self._commit(path, manifest)
        if meshed:
            dist.barrier()
        return path

    def _commit(self, path: str, manifest: dict) -> None:
        if self.ctx is not None:
            # propose the manifest digest through the consensus log
            payload = f"ckpt:{manifest['step']}:{manifest['digest']}".encode()
            self.ctx.submit(payload)
            self.ctx.run_until_quiescent()
            if not any(p == payload for _, p in self.ctx.delivered_log):
                return  # not committed; leave checkpoint uncommitted
        with open(os.path.join(path, "COMMITTED"), "w") as f:
            f.write("ok")

    # -- restore ------------------------------------------------------------
    def latest_committed(self) -> str | None:
        if not os.path.isdir(self.dir):
            return None
        steps = sorted(
            d
            for d in os.listdir(self.dir)
            if d.startswith("step_") and os.path.exists(os.path.join(self.dir, d, "COMMITTED"))
        )
        return os.path.join(self.dir, steps[-1]) if steps else None

    def restore(self, like: Any, path: str | None = None, shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``like``, in the dtype each leaf was
        saved in: each leaf on the device of ``like``'s leaf in its place,
        or, with ``shardings`` (a tree like ``like`` of
        ``launch.sharding.MeshSharding``), placed as a DTensor by the one in
        its place, on every rank of its mesh."""
        path = path or self.latest_committed()
        if path is None:
            raise FileNotFoundError("no committed checkpoint")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = tree_leaves(like)
        if len(leaves_like) != manifest["n_leaves"]:
            raise ValueError(
                f"structure mismatch: {manifest['n_leaves']} leaves saved, {len(leaves_like)} "
                "to restore into"
            )
        files = [(os.path.join(path, meta["file"]), meta["dtype"]) for meta in manifest["leaves"]]
        if shardings is None:
            out = [_from_numpy(np.load(f), dtype).to(ref.device)
                   for (f, dtype), ref in zip(files, leaves_like, strict=True)]  # fmt: skip
        else:
            shard_leaves = tree_leaves(shardings)
            if len(shard_leaves) != len(leaves_like) or not all(
                hasattr(s, "mesh") and hasattr(s, "placements") for s in shard_leaves
            ):
                raise TypeError(
                    f"shardings must be a tree of {len(leaves_like)} MeshSharding leaves like the "
                    f"state, got {type(shardings).__name__}"
                )
            out = [_restore_meshed(f, dtype, s)
                   for (f, dtype), s in zip(files, shard_leaves, strict=True)]  # fmt: skip
        return tree_unflatten(like, out), manifest["step"]
