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
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_unflatten

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


class CheckpointManager:
    def __init__(self, directory: str, paxos_ctx=None):
        self.dir = directory
        self.ctx = paxos_ctx
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state: Any, step: int) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(path, exist_ok=True)
        leaves = tree_leaves(state)
        manifest = {"step": step, "n_leaves": len(leaves), "leaves": []}
        h = hashlib.sha256()
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_numpy(leaf)
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(path, fn), arr)
            h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:_SAMPLED_BYTES])
            manifest["leaves"].append({"file": fn, "shape": list(arr.shape), "dtype": dtype})
        manifest["digest"] = h.hexdigest()[:16]
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._commit(path, manifest)
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
        """Restore into the structure of ``like``, each leaf on the device of
        ``like``'s leaf in its place, in the dtype it was saved in.

        ``shardings`` (restoring onto another mesh) waits for the port's
        meshes over several devices, ``ROADMAP.md`` queue 1, item 9: anything
        but ``None`` raises ``NotImplementedError``."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto other shardings waits for the port's meshes: ROADMAP.md queue 1, "
                "item 9"
            )
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
        out = [
            _from_numpy(np.load(os.path.join(path, meta["file"])), meta["dtype"]).to(ref.device)
            for meta, ref in zip(manifest["leaves"], leaves_like, strict=True)
        ]
        return tree_unflatten(like, out), manifest["step"]
