"""Carry a parameter tree or a train state across: numpy arrays in, the
port's tensors out, and back.

``params_from_numpy`` takes the reference's parameter tree as numpy arrays
(``np.asarray`` of each leaf of ``repro.models.registry.init_params``) and
returns the port's tree with the same keys and shapes, so both packages can
compute the same thing on the same weights.  ``state_from_numpy`` does the
same for a train state (``repro.train.train_loop.TrainState`` with numpy
leaves: params, the moments ``mu`` and ``nu``, ``count`` and ``step``) and
``state_to_numpy`` carries the port's back, so that both packages start a
training run from the same state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.train.optimizer import OptState
from repro_torch.train.train_loop import TrainState

from .layers import tree_map


def _tensor(x, device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.tensor(arr, device=device)
    return t.to(dtype) if dtype is not None else t


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None) -> Any:
    """Every leaf of ``tree`` as a tensor on ``device``, cast to ``dtype``
    where one is given (else float32 for 16-bit floats numpy cannot name)."""
    return tree_map(lambda x: _tensor(x, device, dtype), tree)


def state_from_numpy(state: Any, device):
    """The port's ``TrainState`` on ``device`` from any state with the
    reference's fields (``params``, ``opt.mu``, ``opt.nu``, ``opt.count``,
    ``step``) of numpy leaves: params as ``params_from_numpy`` makes them,
    moments float32, ``count`` and ``step`` int32."""

    def moments(tree):
        return params_from_numpy(tree, device, torch.float32)

    o = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=OptState(moments(o.mu), moments(o.nu), _tensor(o.count, device, torch.int32)),
        step=_tensor(state.step, device, torch.int32),
    )


def state_to_numpy(state: Any) -> Any:
    """The port's ``TrainState`` with every leaf a numpy array (bfloat16,
    which numpy cannot name, widened to float32)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, state)
