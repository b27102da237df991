"""Carry a parameter tree across: numpy arrays in, the port's tensors out.

``params_from_numpy`` takes the reference's parameter tree as numpy arrays
(``np.asarray`` of each leaf of ``repro.models.registry.init_params``) and
returns the port's tree with the same keys and shapes, so both packages can
compute the same thing on the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .layers import tree_map


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None) -> Any:
    """Every leaf of ``tree`` as a tensor on ``device``, cast to ``dtype``
    where one is given (else float32 for 16-bit floats numpy cannot name)."""

    def leaf(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.tensor(arr, device=device)
        return t.to(dtype) if dtype is not None else t

    return tree_map(leaf, tree)
