"""Training substrate: optimizer, data, checkpointing, elastic, train loop.

* ``optimizer``  — AdamW with a warmup-cosine schedule, moments in float32.
* ``data``       — the seeded synthetic token stream (numpy, no download).
* ``train_loop`` — the train step (gradient digest included) and the host
  loop that commits every step's digest through the consensus log.
* ``checkpoint`` — checkpoints whose manifests commit through consensus.
* ``elastic``    — membership views agreed through the consensus log.

``elastic`` and ``data`` load with the package; the other three load the
models, so they load on first use only, and importing ``elastic`` for the
consensus tier never loads ``repro_torch.models``.
"""

import importlib

from . import data, elastic  # noqa: F401

__all__ = ["checkpoint", "data", "elastic", "optimizer", "train_loop"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
