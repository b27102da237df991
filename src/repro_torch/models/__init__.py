"""The LM side: every model family of the reference on the port's kernels.

* ``layers``      — param specs, norms, rotary and sinusoidal positions,
  attention (K9 on the card), MLP, MoE.
* ``transformer`` — the dense, MoE and VLM decoder: specs, forward, prefill,
  decode.
* ``griffin``     — recurrentgemma: RG-LRU blocks and local attention.
* ``rwkv6``       — RWKV6: time-mix with the WKV recurrence, channel-mix.
* ``whisper``     — the encoder-decoder with cross-attention.
* ``registry``    — one interface per family; its functions are re-exported
  here, as the reference's ``models`` does.
* ``convert``     — the reference's parameter tree or train state, as numpy,
  into the port's, and a train state back.

The registry's names load ``registry``, and with it every family, on first
use only, so importing ``repro_torch.models.layers`` loads no family.
"""

import importlib

_REGISTRY = (
    "count_params",
    "family_module",
    "init_params",
    "input_specs",
    "make_inputs",
    "model_specs",
    "param_axes",
    "param_shapes",
)


def __getattr__(name: str):
    if name == "registry" or name in _REGISTRY:
        registry = importlib.import_module(f"{__name__}.registry")
        return registry if name == "registry" else getattr(registry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
