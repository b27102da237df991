"""The weights of a dense decoder, made by the benchmark from the seed.

The tree is the one the program takes (and the reference reads): every
block's leaf stacked over the layers, leaves in sorted-key order.  Each
matrix is drawn from ``N(0, initializer_range^2)``, the published
initialisation, by one ``torch.randn`` call into the stored dtype on the
target device, from a generator of its own seeded with ``(seed, leaf
index)``, so any leaf can be drawn again alone.  Each norm weight is a
zero offset from one (the published initialisation of ones).
"""

from __future__ import annotations

import torch

NORMS = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")


def shapes(conf: dict, qk_norm: bool) -> dict:
    """The tree of leaf shapes of the configuration ``conf`` (``config.json``
    keys)."""
    n, d, f, v = (conf[k] for k in ("num_hidden_layers", "hidden_size", "intermediate_size",
                                     "vocab_size"))  # fmt: skip
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // h
    attn = {"wq": (n, d, h, hd), "wk": (n, d, kv, hd), "wv": (n, d, kv, hd), "wo": (n, h, hd, d)}
    if qk_norm:
        attn |= {"q_norm": (n, hd), "k_norm": (n, hd)}
    tree = {
        "embed": (v, d),
        "blocks": {"ln1": (n, d), "ln2": (n, d), "attn": attn,
                   "mlp": {"wi": (n, d, f), "wg": (n, d, f), "wo": (n, f, d)}},  # fmt: skip
        "ln_f": (d,),
    }
    if not conf["tie_word_embeddings"]:
        tree["head"] = (d, v)
    return tree


def paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for key in sorted(tree):
        sub = tree[key]
        out.extend(paths(sub, f"{prefix}{key}/") if isinstance(sub, dict) else [prefix + key])
    return out


def _seed(seed: int, index: int) -> int:
    return ((seed % (1 << 62)) * 1_000_003 + index) % (1 << 63)


def leaf(conf: dict, tree: dict, path: str, seed: int, dtype, device) -> torch.Tensor:
    """The leaf at ``path`` of ``tree`` (``shapes``) for ``seed``."""
    shape = tree
    for key in path.split("/"):
        shape = shape[key]
    if path.split("/")[-1] in NORMS:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, paths(tree).index(path)))
    out = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(conf["initializer_range"])


def make(conf: dict, tree: dict, seed: int, dtype, device) -> dict:
    def build(sub: dict, prefix: str) -> dict:
        return {
            k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
            else leaf(conf, tree, prefix + k, seed, dtype, device)
            for k, v in sub.items()
        }  # fmt: skip

    return build(tree, "")
