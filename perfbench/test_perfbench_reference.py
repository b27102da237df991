"""The reference's loss, gradients, AdamW update and digest agree with the
program's ``make_train_step`` pieces on the CPU at a tiny size, from the
benchmark's own weights and batches."""

from pathlib import Path

import pytest
import torch

from perfbench.harness import manifest as mf
from perfbench.harness import traffic as feed
from perfbench.harness import weights as wt
from perfbench.kinds import train
from perfbench.reference import adamw, decoder, digest
from perfbench.reference.lowp import FP8

ROOT = Path(__file__).resolve().parent.parent
MAN = mf.load(ROOT)
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "vocab_size": 128, "num_hidden_layers": 2,
        "torch_dtype": "float32"}  # fmt: skip


def tiny(config: str) -> dict:
    return mf.config(ROOT, MAN, config) | TINY


def _program_grads(conf, params, batch):
    from repro_torch.train import train_loop

    cfg = train.port_config(conf)
    return train_loop.value_and_grad(train_loop.make_loss_fn(cfg))(params, batch)


@pytest.mark.parametrize("config", ["qwen3-4b", "mistral-nemo-12b"])
def test_loss_and_gradients_agree_with_the_program(config, monkeypatch):
    monkeypatch.setattr(decoder, "ROW_BLOCK", 16)  # several attention blocks
    monkeypatch.setattr(decoder, "LOSS_ROWS", 40)  # several loss blocks, one ragged
    conf = tiny(config)
    tree = train._tree(conf)
    params = wt.make(conf, tree, 7, torch.float32, "cpu")
    b = feed.batch_at(7, 0, 3, 48, conf["vocab_size"])
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, grads = _program_grads(conf, params, batch)
    flat = adamw.leaves(params)
    watched = [p.clone().requires_grad_() for _, p in flat]
    ref_tree = train.reference._unflatten(params, {k: w for (k, _), w in zip(flat, watched)})
    ref_loss = decoder.loss(decoder.Dims.from_config(conf), ref_tree, batch["tokens"],
                            batch["labels"])  # fmt: skip
    ref_grads = torch.autograd.grad(ref_loss, watched)
    assert abs(float(loss) - float(ref_loss.detach())) <= 1e-5 * float(ref_loss.detach())
    for (k, g), r in zip(adamw.leaves(grads), ref_grads, strict=True):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=k)


def test_adamw_agrees_with_the_programs_update():
    from repro_torch.train import optimizer

    conf = tiny("qwen3-4b")
    tree = train._tree(conf)
    hp = train.hyper(mf.traffic(ROOT, "train.4x2048"))
    ocfg = optimizer.OptConfig(**mf.traffic(ROOT, "train.4x2048")["optimizer"])
    params = wt.make(conf, tree, 3, torch.float32, "cpu")
    ref = train.reference._tree_map(torch.clone, params)
    state = optimizer.init(params)
    m = train.reference._tree_map(torch.zeros_like, ref)
    v = train.reference._tree_map(torch.zeros_like, ref)
    for t in (1, 2, 3):
        grads = wt.make(conf, tree, 100 + t, torch.float32, "cpu")  # any tree of the shapes
        params, state, _ = optimizer.update(grads, state, params, ocfg)
        adamw.step(hp, t, ref, grads, m, v, torch.float32)
    for (k, p), (_, r) in zip(adamw.leaves(params), adamw.leaves(ref), strict=True):
        torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-8, msg=k)
    for (k, p), (_, r) in zip(adamw.leaves(state.mu), adamw.leaves(m), strict=True):
        torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-9, msg=k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_digest_is_the_programs_bit_for_bit(dtype, monkeypatch):
    from repro_torch.train import train_loop

    monkeypatch.setattr(digest, "CHUNK", 1000)  # chunks fold as one leaf
    conf = tiny("mistral-nemo-12b")
    grads = wt.make(conf, train._tree(conf), 11, dtype, "cpu")
    assert digest.digest(grads) == int(train_loop._grad_digest(grads))


def test_the_control_rounds_every_product_to_float8():
    x = torch.randn(64, 64, dtype=torch.float64).float()
    y = FP8.operand(x)
    assert not torch.equal(x, y)
    rel = torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(x)
    assert 1e-3 < rel < 0.1  # e4m3: 3 mantissa bits
    assert torch.equal(FP8.operand(y), y)  # rounding twice changes nothing
