"""``correct`` comes out false when the timed path is broken underneath.

Each test drives a whole training run on the CPU at a tiny size (the
harness's look for a card skipped), the cell's own limits, with one fault
planted in the program: a step that leaves its state unchanged; half of
each batch left out, the loss the mean over the rest; a digest altered
where it is produced; a step whose gradients the digest's witness never
sees; a ``step:`` record altered, or dropped, on its way to
the log.  One card exchanges nothing between chips, so that fault has no
place here.  A sound run of the same size comes out correct.
"""

import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import checks
from perfbench.harness import manifest as mf
from perfbench.kinds import train
from perfbench.reference.lowp import FP8

ROOT = Path(__file__).resolve().parent.parent
MAN = mf.load(ROOT)
CELL = "qwen3-4b.train.4x2048"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "vocab_size": 256, "num_hidden_layers": 2,
        "torch_dtype": "float32"}  # fmt: skip


def _spec(seed: int = 2**31 + 77, dtype: str = "float32") -> train.Spec:
    cell = mf.cell(MAN, CELL)
    conf = mf.config(ROOT, MAN, cell["config"]) | TINY | {"torch_dtype": dtype}
    traffic = mf.traffic(ROOT, cell["traffic"]) | {"batch": 4, "seq_len": 32}
    return train.Spec(conf=conf, traffic=traffic, limits=mf.limits(ROOT, CELL), seed=seed,
                      seconds=0.3, trace=False, device=torch.device("cpu"),
                      t0=time.perf_counter())  # fmt: skip


def _run() -> dict:
    readers = {m["name"]: (m["unit"], mf.reader(ROOT, m["name"])) for m in MAN["end_to_end"]}
    return train.run(_spec(), readers)


def _failing(result: dict) -> set[str]:
    return {k for k, r in result["checks"].items() if not r["value"] <= r["limit"]}


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > train.CHECK_STEPS and result["failed"] == 0
    assert {"train_tokens_per_s", "setup_s"} <= set(result["metrics"])


def _frozen(monkeypatch):
    from repro_torch.train import optimizer

    monkeypatch.setattr(optimizer, "update", lambda grads, state, params, cfg: (
        params, state, torch.zeros(())))  # fmt: skip


def _half_batch(monkeypatch):
    from repro_torch.train import train_loop

    whole = train_loop.make_loss_fn

    def make_loss_fn(cfg):
        fn = whole(cfg)
        return lambda params, batch: fn(params, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(train_loop, "make_loss_fn", make_loss_fn)


def _digest_altered(monkeypatch):
    from repro_torch.train import train_loop

    real = train_loop._grad_digest
    monkeypatch.setattr(train_loop, "_grad_digest", lambda grads: real(grads) ^ 1)


def _update_unseen(monkeypatch):
    """A step that no longer hands its gradients to ``optimizer.update``."""
    monkeypatch.setattr(train.DigestWitness, "__enter__", lambda self: self)
    monkeypatch.setattr(train.DigestWitness, "__exit__", lambda self, *exc: None)


def _submit(monkeypatch, change):
    from repro_torch.core import PaxosContext

    real = PaxosContext.submit
    calls = []

    def submit(self, payload, group=0):
        calls.append(payload)
        payload = change(payload, len(calls)) if payload.startswith(b"step:") else payload
        return real(self, payload, group) if payload is not None else len(calls)

    monkeypatch.setattr(PaxosContext, "submit", submit)


def _record_altered(monkeypatch):
    _submit(monkeypatch, lambda p, n: p[:-1] + bytes([p[-1] ^ 1]) if n == 3 else p)


def _record_dropped(monkeypatch):
    _submit(monkeypatch, lambda p, n: None if n == 3 else p)


@pytest.mark.parametrize(
    "plant, caught_by",
    [
        (_frozen, {"grad_gap", "delta_gap"}),
        (_half_batch, {"grad_gap"}),
        (_digest_altered, {"digest_mismatches"}),
        (_update_unseen, {"digests_unwitnessed"}),
        (_record_altered, {"commit_faults"}),
        (_record_dropped, {"commit_faults"}),
    ],
    ids=["state-unchanged", "half-batch", "digest-altered", "update-unseen", "record-altered",
         "record-dropped"],
)
def test_a_broken_timed_path_is_not_correct(plant, caught_by, monkeypatch):
    plant(monkeypatch)
    result = _run()
    assert not result["correct"]
    assert caught_by <= _failing(result), result["checks"]


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place fails the cell's limits."""
    spec = _spec(dtype="bfloat16")
    ref = train.reference_readings(spec)
    control = train.reference_readings(spec, prec=FP8)
    limits = {k: v["limit"] for k, v in spec.limits.items()}
    correct, rows = checks.judge(checks.gaps(control, ref), limits)
    assert not correct, rows


def test_a_number_without_a_limit_is_not_compared():
    """A limit of None (a number whose readings gave no upper end) leaves the
    number out of ``correct`` and out of the compared rows."""
    correct, rows = checks.judge({"loss_gap": 1.0, "grad_gap": 0.0}, {"loss_gap": None, "grad_gap": 0.1})
    assert correct and set(rows) == {"grad_gap"}
    correct, rows = checks.judge({"loss_gap": 1.0, "grad_gap": 0.2}, {"loss_gap": None, "grad_gap": 0.1})
    assert not correct and set(rows) == {"grad_gap"}
