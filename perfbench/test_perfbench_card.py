"""On the card: a short window of a cell comes out correct, and the float8
control at the cell's own size does not.  Each skips without a card (the
``card`` fixture decides)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import checks
from perfbench.harness import manifest as mf
from perfbench.kinds import train
from perfbench.reference.lowp import FP8

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parent.parent
MAN = mf.load(ROOT)
CELL = "qwen3-4b.train.16x512"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_a_short_window_is_correct(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )  # fmt: skip
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert {"train_tokens_per_s", "peak_mem_gib", "setup_s"} == set(result["metrics"])


def test_the_control_is_not_correct_at_the_cells_size(card):
    cell = mf.cell(MAN, CELL)
    spec = train.Spec(conf=mf.config(ROOT, MAN, cell["config"]),
                      traffic=mf.traffic(ROOT, cell["traffic"]), limits=mf.limits(ROOT, CELL),
                      seed=2**31 + 5, seconds=0.0, trace=False, device=card,
                      t0=time.perf_counter())  # fmt: skip
    ref = train.reference_readings(spec)
    control = train.reference_readings(spec, prec=FP8)
    limits = {k: v["limit"] for k, v in spec.limits.items()}
    correct, rows = checks.judge(checks.gaps(control, ref), limits)
    assert not correct, rows
