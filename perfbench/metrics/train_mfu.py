"""The whole step's share of the card's bf16 peak, in percent: the operations a
step's forward and backward passes need (``flops.step_flops``, counting no
recomputation) times the steps in the window, over the window's time at the
H100 data sheet's 989 TFLOP/s."""

from perfbench.harness import flops


def read(run):
    work = flops.step_flops(run.dense, run.batch, run.seq_len) * run.steps
    return 100.0 * work / (run.window_s * flops.PEAK_BF16)
