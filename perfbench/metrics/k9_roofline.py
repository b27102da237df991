"""K9's share of its roofline, in percent: the least time one launch at the
cell's shapes could take (``flops.k9_bound_s``: causal, bf16, every layer's
(B, H, S, D) queries over (B, KV, S, D) keys) over the device time per K9
launch in the traced window.  None where the trace holds no K9 launch."""

from perfbench.harness import flops

KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")  # K9's entries in csrc/flash_attention.cu


def read(run):
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace.kernels.items() if any(k in name for k in KERNELS)]
    launches, ns = sum(n for n, _ in hits), sum(t for _, t in hits)
    if not launches or not ns:
        return None
    m = run.dense
    bound = flops.k9_bound_s(run.batch, m.n_heads, m.n_kv_heads, run.seq_len, m.head_dim)
    return 100.0 * bound / (ns / 1e9 / launches)
