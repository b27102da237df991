"""The yardstick's frozen copy of the FLOP, byte and bound arithmetic equals
the program's ``analysis/analytic.py`` and ``analysis/bounds.py`` at every
cell's cut configuration and shape."""

from pathlib import Path

import pytest

from perfbench.harness import flops
from perfbench.harness import manifest as mf
from perfbench.kinds import train

ROOT = Path(__file__).resolve().parent.parent
MAN = mf.load(ROOT)
CELLS = [w["name"] for w in MAN["workloads"]]


def _cell(name):
    w = mf.cell(MAN, name)
    return mf.config(ROOT, MAN, w["config"]), mf.traffic(ROOT, w["traffic"])


@pytest.mark.parametrize("name", CELLS)
def test_training_terms_equal_the_programs(name):
    from repro_torch.analysis.analytic import MeshInfo, analytic_terms
    from repro_torch.configs.base import ShapeConfig

    conf, traffic = _cell(name)
    cfg = train.port_config(conf)
    dense = flops.Dense.from_config(conf)
    shape = ShapeConfig(name, traffic["seq_len"], traffic["batch"], "train")
    want = analytic_terms(cfg, shape, MeshInfo(chips=1, dp=1, fsdp=1, tp=1))
    assert flops.train_terms(dense, traffic["batch"], traffic["seq_len"]) == want
    assert dense.n_params == cfg.n_params


@pytest.mark.parametrize("name", CELLS)
def test_k9_work_equals_the_programs_bounds(name):
    from repro_torch.analysis import bounds, roofline

    conf, traffic = _cell(name)
    m = flops.Dense.from_config(conf)
    b, s = traffic["batch"], traffic["seq_len"]
    args = (b, m.n_heads, s, s, m.head_dim)
    assert flops.k9_operations(*args) == bounds.k9_operations(*args, causal=True)
    byte_args = (b, m.n_heads, m.n_kv_heads, s, s, m.head_dim, 2)
    assert flops.k9_bytes(*byte_args) == bounds.k9_bytes(*byte_args)
    want = max(bounds.k9_operations(*args) / roofline.PEAK_FLOPS,
               bounds.k9_bytes(*byte_args) / roofline.HBM_BW)  # fmt: skip
    assert flops.k9_bound_s(b, m.n_heads, m.n_kv_heads, s, m.head_dim) == want
    assert (flops.PEAK_BF16, flops.HBM_BYTES_PER_S) == (roofline.PEAK_FLOPS, roofline.HBM_BW)


def test_the_cells_run_every_published_width():
    for name in CELLS:
        conf, _ = _cell(name)
        cfg = train.port_config(conf)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab) == (
            conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"],
            conf["head_dim"], conf["intermediate_size"], conf["vocab_size"],
        )  # fmt: skip
        assert cfg.dtype == "bfloat16" and cfg.remat and cfg.remat_policy == "full"
