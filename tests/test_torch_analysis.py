"""The port's bounds (``repro_torch.analysis``) against the reference's.

``analytic_terms`` must equal ``repro.analysis.analytic``'s exactly (plain
Python floats, the same operations in the same order, so tolerance 0) for
every arch, its reduced config and two lever variants, every shape of
``SHAPES``, on one card and on the reference's production meshes.
``Roofline`` keeps the reference's names and arithmetic on the H100's
rates: each time term is the reference's scaled by the ratio of the rates.
``analysis.bounds`` reproduces every kernel bound the port's kernel table
reports (relative 1e-12) and its docstrings' byte totals, and
``k9_pairs`` counts the pairs of ``chip_smoke.py``'s ``k9_mask`` in closed
form.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import analytic as janalytic  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import analytic, bounds, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VARIANTS = {
    "published": lambda c: c,
    "reduced": lambda c: c.reduced(),
    "ring cache": lambda c: dataclasses.replace(c, ring_local_cache=True),
    "remat dots": lambda c: dataclasses.replace(c, remat_policy="dots"),
}


def _configs(arch: str, variant: str):
    return VARIANTS[variant](configs.get_config(arch)), VARIANTS[variant](
        jconfigs.get_config(arch)
    )


def _meshes(shape):
    """(the port's, the reference's) MeshInfo: one card, then both pods
    under both rules at the shape's batch."""
    out = [(analytic.MeshInfo(1, 1, 1, 1), janalytic.MeshInfo(1, 1, 1, 1))]
    for multi_pod in (False, True):
        for rules in ("base", "serve"):
            args = (multi_pod, shape.global_batch, rules)
            out.append((analytic.MeshInfo.for_mesh(*args), janalytic.MeshInfo.for_mesh(*args)))
    return out


def test_the_arch_lists_agree():
    assert configs.list_archs() == jconfigs.list_archs()
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)


@pytest.mark.parametrize("shape_name", list(jconfigs.SHAPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_analytic_terms_equal_the_references_exactly(arch, variant, shape_name):
    cfg, jcfg = _configs(arch, variant)
    shape, jshape = configs.SHAPES[shape_name], jconfigs.SHAPES[shape_name]
    for mesh, jmesh in _meshes(shape):
        assert dataclasses.astuple(mesh) == dataclasses.astuple(jmesh)
        got = analytic.analytic_terms(cfg, shape, mesh)
        want = janalytic.analytic_terms(jcfg, jshape, jmesh)
        assert got == want, (mesh, got, want)
        assert all(type(x) is float for x in got.values())


def test_analytic_helpers_equal_the_references():
    for arch in jconfigs.list_archs():
        cfg, jcfg = _configs(arch, "ring cache")
        for s in (1, 7, 4096, 32768):
            assert analytic._layer_windows(cfg) == janalytic._layer_windows(jcfg)
            assert analytic._param_bytes(cfg) == janalytic._param_bytes(jcfg)
            assert analytic._cache_bytes(cfg, 3, s) == janalytic._cache_bytes(jcfg, 3, s)
            assert analytic._decode_seq_mix_flops(cfg, s, 3) == janalytic._decode_seq_mix_flops(
                jcfg, s, 3
            )
            for kind in ("train", "prefill"):
                assert analytic._seq_mix_flops(cfg, s, 3, kind) == janalytic._seq_mix_flops(
                    jcfg, s, 3, kind
                )
            for window in (0, 5, s, 2 * s):
                assert analytic._attn_flops_per_layer(
                    cfg, s, window
                ) == janalytic._attn_flops_per_layer(jcfg, s, window)


def _record(arch: str, shape_name: str, coll: float) -> dict:
    cfg = jconfigs.get_config(arch)
    shape = jconfigs.SHAPES[shape_name]
    terms = janalytic.analytic_terms(cfg, shape, janalytic.MeshInfo.for_mesh(False, 256))
    return dict(arch=arch, shape=shape_name, mesh="pod", chips=256, flops=terms["flops"],
                bytes_accessed=terms["hbm_bytes"], collective_bytes=coll,
                model_flops=terms["model_flops"])  # fmt: skip


@pytest.mark.parametrize("shape_name", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_roofline_is_the_references_on_the_h100s_rates(arch, shape_name):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape, jshape = configs.SHAPES[shape_name], jconfigs.SHAPES[shape_name]
    assert roofline.model_flops_for(cfg, shape) == jroofline.model_flops_for(jcfg, jshape)
    rec = _record(arch, shape_name, coll=3.0e9)
    got, want = roofline.from_record(rec), jroofline.from_record(rec)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.useful_ratio == want.useful_ratio
    assert list(got.row()) == list(want.row())
    assert got.t_compute == pytest.approx(
        want.t_compute * jroofline.PEAK_FLOPS / roofline.PEAK_FLOPS, rel=REL
    )
    assert got.t_memory == pytest.approx(
        want.t_memory * jroofline.HBM_BW / roofline.HBM_BW, rel=REL
    )
    assert got.t_collective == pytest.approx(
        want.t_collective * jroofline.ICI_BW / roofline.LINK_BW, rel=REL
    )
    terms = {"compute": got.t_compute, "memory": got.t_memory, "collective": got.t_collective}
    assert got.t_bound == max(terms.values()) and terms[got.dominant] == got.t_bound
    assert got.roofline_fraction == pytest.approx(
        got.model_flops / got.chips / got.t_bound / roofline.PEAK_FLOPS, rel=REL
    )
    one_card = roofline.Roofline(arch, shape_name, "1 card", 1, 1.0, 1.0, 0.0, 1.0)
    assert one_card.t_collective == 0.0 and one_card.dominant == "memory"


def test_the_rates_are_the_h100_data_sheets():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.INT32_OPS_PER_S == 67e12


# (name, bytes, operations, the bound in the port's kernel table, ms); K1-K8
# at A=3, B=128, V=16 (K5: K=8, G=8), K9 at its path's shapes, bf16
K9_SHAPES = {  # (B, H, KVH, Sq, Sk, D, causal, window)
    "causal": (2, 32, 16, 2048, 2048, 128, True, 0),
    "window 1024": (2, 32, 16, 2048, 2048, 128, True, 1024),
    "G = 5": (2, 40, 8, 2048, 2048, 128, True, 0),
    "griffin": (2, 10, 1, 4096, 4096, 256, True, 2048),
    "encoder": (4, 8, 8, 1500, 1500, 64, False, 0),
    "cross": (4, 8, 8, 448, 1500, 64, False, 0),
}
K9_TABLE = {
    "causal": 0.06951772615571283,
    "window 1024": 0.05212981270778564,
    "G = 5": 0.08689715769464106,
    "griffin": 0.13030332699696662,
    "encoder": 0.01863700707785642,
    "cross": 0.00556625278058645,
}
B = bounds
KERNEL_TABLE = [
    ("K1", B.k1_bytes(3, 128, 16), B.k1_operations(3, 128, 16), 1.7007462686567165e-05),
    ("K1 cohort G=8", B.k1_cohort_bytes(3, 128, 16, 8, 1), B.k1_operations(3, 128, 16, 8),
     0.00013484776119402985),
    ("K1 shard Gl=4", B.k1_cohort_bytes(3, 128, 16, 4, 1), B.k1_operations(3, 128, 16, 4),
     6.74244776119403e-05),
    ("K2", B.k2_bytes(3, 128, 16), B.k2_operations(3, 128), 2.1245074626865672e-05),
    ("K3", B.k3_bytes(128), B.k3_operations(128), 8.059701492537313e-07),
    ("K4", B.k4_bytes([16384, 262144]), B.k4_operations([16384, 262144]), 0.0003325731343283582),
    ("K5 GB=8", B.k5_bytes(3, 128, 16, 8, 1, 8, 8), B.k5_operations(3, 128, 16, 8, 8),
     0.0010789349253731342),
    ("K5 GB=1", B.k5_bytes(3, 128, 16, 1, 1, 8, 8), B.k5_operations(3, 128, 16, 1, 8),
     0.0001350089552238806),
    ("K6 C=1", B.k6_bytes(3, 128, 16, 1), B.k1_operations(3, 128, 16, 1), 1.6859701492537316e-05),
    ("K6 C=4", B.k6_bytes(3, 128, 16, 4), B.k1_operations(3, 128, 16, 4), 6.743880597014926e-05),
    ("K7", B.k7_bytes(128, 16), B.k7_operations(128), 9.017313432835821e-06),
    ("K8", B.k8_bytes(3, 128, 16, 128), B.k8_operations(3, 128), 6.113432835820896e-06),
]  # fmt: skip


@pytest.mark.parametrize("name, nbytes, ops_, want", KERNEL_TABLE, ids=[r[0] for r in KERNEL_TABLE])
def test_consensus_kernel_bounds_reproduce_the_table(name, nbytes, ops_, want):
    got, by = bounds.bound_ms(nbytes, ops_)
    assert got == pytest.approx(want, rel=REL)
    assert by == "bytes"


@pytest.mark.parametrize("name", list(K9_SHAPES))
def test_k9_bounds_reproduce_the_table(name):
    b, h, kvh, sq, sk, d, causal, window = K9_SHAPES[name]
    ops_ = bounds.k9_operations(b, h, sq, sk, d, causal, window)
    nbytes = bounds.k9_bytes(b, h, kvh, sq, sk, d, 2)
    got, by = bounds.bound_ms(nbytes, ops_, roofline.PEAK_FLOPS)
    assert got == pytest.approx(K9_TABLE[name], rel=REL)
    assert by == "operations"


@pytest.mark.parametrize(
    "got, want",
    [
        (B.k1_bytes(3, 128, 16), 56_975),
        (B.k1_cohort_bytes(3, 128, 16, 1, 0), 56_467),
        (B.k2_bytes(3, 128, 16), 71_171),
        (B.k3_bytes(128), 2_700),
        (B.k4_bytes([16_384, 262_144]), 1_114_120),
        (B.k5_bytes(3, 128, 16, 8, 1, 8, 8), 3_614_432),
        (B.k5_bytes(3, 128, 16, 1, 1, 8, 8), 452_280),
        (B.k6_bytes(3, 128, 16, 1), 56_480),
        (B.k7_bytes(128, 16), 30_208),
        (B.k8_bytes(3, 128, 16, 128), 20_480),
        (B.forwarding_bytes(512, 16), 86_016),
    ],
    ids=["K1", "K1 cohort", "K2", "K3", "K4", "K5 G=8", "K5 G=1", "K6", "K7", "K8", "forwarding"],
)
def test_docstring_byte_totals(got, want):
    assert got == want


@pytest.fixture(scope="module")
def k9_mask():
    return _chip_smoke().k9_mask


@pytest.mark.parametrize("window", [0, 1, 37, 100, 500])
@pytest.mark.parametrize("sq, sk", [(64, 100), (100, 100), (150, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_k9_pairs_counts_the_mask(k9_mask, causal, sq, sk, window):
    mask = k9_mask(sq, sk, torch.device("cpu"), causal, window)
    assert bounds.k9_pairs(sq, sk, causal, window) == int(mask.sum().item())


@pytest.mark.parametrize("name", list(K9_SHAPES))
def test_k9_work_at_the_paths_shapes_is_the_masks(k9_mask, name):
    """At each timed shape: the pairs of the mask, and the operations and
    bytes the script counted from its tensors before the count moved here
    (4·D a pair of each head and batch row; q, k, v and the output)."""
    b, h, kvh, sq, sk, d, causal, window = K9_SHAPES[name]
    pairs = int(k9_mask(sq, sk, torch.device("cpu"), causal, window).sum().item())
    assert bounds.k9_pairs(sq, sk, causal, window) == pairs
    assert bounds.k9_operations(b, h, sq, sk, d, causal, window) == 4 * d * pairs * b * h
    q = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, kvh, sk, d), dtype=torch.bfloat16, device="meta")
    want = q.element_size() * (2 * q.numel() + k.numel() + k.numel())
    assert bounds.k9_bytes(b, h, kvh, sq, sk, d, q.element_size()) == want


def test_k9_pairs_refuses_a_negative_window():
    with pytest.raises(ValueError, match="negative"):
        bounds.k9_pairs(8, 8, True, -1)


def test_the_analysis_package_imports_no_torch():
    code = (
        "import sys, repro_torch.analysis; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]; "
        "print(bad); assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
