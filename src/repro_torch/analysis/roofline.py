"""Roofline terms of a step on one NVIDIA H100 SXM.

The port of ``repro.analysis.roofline``, with the same names and the same
arithmetic; only the rates differ.  They are the H100 SXM's figures from
NVIDIA's data sheet, not measurements on any card:

    peak bf16:  989 TFLOP/s dense, on the tensor cores  (``PEAK_FLOPS``)
    HBM3:       3.35 TB/s                               (``HBM_BW``)
    NVLink 4:   900 GB/s a GPU over both directions, so
                450 GB/s one way                        (``LINK_BW``)
    int32:      67 TOPS                                 (``INT32_OPS_PER_S``)

The data sheet has no int32 row, so ``INT32_OPS_PER_S`` is its float32
rate off the tensor cores: the consensus kernels' compares, selects and
adds are that kind of operation.

Terms (seconds per step, per card):

    compute    = FLOPs_dev / PEAK_FLOPS
    memory     = bytes_dev / HBM_BW
    collective = collective_bytes_dev / LINK_BW

On one card nothing is a collective, so ``coll_bytes_dev`` and with it
``t_collective`` is 0 in every row until the port's meshes span several
cards (ROADMAP item 6).  The FLOP and byte counts come from
``analysis.analytic``; the port has no compiled HLO to read them from.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) with D = tokens processed
by the step; the ratio MODEL_FLOPS / (FLOPs_dev × chips) flags remat /
redundant-compute waste.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 tensor-core rate (NVIDIA data sheet)
HBM_BW = 3.35e12  # device memory rate, bytes/s (NVIDIA data sheet)
LINK_BW = 450e9  # NVLink 4, bytes/s one way (900 GB/s both ways, NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # no int32 row in the data sheet: the f32 non-tensor rate


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: float
    model_flops: float

    @property
    def t_compute(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_dev / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global FLOPs (remat / redundancy waste)."""
        total = self.flops_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput achieved at the bound, vs pure-compute peak.

        = (MODEL_FLOPS / chips / t_bound) / PEAK — i.e. the MFU the step would
        achieve if it ran exactly at its dominant roofline term.
        """
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_bound) / PEAK_FLOPS

    def row(self) -> dict[str, object]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D with D = tokens processed by the step."""
    n = cfg.n_active_params
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d  # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def from_record(rec: dict) -> Roofline:
    return Roofline(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        chips=rec["chips"],
        flops_dev=rec.get("flops", 0.0),
        hbm_bytes_dev=rec.get("bytes_accessed", 0.0),
        coll_bytes_dev=rec.get("collective_bytes", 0.0),
        model_flops=rec.get("model_flops", 0.0),
    )
