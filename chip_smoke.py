"""Drive the port's CAANS service on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --prefill-decode-gap   # the witness of prefill_decode_gap alone
    python3 chip_smoke.py --fabric-ranks DIR      # run_fabric's three ranks (its subprocess)

The quickest proof that the PyTorch port starts and is right on the card.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and builds the
kernels from ``src/repro_torch/csrc`` on first use.  It prints, in order:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the kernels' build time, then the contracts phase (``run_contracts``):
   the port's contract checker (``analysis.contracts``) with every
   ``ctypes`` binding made on the libraries just built and held against its
   ``extern "C"`` entry, STATE-INPLACE through every state entry on the
   card at the paper's deployment (A=3, N=65,536, V=16, B=128, G=8), and
   each kernel against its oracle in ``kernels.ref``, on one line with its
   counts and seconds;
3. the kernel phase: each kernel against its plain PyTorch version on the
   card, at its path's shapes and at adversarial windows, bit for bit; the
   round kernel K1 at one group and in its cohort and multi-group forms, and
   its persistent form K5 (K1's team body, the rounds spread over the grid),
   also against K sequential K1 launches and at K = 65,535 and 65,536 (the
   grid's z edge), and the packed shard round K6 and K1's shard slice, K6
   also against K1's shard slice on one cohort; the staged vote K2 (a team
   of threads per (acceptor, lane)) and the per-role acceptor K7 (the same
   team body at A = 1) also against the first design's one-thread body
   (the witness) on each alive acceptor's own file; the per-role learner
   K8 (a team a lane that loads every vote first) where its first agreeing
   acceptor is 0, 1, A-1 or none, at A up to one past the acceptors it
   loads up front; K1, K5, K6, K2, K7 and K8 in both variants of their
   team body (vector at V = 16 on 16-byte aligned tensors, scalar at V = 5
   and on views 4 bytes off 16), each case printing the variant it took;
   the sequencer K3 at B of 3 to 4096 and on ``active`` views 0 to 3 bytes
   past 4; the digest K4 one leaf a launch and every leaf of a seal in one
   launch, on the main path's seal shapes, views off 16, empty leaves and
   8 leaves, each case printing its grid and leaves, a seal profiled to
   run one kernel and no fill, and one leaf past 2^31 words (8.6 GB)
   against the plain fold taken chunk by chunk;
4. the main path: ``PaxosContext(PaxosConfig(), fused=True, use_kernels=True,
   snapshots=True)`` on the card under a seeded lossy ``SimNet``, with ring
   wrap under reclamation, snapshots, an acceptor kill and revive, a crash
   and restore, and a coordinator failover and restore; the same schedule on
   the plain engine must give the same logs, seals and final state, and
   every seal is folded again by K4's plain version and must agree; each
   seal must be one K4 launch (on every path with seals);
5. the staged path: ``PaxosContext(PaxosConfig(), n_learners=2)`` with its
   defaults (``fused=False``, ``use_kernels=True``) on the card under a
   lossy ``SimNet``, with ring wrap, a kill and revive, a failover and
   restore and a ``recover()``; the same schedule on the plain engine must
   give the same logs, learners' tables and final state, K3 must run once
   per ``sequence()`` and K2 once per ``vote()``;
6. the per-role path: one ring walk of bursts through the sequencer, each
   acceptor alone and the learner (K3, K7 x A, K8, the last two on their
   team body in its vector variant), held against the same bursts through
   the acceptor array's vote (K2) and K8's plain version; then the fabric
   consensus (``run_fabric``): ``core.fabric.make_fabric_consensus`` at the
   paper's deployment, one rank an acceptor, 128 proposals a rank, 512
   rounds, in a world of one on NCCL in this process on a (1,) mesh, then
   three ranks on the one card over gloo in a subprocess (B = 384, three
   ring laps; one acceptor dead for 100 rounds, two for 10), each rank on a
   ``cuda`` mesh and then on a ``cpu`` one; every round's ``decided``,
   ``inst`` and ``value`` and the final registers bit-equal to the CPU run
   and to a replay through the plain ``batched`` functions, acceptor by
   acceptor, with no collective; one K3 and one K7 launch a round on
   every rank, and each part's round p50 and p99 on the host clock;
7. the multi-group path: ``PaxosContext(PaxosConfig(n_groups=8,
   persistent_rounds=1, realign_after=4), use_kernels=True, snapshots=True)``
   under a lossy ``SimNet``, uniform then skewed load, per-group failover,
   crash and restore, retire, create and adopt (``run_multigroup_path``);
   the plain engine's run must give the same group logs, seals, state,
   dispatch count, fold width and plan, and K1's cohort form must run once
   per fused dispatch;
8. the multi-group path at the reference's defaults:
   ``PaxosContext(PaxosConfig(n_groups=8, realign_after=4), use_kernels=True,
   snapshots=True)``, so ``persistent_rounds=8`` and ``async_pump=True``, on
   the same schedule with deep enough queues that waves form (of K=8 and of
   smaller depths); the plain engine's run must give the same group logs,
   order of ``deliver`` callbacks, seals, state, dispatch count, fold widths,
   wave depths and plan; K5 must run once per wave and K1's cohort form once
   per single-round dispatch;
9. the groups-sharded path: the service of 8, at the reference's
   defaults, on ``PaxosContext(..., mesh=group_mesh(dev))``: two logical
   shards of four groups on the one card, each slab an allocation of its
   own, or one shard per card (``make_group_mesh()``) where several cards
   split the 8 groups; on the schedule of 7, then a retire on the last
   shard (group 5 on two shards), ``migrate_group(0, S - 1)`` and more
   traffic.  A sharded context plans no persistent waves (the reference's
   clamp), so before the move its group logs, dispatch count and plan must
   equal path 7's; the plain engine's run must give the same group logs,
   order of ``deliver`` callbacks, seals, state, dispatch count, fold
   widths, placement and plan; every dispatch must launch K6 or K1's shard
   slice once per shard;
10. the replicated KV tier: ``ConsensusService`` and ``ReplicatedKV`` over
   the service of 8 (``run_kv_path``), 1,024 sessions each the single
   writer of two 8-byte keys, the op mix of ``run_kv_twins``
   (``tests/test_kv_linearizable.py``: 50% put, 20% delete, 30% cas) with
   12-byte values, on its chaos schedule (group 0's coordinator failover
   and restore, an acceptor crash with state loss and its restore from the
   snapshot, compaction every 4 waves, retire and create), eight fused
   single-group twins fed the same values at the same cadence (their
   replicas must equal the service's at the retirement and at the end), a
   second context's sealed snapshot adopted with no dispatch, and
   ``benchmarks/bench_wirepath.py``'s KV row (128 puts a round trip, 4,096
   leased gets); every get must equal the session's last write and the
   decoded chain, a leased get must dispatch nothing, and both read paths
   must run; then the same tier on ``group_mesh(dev)`` with one
   ``plan_placement`` and a ``migrate_group`` (``run_kv_sharded``), the
   moved group's sessions reading the same values after the move.  Each
   against the plain engine's run (logs, archives, replicas, answers,
   stats, dispatch count, seals, plan, slabs); K5, K1's cohort form and K4
   must launch (one K4 launch a seal), K6 and K1's shard slice on the
   sharded part;
11. K9, the attention kernel, against its plain version at the cases of
   ``tests/test_flash_kernel.py``, rows that see no key, ragged lengths,
   head dims 16 to 256 and the LM and MoE paths' shapes, on contiguous
   tensors and on (B, H, S, D) views of (B, S, H, D) ones (float32 at 2e-5
   with TF32 off, bfloat16 at 2e-2), griffin's and whisper's among them; the
   reduced models (dense gemma3 and qwen3, MoE llama4-scout and dbrx,
   internvl2 with seeded patches, recurrentgemma, rwkv6 and whisper with
   seeded frames) on the card against the CPU;
12. LM serving at gemma3-27b's full width, its depth cut from 62 to 12
   layers (two 5:1 local:global superblocks), random weights from a seeded
   generator on the card (``lm_params``): ``make_prefill_step`` on 2 prompts
   of 2048 tokens in bfloat16, K9 12 times a call on views of the layers'
   q, k, v (no copies) and the plain attention never, its last logits
   against the same step on K9's plain version; the
   float32 prefill of one 1536-token prompt against teacher-forced
   ``serve_step`` decode, and again on the grouped ring cache
   (``ring_local_cache=True``: 1024-slot rings on the local layers, which
   the 1536 steps wrap), with the cache's bytes and the bf16 decode step at
   B = 4 and S = 8192 with and without the rings; ``ServeLoop`` answering
   8 requests of 64-512 prompt tokens and 16 new ones at batch 4, twice
   alike, and two of them alone as in the batch;
13. MoE serving at llama4-scout's full width (d_model 5120, 40 heads, 8 kv
   heads, 16 experts of d_ff 8192, top-1 and a shared expert, vocab
   202,048), its depth cut from 48 to 4 layers: the bf16 prefill of 2
   prompts of 2048 tokens, K9 4 times a call (G = 5) and the plain
   attention never, against the same step on K9's plain version, every
   layer's routes recorded in both and the routes that differ counted; the
   float32 prefill of one 512-token prompt against teacher-forced decode
   at capacity factor 16 (no token dropped); ``ServeLoop`` on 8 requests
   of 16-128 prompt tokens at batch 4, twice alike, two alone as in the
   batch;
14. training (``run_training``): ``launch/train.py``'s path at qwen3-4b's
   full width (d_model 2560, 32 heads, 8 kv heads, d_ff 9728, vocab
   151,936), its depth cut from 36 to 8 layers, bf16, remat on:
   ``init_state``, ``make_train_step`` and ``run_loop`` with the staged
   ``PaxosContext(PaxosConfig(n_acceptors=3, n_instances=4096, batch=16))``,
   10 steps of 4 x 2048 tokens from the uniform stream, stragglers at 0.3;
   finite losses, the first within 0.5 of ln(vocab), ``committed`` as the
   straggler draws give it, one delivered ``step:`` record with its
   step's digest for each committed step, in order; K9, K3 and K2 must
   launch; ms a step, tokens/s, peak memory and K9's share of a step.  The
   reduced model in float32, three steps on the card against the same
   steps on the CPU from the same state, and one step's gradients through
   K9 against the plain attention's on the card; ``examples/
   torch_train_100m.py``'s 30 steps (the loss falls; K9 and K1 launch); a
   checkpoint committed through consensus at step 3, restored bit for bit,
   resumed with the uninterrupted run's losses, and with acceptors 0 and 1
   killed a save that stays invisible;
15. the mesh phase (``run_mesh``): four of those training steps on
   ``make_host_mesh()``, a (1, 1) ``(data, model)`` mesh over NCCL in a
   world of one, the state and batches placed as DTensors by
   ``launch.sharding.BASE_RULES`` and its activation sharder installed,
   against the same four steps unmeshed from the same state: the losses'
   relative gap under 1e-3, ``shard`` calls and K9 launches (through
   ``local_map``) inside the meshed steps, each side's step times apart;
   then ``python -m
   repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh
   single`` in a subprocess (a fake group of 256 ranks, meta tensors, no
   card), whose record must be ``ok``;
16. the other families at full width and full depth, random weights from a
   seeded generator (``run_family``), each phase's weights freed before the
   next: recurrentgemma-2b (26 layers, 2.89 G params) on 2 prompts of 4096
   tokens in bf16, K9 8 times a call (window 2048, G = 10, D = 256), and
   whisper-base (6 + 6 layers) on 4 prompts of 448 tokens over 1500 seeded
   frames, K9 18 times a call, each against the same step on K9's plain
   version; rwkv6-3b (32 layers, 3.07 G params, no kernel) on 2 prompts of
   2048 tokens, finite logits, its WKV loops timed by CUDA events; for each,
   the float32 prefill against teacher-forced decode (whisper's from the
   prefill's cross cache), within 1e-4 (rwkv6's within its own bound,
   ``prefill_decode_atol``), and ``ServeLoop`` at batch 4 on 8 requests of
   64-128 prompt tokens, twice alike, two alone as in the batch; the memory
   still allocated before these phases and after each has freed its weights;
17. times: each kernel by CUDA events at its path's shapes beside its bound
   and its plain version (K1, K5, K6, K2, K7 and K8 also beside the launch
   floor of their grid, an empty kernel, and their times at 64, 128 and
   256 threads a block, with the registers, spills and 128-bit load and
   store counts of ``csrc/wirepath.cu``'s, ``csrc/vote.cu``'s and
   ``csrc/learner.cu``'s kernels, which must show no spill in a team
   kernel and 128-bit stores in its vector variant; K7 also beside its
   first design (the witness), K8 also where acceptor 0 rejects every lane
   and with its votes in L2; K3, K7
   and K8 at Table 1's shape, B = 512, beside forwarding, one copy of the
   batch, as microseconds a message; K4's
   seal as one launch beside the floor
   of its grid and ``torch.sum`` over the same bytes, each launch reading
   its bytes from HBM, at the N/4 seal and a sweep of prefixes up to 256
   MiB, and K3 beside its grid's floor, with K4's and K3's registers,
   spills and 128-bit loads, which must show no spill and 128-bit loads
   in K4; K9 also beside PyTorch's
   ``scaled_dot_product_attention``, also at the MoE path's, griffin's and
   whisper's shapes, with its registers and spills and its
   library's HGMMA and UTMALDG counts, which must not be 0), each consensus
   path's decided values/s
   and latency, the KV tier's ops/s, write and leased-get microseconds
   and read:write ratio, and the LM, MoE and other families' prefill and
   decode times and their prefills' peak memory, and rwkv6's WKV share;
   then a roofline line for each model phase (each prefill, the training
   step, each decode step): ``analysis.analytic``'s terms of the phase's
   own cut config, B and S on one card, through ``analysis.roofline``'s
   data-sheet rates (``t_compute``, ``t_memory``, ``dominant``,
   ``t_bound``), beside the phase's measured p50 (``bound_share``,
   ``mfu``).  Every kernel's bound comes from ``analysis.bounds``;
18. the ``kernels`` JSON line (K9's launches: the LM, MoE, griffin and
   whisper prefill paths' and the mesh phase's; K3's the staged path's and
   the fabric's, K7's the per-role path's and the fabric's), then the
   ``ok`` JSON line last.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a kernel of the path that never launched fails the run, and
so does a launch of a team kernel (K1, K5, K6, K2, K7, K8) of a path that
did not take the vector variant.

Any failure raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.analytic import MeshInfo, analytic_terms  # noqa: E402
from repro_torch.analysis.bounds import (  # noqa: E402
    bound_ms,
    forwarding_bytes,
    k1_bytes,
    k1_cohort_bytes,
    k1_operations,
    k2_bytes,
    k2_operations,
    k3_bytes,
    k3_operations,
    k4_bytes,
    k4_operations,
    k5_bytes,
    k5_operations,
    k6_bytes,
    k7_bytes,
    k7_operations,
    k8_bytes,
    k8_operations,
    k9_bytes,
    k9_operations,
    k9_pairs,
)
from repro_torch.analysis.roofline import PEAK_FLOPS, Roofline  # noqa: E402
from repro_torch.core import FaultSpec, PaxosConfig, PaxosContext, SimNet  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    MSG_P2B,
    AcceptorState,
    CoordinatorState,
    MsgBatch,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import acceptor as k_acceptor  # noqa: E402
from repro_torch.kernels import coordinator as k_coordinator  # noqa: E402
from repro_torch.kernels import digest as k_digest  # noqa: E402
from repro_torch.kernels import learner as k_learner  # noqa: E402
from repro_torch.kernels import ref as k_ref  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.launch.mesh import GroupMesh, make_group_mesh  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import registry as lm_registry  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request,
    ServeLoop,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serve.kv import (  # noqa: E402
    OP_CAS,
    OP_DELETE,
    OP_PUT,
    GroupReplica,
    KvOp,
    ReplicatedKV,
    decode_op,
)
from repro_torch.serve.service import ConsensusService  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_loop import LoopConfig, run_loop  # noqa: E402

SEED = 20160519

CARD = ""  # "name, power limit" from nvidia-smi, set by main()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# contracts phase: the port's contract checker on the built libraries
# ---------------------------------------------------------------------------
PAPER = dict(a=3, n=65536, v=16, b=128, g=8)  # the paper's deployment, G=8 for groups


def same_ints(what: str, got, want) -> int:
    """``max_abs_err`` of int32 outputs that must also agree in dtype."""
    for x, y in zip(got, want, strict=True):
        if x.dtype != torch.int32 or y.dtype != torch.int32:
            raise AssertionError(f"{what}: outputs {x.dtype} and {y.dtype}, not int32")
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{what} disagrees with kernels.ref: max_abs_err={err}")
    return err


def check_ref_kernels(dev) -> dict[str, float]:
    """Each kernel-level function of ``kernels.ref`` (the reference's oracle
    names and signatures) against its kernel on the card, at the paper's
    deployment A=3, N=65,536, V=16, B=128 on a window that wraps the ring's
    end, a dead acceptor; the kernels on clones, the oracles left their
    inputs as they were.  K9 at one of gemma3's prefill shapes, float32 at
    2e-5 and bfloat16 at 2e-2."""
    a, n, v, b = PAPER["a"], PAPER["n"], PAPER["v"], PAPER["b"]
    rng = np.random.default_rng(SEED + 33)

    def ints(*shape, lo=-(2**31), hi=2**31 - 1):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32, endpoint=True)).to(dev)

    def copies(xs):
        return [x.clone() for x in xs]

    i32 = dict(dtype=torch.int32, device=dev)
    base = n - b // 2
    inst = (base + torch.arange(b, **i32)) % n
    one = [ints(n, lo=0, hi=8), ints(n, lo=-1, hi=8), ints(n, v)]
    stack = [ints(a, n, lo=0, hi=8), ints(a, n, lo=-1, hi=8), ints(a, n, v)]
    learner = [ints(n, lo=0, hi=1), ints(n, lo=-1, hi=n), ints(n, v)]
    msgtype = torch.from_numpy(rng.choice([0, 1, 3, 3, 3, 4, 7], b).astype(np.int32)).to(dev)
    msg_rnd, msg_val = ints(b, lo=-1, hi=10), ints(b, v)
    alive = torch.tensor([True, False, True], device=dev)
    inputs = copies([*one, *stack, *learner, msgtype, msg_rnd, msg_val])
    errs = {}
    got = k_acceptor.acceptor_phase2_window(*copies(one), 1, msgtype, inst, msg_rnd, msg_val)
    want = k_ref.acceptor_phase2_window(*one, base, 1, msgtype, msg_rnd, msg_val)
    errs["acceptor_phase2"] = same_ints("K7", [*got[:4], *got[5:]], want)
    got = k_wirepath.acceptor_vote_all_window(*copies(stack), alive, msgtype, inst, msg_rnd,
                                              msg_val)  # fmt: skip
    want = k_ref.acceptor_vote_all_window(*stack, base, alive, msgtype, msg_rnd, msg_val)
    errs["acceptor_vote_all"] = same_ints("K2", [*got[:4], *got[5:]], want)
    votes = (want[3], want[5], want[7])  # (A, B) type and vrnd, (A, B, V) value
    errs["learner_quorum"] = same_ints("K8", k_learner.learner_quorum_window(2, *votes),
                                       k_ref.learner_quorum_window(2, *votes))  # fmt: skip
    ni, crnd = torch.tensor(base, **i32), torch.tensor(5, **i32)
    active = torch.from_numpy(rng.random(b) < 0.8).to(dev)
    got = k_coordinator.coordinator_sequence_window(ni, crnd, active)
    want = k_ref.coordinator_sequence_window(ni, crnd, active)
    errs["coordinator_sequence"] = same_ints("K3", [*got[:4], got[5]], want)
    values = ints(b, v)
    got = k_wirepath.wirepath_round(ni, crnd, 2, alive, *copies(stack), *copies(learner), values)
    want = k_ref.wirepath_round(ni, crnd, 2, alive, *stack, *learner, values)
    errs["wirepath_round"] = same_ints("K1", [*got[:6], got[8].to(torch.int32), *got[9:]], want)
    for x in (stack[2], stack[2].view(torch.float32)):
        errs["digest"] = same_ints("K4", [k_digest.digest(x)], [k_ref.digest(x)])
    for x, y in zip([*one, *stack, *learner, msgtype, msg_rnd, msg_val], inputs, strict=True):
        if not torch.equal(x, y):
            raise AssertionError("a kernels.ref oracle changed its inputs on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v_ = k9_inputs(gen, 1, 32, 16, 512, 512, 128, dtype, dev)
        kw = dict(window=0, causal=True, softmax_scale=None)
        err = float((k_flash.flash_attention_kernel(q, k, v_, **kw).float()
                     - k_ref.flash_attention(q, k, v_, **kw).float()).abs().max())  # fmt: skip
        if not err <= atol:
            raise AssertionError(f"K9 {dtype} disagrees with kernels.ref: max_abs_err={err}")
        errs[f"K9 {str(dtype).removeprefix('torch.')}"] = err
    return errs


def run_contracts(dev) -> None:
    """The port's contract checker with BIND-ARITY on the libraries just
    built (every ``argtypes`` list set on the real ``ctypes`` function),
    STATE-INPLACE through every registered state entry on the card at the
    paper's deployment, and ``kernels.ref`` against each kernel.  Fails the
    run on any violation."""
    t0 = time.perf_counter()
    violations = contracts.check_repo(library=_build.library)
    counts = contracts.summary(library=_build.library)
    inplace, ran = contracts.check_inplace(dev, **PAPER)
    violations += inplace
    errs = check_ref_kernels(dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    for v in violations:
        print(f"  {v}")
    print(f"contracts: {counts['registered']} registered entries, {counts['guarded']} guarded "
          f"methods, {counts['bound']} C entries bound right on the built libraries, "
          f"STATE-INPLACE on {ran} entries at {PAPER}, kernels.ref against "
          f"{len({name.split()[0] for name in errs})} kernels "
          f"(max_abs_err {errs}), {len(violations)} violations, {seconds:.3f} s")  # fmt: skip
    if violations:
        raise AssertionError(f"the contracts phase failed: {len(violations)} violations")


# ---------------------------------------------------------------------------
# kernel phase: every kernel against its plain version on the card
# ---------------------------------------------------------------------------
def round_inputs(rng, a, n, v, b, base, crnd, alive, limit, dev):
    """A random but protocol-valid round: promised rounds straddle ``crnd``
    (so some acceptors accept and some reject), and part of the learner
    ring already holds this window's instances (duplicates)."""
    inst = (base + np.arange(b)).astype(np.int64)
    slots = inst % n
    rnd = rng.integers(0, max(crnd, 0) + 3, (a, n), dtype=np.int32)
    vrnd = rng.integers(-1, max(crnd, 0) + 3, (a, n), dtype=np.int32)
    ldel = rng.integers(0, 2, (n,), dtype=np.int32)
    linst = rng.integers(-1, 1 << 20, (n,), dtype=np.int32)
    dup = rng.random(b) < 0.3
    linst[slots[dup]] = inst[dup].astype(np.int32)

    def t(x, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    state = dict(
        cstate=CoordinatorState.init(crnd=crnd, next_inst=base, device=dev),
        stack=AcceptorState(
            t(rnd), t(vrnd), t(rng.integers(-(2**31), 2**31, (a, n, v), dtype=np.int32))
        ),
        lstate=batched.LearnerState(
            t(ldel), t(linst), t(rng.integers(-(2**31), 2**31, (n, v), dtype=np.int32))
        ),
    )
    values = t(rng.integers(-(2**31), 2**31, (b, v), dtype=np.int32))
    return state, values, t(np.ones(b, bool), torch.bool), t(np.asarray(alive), torch.bool), limit


def clone_state(state):
    c = state["cstate"]
    st, ls = state["stack"], state["lstate"]
    return dict(
        cstate=CoordinatorState(c.next_inst.clone(), c.crnd.clone()),
        stack=AcceptorState(st.rnd.clone(), st.vrnd.clone(), st.value.clone()),
        lstate=batched.LearnerState(ls.delivered.clone(), ls.inst.clone(), ls.value.clone()),
    )


def round_outputs(res):
    c, st, ls, fresh, inst, win, value = res
    return [c.next_inst, c.crnd, st.rnd, st.vrnd, st.value, ls.delivered, ls.inst, ls.value,
            fresh.to(torch.int32), inst, win, value]  # fmt: skip


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def off16(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary: a team kernel must take its scalar variant on it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    if y.data_ptr() % 16 != 4:
        raise AssertionError("off16: the view is not 4 bytes off 16")
    return y


def variants() -> tuple[int, int]:
    """The launch counts of the team kernels' (K1, K5, K6, K2, K7, K8) two
    variants."""
    return k_wirepath.vector_launches, k_wirepath.scalar_launches


def variant_since(before: tuple[int, int]) -> str:
    """Which variants the team kernels' launches since ``before`` took."""
    vec, sca = (now - was for now, was in zip(variants(), before, strict=True))
    return "/".join(name for name, n in (("vector", vec), ("scalar", sca)) if n) or "none"


@contextlib.contextmanager
def lane_threads(threads: int):
    """The team kernels' threads per block (``k_wirepath.LANE_THREADS``)
    while entered."""
    was, k_wirepath.LANE_THREADS = k_wirepath.LANE_THREADS, threads
    try:
        yield
    finally:
        k_wirepath.LANE_THREADS = was


def held(stack, lstate, off: str | None):
    """The slabs with the value slab ``off`` names (``st_val`` or ``lval``)
    moved 4 bytes off 16, the same values."""
    if off == "st_val":
        stack = AcceptorState(stack.rnd, stack.vrnd, off16(stack.value))
    if off == "lval":
        lstate = batched.LearnerState(lstate.delivered, lstate.inst, off16(lstate.value))
    return stack, lstate


def check_k1(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K1 against ``batched.fused_round`` at the paper's deployment widths
    and adversarial windows.  Returns the largest difference (must be 0)."""
    cases = []
    for b in (8, 128):
        cases += [
            dict(a=3, b=b, base=4096, crnd=5, alive=[1, 1, 1], limit=None),  # aligned
            dict(a=3, b=b, base=1003, crnd=5, alive=[1, 1, 1], limit=None),  # misaligned
            dict(a=3, b=b, base=3 * n - b // 2, crnd=7, alive=[1, 1, 1], limit=None),  # ring end
            dict(a=3, b=b, base=2 * n + 77, crnd=4, alive=[1, 0, 1], limit=None),  # dead acceptor
            dict(a=3, b=b, base=777, crnd=6, alive=[1, 1, 1], limit=777 + b // 2),  # reclaim limit
            dict(a=3, b=b, base=640, crnd=-1, alive=[1, 1, 1], limit=None),  # NO_ROUND
        ]
    cases += [
        dict(a=5, b=128, base=n - 60, crnd=9, alive=[1, 0, 1, 1, 0], limit=n + 20),
        dict(a=5, b=128, base=5 * n + 13, crnd=3, alive=[1, 1, 0, 1, 1], limit=None),
        # the scalar variant: V = 5, and V = 16 on value tensors 4 bytes off 16
        dict(a=3, b=128, base=n - 20, crnd=5, alive=[1, 1, 1], limit=None, v=5),
        dict(a=8, b=128, base=1003, crnd=4, alive=[1, 0, 1, 1, 1, 0, 1, 1], limit=1100, v=5),
        dict(a=3, b=128, base=n - 20, crnd=5, alive=[1, 0, 1], limit=None, off="values"),
        dict(a=5, b=128, base=777, crnd=6, alive=[1, 1, 1, 0, 1], limit=800, off="st_val"),
        dict(a=3, b=8, base=2 * n - 3, crnd=7, alive=[1, 1, 1], limit=None, off="lval"),
    ]
    rng = np.random.default_rng(SEED)
    worst = 0
    for case in cases:
        vc, off = case.get("v", v), case.get("off")
        state, values, active, alive, limit = round_inputs(
            rng, case["a"], n, vc, case["b"], case["base"], case["crnd"], case["alive"],
            case["limit"], dev,
        )  # fmt: skip
        twin = clone_state(state)
        state["stack"], state["lstate"] = held(state["stack"], state["lstate"], off)
        ptrs = [t.data_ptr() for t in (*vars(state["stack"]).values(), *vars(state["lstate"]).values())]
        before = variants()
        got = ops.fused_round(**state, values=off16(values) if off == "values" else values, active=active, alive=alive, quorum=case["a"] // 2 + 1, reclaim_limit=limit)  # fmt: skip
        want = batched.fused_round(**twin, values=values, active=active, alive=alive, quorum=case["a"] // 2 + 1, reclaim_limit=limit)  # fmt: skip
        torch.cuda.synchronize()
        variant = variant_since(before)
        st, ls = got[1], got[2]
        if [t.data_ptr() for t in (*vars(st).values(), *vars(ls).values())] != ptrs:
            raise AssertionError("K1 did not update the state in place")
        err = max_abs_err(round_outputs(got), round_outputs(want))
        print(f"  K1 {case}: variant={variant} max_abs_err={err}")
        if variant != ("vector" if vc % 4 == 0 and off is None else "scalar"):
            raise AssertionError(f"K1 took the {variant} variant at {case}")
        if err:
            raise AssertionError(f"K1 disagrees with its plain version: {case}")
        worst = max(worst, err)
    return worst


def k4_variant(geo: k_digest.DigestGeometry) -> str:
    """What a K4 launch runs: its grid and, a leaf, ``vector`` (an int4
    body, with its scalar head and tail words) or ``scalar`` (head and tail
    only) or ``empty``."""
    kinds = ["vector" if s.body else "scalar" if s.head + s.tail else "empty" for s in geo.leaves]
    heads = [f"{s.head}+{s.tail}" for s in geo.leaves]
    return f"{geo.grid[0]} blocks, leaves {'/'.join(kinds)} (head+tail words {','.join(heads)})"


def seal_leaves(k: int, v: int, dev, seed: int, off: int = 0) -> list[torch.Tensor]:
    """A seal's two leaves, insts (K,) and values (K, V), one contiguous
    buffer on the card whose data start ``off`` bytes past 16: so one
    ``torch.sum`` reads exactly the seal's bytes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.empty(k * (1 + v) + 4, dtype=torch.int32, device=dev)
    start = (off - buf.data_ptr()) % 16 // 4
    flat = buf[start : start + k * (1 + v)]
    flat.random_(-(2**31), 2**31, generator=gen)
    return [flat[:k], flat[k:].view(k, v)]


def seal_geometry(leaves: list[torch.Tensor]) -> k_digest.DigestGeometry:
    return k_digest.digest_geometry(
        [x.numel() for x in leaves], [x.data_ptr() % 16 for x in leaves],
        torch.cuda.get_device_properties(leaves[0].device).multi_processor_count,
    )  # fmt: skip


def check_k4(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K4 against ``digest_plain`` on odd lengths and on the leaf lengths of
    the main path's seals (after slice s the prefix holds about s*N/4
    instances and s*N/4*V value words), one leaf a launch; then the tree
    launch, every leaf of a seal in one launch, on the main path's seal
    shapes, on views 4, 8 and 12 bytes off 16, with empty leaves and on 8
    leaves, against ``tree_digest_plain``; that a seal runs one kernel and
    no fill (``torch.profiler``); and one leaf past 2^31 words against the
    plain fold taken chunk by chunk (``digest_plain_chunked``)."""
    rng = np.random.default_rng(SEED + 1)
    worst = 0
    seal_words = [s * n // 4 * w for s in range(1, 7) for w in (1, v)]
    for n_ in (524_287, 524_289, 16_384 * 17, 1, 0, *seal_words):
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                x = torch.from_numpy(rng.integers(-(2**31), 2**31, n_, dtype=np.int32))
            else:
                x = torch.from_numpy(rng.standard_normal(n_).astype(np.float32))
            x = x.to(dev)
            before = k_digest.launches
            got, want = k_digest.digest(x), k_digest.digest_plain(x)
            err = abs(int(got) - int(want))
            print(f"  K4 n={n_} {dtype}: {int(got)} vs {int(want)}")
            if err or k_digest.launches != before + 1:
                raise AssertionError(f"K4 disagrees with its plain version at n={n_} {dtype}")
            worst = max(worst, err)
    cases = [(f"seal after slice {s}", seal_leaves(s * n // 4, v, dev, SEED + s))
             for s in range(1, 7)]  # fmt: skip
    for off in (4, 8, 12):
        leaves = seal_leaves(n // 4, v, dev, SEED + off, off)
        cases.append((f"seal of N/4 {off} bytes off 16", leaves))
    odd = [(0, 0), (1_000_001, 4), (0, 8), (7, 12), (5, 4), (70_001, 8), (3, 0), (262_147, 12)]
    leaves = []
    for k, (words, off) in enumerate(odd):
        buf = torch.empty(words + 4, dtype=(torch.int32, torch.float32)[k % 2], device=dev)
        leaf = buf[(off - buf.data_ptr()) % 16 // 4 :][:words]
        leaf.copy_(torch.from_numpy(rng.integers(-(2**31), 2**31, words, dtype=np.int32))
                   .view(leaf.dtype))  # fmt: skip
        leaves.append(leaf)
    cases.append(("8 leaves: empty, odd, float32, views off 16", leaves))
    for name, leaves in cases:
        before = k_digest.launches
        got = k_digest.tree_digest(leaves).tolist()
        want = k_digest.tree_digest_plain(leaves).tolist()
        err = max(abs(a - b) for a, b in zip(got, want, strict=True))
        print(f"  K4 tree {name}: {k4_variant(seal_geometry(leaves))}: {got} vs {want}")
        if err or k_digest.launches != before + 1:
            raise AssertionError(f"K4's tree launch disagrees with its plain version: {name}")
        worst = max(worst, err)
    leaves = seal_leaves(6 * n // 4, v, dev, SEED)
    ops.tree_digest(leaves)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ops.tree_digest(leaves)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")
               and not e.name.startswith("Memcpy")]  # fmt: skip
    print(f"  K4 a seal's device work (torch.profiler): {kernels} and its one read-back")
    if len(kernels) != 1 or not kernels[0].startswith("tree_digest_kernel"):
        raise AssertionError(f"a seal ran {kernels}, not one K4 launch and no fill")
    worst = max(worst, check_k4_past_int32(dev))
    return worst


def check_k4_past_int32(dev, words: int = 2**31 + 2**20 + 3) -> int:
    """One leaf of ``words`` (past 2^31, 8.6 GB), a view 4 bytes off 16, on
    the card: K4 against the plain fold taken 2^26 words at a time, whose
    identity ``D(x) = sum_c [D(x_c) + 2 o_c S(x_c)]`` the CPU tests hold."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    buf = torch.empty(words + 4, dtype=torch.int32, device=dev)
    x = buf[(4 - buf.data_ptr()) % 16 // 4 :][:words]
    x.random_(-(2**31), 2**31, generator=gen)
    got = int(k_digest.digest(x))
    want = int(k_digest.digest_plain_chunked(x, 1 << 26))
    print(f"  K4 one leaf of {words} words ({4 * words / 1e9:.2f} GB, "
          f"{k4_variant(seal_geometry([x]))}): {got} vs chunked plain {want}")  # fmt: skip
    del x, buf
    torch.cuda.empty_cache()
    if got != want:
        raise AssertionError("K4 disagrees with the chunked plain fold past 2^31 words")
    return abs(got - want)


def check_k3(dev) -> int:
    """K3 against ``batched.coordinator_sequence``: bursts of 8, 128, 129, 3
    and 4096 at aligned, misaligned and negative watermarks and at
    watermarks near int32 max, where the instances wrap, with ``active``
    on 4 bytes and 1 to 3 bytes off."""
    rng = np.random.default_rng(SEED + 5)
    worst = 0
    for b, off in ((8, 0), (128, 0), (128, 1), (129, 0), (3, 2), (4096, 0), (4096, 3)):
        for base in (0, 4096, 1003, -77, 2**31 - 1 - b // 2, 2**31 - 1):
            cstate = CoordinatorState.init(crnd=11, next_inst=base, device=dev)
            values = torch.from_numpy(rng.integers(0, 1 << 20, (b, 16), dtype=np.int32)).to(dev)
            buf = torch.empty(b + 4, dtype=torch.bool, device=dev)
            active = buf[(off - buf.data_ptr()) % 4 :][:b]
            active.copy_(torch.from_numpy(rng.random(b) < 0.8))
            before = k_coordinator.launches
            gc, gp = ops.coordinator_sequence(cstate, values, active)
            wc, wp = batched.coordinator_sequence(cstate, values, active)
            err = max_abs_err([gc.next_inst, gc.crnd, *gp.tensors()],
                              [wc.next_inst, wc.crnd, *wp.tensors()])  # fmt: skip
            print(f"  K3 b={b} active {off} bytes off 4, next_inst={base}: max_abs_err={err}")
            if err or k_coordinator.launches != before + 1:
                raise AssertionError(f"K3 disagrees with its plain version at {base}, {b}")
            worst = max(worst, err)
    return worst


def phase2_batch(rng, inst, rnd, v: int, dev, nop_share: float = 0.25) -> MsgBatch:
    """A Phase-2 batch at ``inst``: P2As at ``rnd``, a share of NOP fillers
    (which vote like P2As), values random."""
    b = len(inst)
    msgtype = np.where(rng.random(b) < nop_share, 0, 3).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    return MsgBatch(
        msgtype=t(msgtype),
        inst=t(inst),
        rnd=t(np.broadcast_to(rnd, (b,))),
        vrnd=t(np.full(b, -1)),
        swid=t(np.zeros(b)),
        value=t(rng.integers(-(2**31), 2**31, (b, v), dtype=np.int32)),
    )


def recovery_batch(inst0: int, crnd: int, b: int, v: int, dev) -> MsgBatch:
    """The shape ``PaxosContext._recover_votes`` votes: a window at an
    arbitrary instance, lane 0 a P2A at ``crnd``, the rest NOPs at NO_ROUND."""
    m = MsgBatch.nop(b, v, dev).replace(
        inst=torch.arange(inst0, inst0 + b, dtype=torch.int32, device=dev)
    )
    m.msgtype[0] = 3
    m.rnd[0] = crnd
    m.value[0] = torch.arange(1, v + 1, dtype=torch.int32, device=dev)
    return m


def check_votes(dev, n: int = 1 << 16, v: int = 16) -> tuple[int, int, list]:
    """K2 on the stacked rings and K7 on each acceptor's own register file
    against the plain engine (``batched.acceptor_phase2_all`` and
    ``batched.acceptor_phase2``), at A in {3, 5} and B in {8, 128}: aligned,
    misaligned and ring-end windows, a dead acceptor, a stale round (every
    lane rejected), NOP fillers, a recovery window at an arbitrary instance,
    the state updated in place; K2 and K7 in their vector variant there,
    then K2 in its scalar one at V = 5 and with the burst a view 4 bytes off
    16 into a larger one or ``st_val`` 4 bytes off 16
    (``check_k2_variants``); both against the first design's one-thread
    body (``check_k2_against_k7``); K7 in both variants, at B = 100 and 512
    (``check_k7_variants``).  Returns the largest differences of K2 and K7
    and the vote batches K2 made, for K8's check."""
    rng = np.random.default_rng(SEED + 6)
    worst2 = worst7 = 0
    made = []
    for a, alive in ((3, [1, 1, 1]), (3, [1, 0, 1]), (5, [1, 1, 0, 1, 0])):
        for b in (8, 128):
            crnd = 6
            state = AcceptorState(
                torch.from_numpy(rng.integers(0, crnd + 2, (a, n), dtype=np.int32)).to(dev),
                torch.from_numpy(rng.integers(-1, crnd + 2, (a, n), dtype=np.int32)).to(dev),
                torch.from_numpy(rng.integers(-(2**31), 2**31, (a, n, v), dtype=np.int32)).to(dev),
            )
            twin = AcceptorState(*(x.clone() for x in vars(state).values()))
            files = [AcceptorState(*(x[i].clone() for x in vars(state).values())) for i in range(a)]
            twins = [AcceptorState(*(x.clone() for x in vars(f).values())) for f in files]
            tensors = [*vars(state).values(), *(x for f in files for x in vars(f).values())]
            ptrs = [x.data_ptr() for x in tensors]
            alv = torch.tensor(alive, dtype=torch.bool, device=dev)
            cases = [
                ("aligned", phase2_batch(rng, 4096 + np.arange(b), crnd, v, dev)),
                ("misaligned", phase2_batch(rng, 1003 + np.arange(b), crnd, v, dev)),
                ("ring end", phase2_batch(rng, 3 * n - b // 2 + np.arange(b), crnd, v, dev)),
                ("stale round", phase2_batch(rng, 640 + np.arange(b), -1, v, dev)),
                ("NOP fillers", phase2_batch(rng, 2 * n + 9 + np.arange(b), crnd + 1, v, dev, 0.9)),
                ("recovery", recovery_batch(5 * n + 31_337, crnd + 16, b, v, dev)),
                ("scattered", phase2_batch(
                    rng, rng.permutation(n)[:b] + rng.integers(0, 9, b) * n, crnd + 2, v, dev)),
            ]  # fmt: skip
            for name, msgs in cases:
                before = variants()
                st, got = ops.acceptor_phase2_all(state, msgs, alv)
                _, want = batched.acceptor_phase2_all(twin, msgs, alv)
                err2 = max_abs_err([*got.tensors(), *vars(state).values()],
                                   [*want.tensors(), *vars(twin).values()])  # fmt: skip
                err7 = 0
                returned = [*vars(st).values()]
                for i in range(a):
                    fi, mine = ops.acceptor_phase2(files[i], msgs, i)
                    _, plain = batched.acceptor_phase2(twins[i], msgs, i)
                    returned += vars(fi).values()
                    err7 = max(err7, max_abs_err(
                        [*mine.tensors(), *vars(files[i]).values()],
                        [*plain.tensors(), *vars(twins[i]).values()]))  # fmt: skip
                torch.cuda.synchronize()
                if [x.data_ptr() for x in returned] != ptrs:
                    raise AssertionError("K2 or K7 did not update the state in place")
                if name == "stale round" and bool((got.msgtype == 4).any()):
                    raise AssertionError("a stale round was accepted")
                variant = variant_since(before)
                print(f"  K2/K7 a={a} alive={alive} b={b} {name}: K2+K7 variant={variant} "
                      f"max_abs_err K2={err2} K7={err7}")  # fmt: skip
                if err2 or err7:
                    raise AssertionError(f"K2 or K7 disagrees with the plain engine: {name}")
                if variant != "vector":
                    raise AssertionError(f"K2 or K7 took the {variant} variant at V={v}, aligned")
                worst2, worst7 = max(worst2, err2), max(worst7, err7)
                made.append((got, a))
    witnessed2, witnessed7 = check_k2_against_k7(dev, n, v)
    worst2 = max(worst2, check_k2_variants(dev, n), witnessed2)
    worst7 = max(worst7, witnessed7, check_k7_variants(dev, n))
    return worst2, worst7, made


def vote_case(rng, a, n, v, crnd, dev):
    """Random acceptor rings whose promises straddle ``crnd``, and a plain
    twin."""
    state = AcceptorState(
        torch.from_numpy(rng.integers(0, crnd + 2, (a, n), dtype=np.int32)).to(dev),
        torch.from_numpy(rng.integers(-1, crnd + 2, (a, n), dtype=np.int32)).to(dev),
        torch.from_numpy(rng.integers(-(2**31), 2**31, (a, n, v), dtype=np.int32)).to(dev),
    )
    return state, AcceptorState(*(x.clone() for x in vars(state).values()))


def check_k2_variants(dev, n: int) -> int:
    """K2's scalar variant against the plain engine: V = 5; V = 16 with the
    burst a view 4 bytes off 16 into a larger burst (as a caller's slice
    of one); V = 16 with ``st_val`` 4 bytes off 16; and V = 1 at A = 8.
    Each case asserts and prints the variant it took.  Returns the largest
    difference."""
    rng = np.random.default_rng(SEED + 25)
    worst, b, crnd = 0, 128, 6
    variant_cases = (
        (3, 5, None, [1, 0, 1], 1003),
        (3, 16, "burst", [1, 1, 1], n - 60),
        (5, 16, "st_val", [1, 1, 0, 1, 1], 4096),
        (8, 1, None, [1, 0, 1, 1, 1, 0, 1, 1], 3 * n + 9),
    )
    for a, vc, off, alive, base in variant_cases:
        state, twin = vote_case(rng, a, n, vc, crnd, dev)
        if off == "st_val":
            state = AcceptorState(state.rnd, state.vrnd, off16(state.value))
        msgs = phase2_batch(rng, base + np.arange(b), crnd, vc, dev)
        if off == "burst":  # rows 1..B of a (B + 1)-row burst, 4 bytes off 16 at V = 16
            whole = torch.cat([msgs.value[:1], msgs.value]).reshape(-1)
            view = off16(whole)[vc:].view(b, vc)
            if not view.is_contiguous() or view.data_ptr() % 16 != 4:
                raise AssertionError("check_k2_variants: the burst view is not 4 bytes off 16")
            msgs = msgs.replace(value=view)
        alv = torch.tensor(alive, dtype=torch.bool, device=dev)
        before = variants()
        _, got = ops.acceptor_phase2_all(state, msgs, alv)
        _, want = batched.acceptor_phase2_all(twin, msgs, alv)
        sync(dev)
        variant = variant_since(before)
        err = max_abs_err([*got.tensors(), *vars(state).values()],
                          [*want.tensors(), *vars(twin).values()])  # fmt: skip
        print(f"  K2 a={a} v={vc} off16={off}: variant={variant} max_abs_err={err}")
        if err:
            raise AssertionError(f"K2 disagrees with the plain engine at a={a} v={vc} off16={off}")
        if variant != "scalar":
            raise AssertionError(f"K2 took the {variant} variant at v={vc} off16={off}")
        worst = max(worst, err)
    return worst


def check_k2_against_k7(dev, n: int, v: int) -> tuple[int, int]:
    """K2's and K7's team body against the first design's one-thread
    ``vote_lane`` (``acceptor_phase2_witness``): at A=3, B=128, acceptor 1
    dead, over an aligned, a ring-end and a scattered window, in both
    variants (V = 16 and V = 5), each alive acceptor's vote row and
    registers from K2, and from K7 on a clone of that acceptor's file, must
    equal the witness's on another clone; the dead acceptor's row and
    registers equal the plain engine's.  Returns the largest differences of
    K2 and K7."""
    rng = np.random.default_rng(SEED + 26)
    a, b, crnd, alive = 3, 128, 6, [1, 0, 1]
    alv = torch.tensor(alive, dtype=torch.bool, device=dev)
    worst2 = worst7 = 0
    for vc in (v, 5):
        state, twin = vote_case(rng, a, n, vc, crnd, dev)

        def clones():
            return {i: AcceptorState(*(x[i].clone() for x in vars(state).values()))
                    for i in range(a) if alive[i]}  # fmt: skip

        files, witness = clones(), clones()
        windows = (
            ("aligned", 4096 + np.arange(b)),
            ("ring end", 3 * n - b // 2 + np.arange(b)),
            ("scattered", rng.permutation(n)[:b] + rng.integers(0, 9, b) * n),
        )
        for name, inst in windows:
            msgs = phase2_batch(rng, inst, crnd + rng.integers(-1, 2), vc, dev)
            before = variants()
            _, got = ops.acceptor_phase2_all(state, msgs, alv)
            _, plain = batched.acceptor_phase2_all(twin, msgs, alv)
            k2_variant = variant_since(before)
            before = variants()
            k7 = {i: ops.acceptor_phase2(f, msgs, i)[1] for i, f in files.items()}
            k7_variant = variant_since(before)
            k2_rows, k7_rows, want2, want7 = [], [], [], []
            for i in range(a):
                k2_rows += [x[i] for x in got.tensors()] + [x[i] for x in vars(state).values()]
                if not alive[i]:
                    want2 += [x[i] for x in plain.tensors()] + [x[i] for x in vars(twin).values()]
                    continue
                *_, wt, wi, wr, wv, ws, wval = k_acceptor.acceptor_phase2_witness(
                    *vars(witness[i]).values(), i, msgs.msgtype, msgs.inst, msgs.rnd, msgs.value)
                row = [wt, wi, wr, wv, ws, wval, *vars(witness[i]).values()]
                want2 += row
                want7 += row
                k7_rows += [*k7[i].tensors(), *vars(files[i]).values()]
            sync(dev)
            err2, err7 = max_abs_err(k2_rows, want2), max_abs_err(k7_rows, want7)
            print(f"  K2 and K7 against the witness v={vc} {name}: K2 variant={k2_variant} "
                  f"K7 variant={k7_variant} max_abs_err K2={err2} K7={err7}")  # fmt: skip
            if err2 or err7:
                raise AssertionError(f"K2 or K7 disagrees with the witness: v={vc} {name}")
            worst2, worst7 = max(worst2, err2), max(worst7, err7)
    return worst2, worst7


def check_k7_variants(dev, n: int) -> int:
    """K7 against ``batched.acceptor_phase2`` where its launch shape moves:
    V = 5 and V = 1; V = 16 with the burst a view 4 bytes off 16 into a
    larger burst, and with ``st_val`` 4 bytes off 16 (all scalar); B = 100
    (not a multiple of a block's 32 lanes) and Table 1's B = 512 (vector).
    Each case asserts and prints the variant it took.  Returns the largest
    difference."""
    rng = np.random.default_rng(SEED + 27)
    worst, crnd = 0, 6
    cases = (  # V, B, the tensor 4 bytes off 16, the variant
        (5, 128, None, "scalar"),
        (1, 128, None, "scalar"),
        (16, 128, "burst", "scalar"),
        (16, 128, "st_val", "scalar"),
        (16, 100, None, "vector"),
        (16, 512, None, "vector"),
    )
    for vc, b, off, want in cases:
        state, twin = vote_case(rng, 1, n, vc, crnd, dev)
        file = AcceptorState(*(x[0] for x in vars(state).values()))
        plain_file = AcceptorState(*(x[0] for x in vars(twin).values()))
        if off == "st_val":
            file = AcceptorState(file.rnd, file.vrnd, off16(file.value))
        msgs = phase2_batch(rng, n - b // 3 + np.arange(b), crnd, vc, dev)
        if off == "burst":
            whole = torch.cat([msgs.value[:1], msgs.value]).reshape(-1)
            msgs = msgs.replace(value=off16(whole)[vc:].view(b, vc))
        before = variants()
        _, got = ops.acceptor_phase2(file, msgs, 2)
        _, plain = batched.acceptor_phase2(plain_file, msgs, 2)
        sync(dev)
        variant = variant_since(before)
        err = max_abs_err([*got.tensors(), *vars(file).values()],
                          [*plain.tensors(), *vars(plain_file).values()])  # fmt: skip
        print(f"  K7 v={vc} b={b} off16={off}: variant={variant} max_abs_err={err}")
        if err or variant != want:
            raise AssertionError(f"K7 at v={vc} b={b} off16={off}: variant {variant}, err {err}")
        worst = max(worst, err)
    return worst


def check_k8(dev, made: list, v: int = 16) -> int:
    """K8 against ``learner.learner_quorum_plain`` on the vote batches K2
    made above and on foreign votes: mixed vrnds, and lanes where no
    acceptor agrees whose REJECT votes carry non-zero values (value 0)."""
    rng = np.random.default_rng(SEED + 7)
    cases = [(f"K2's votes a={a}", a, m.msgtype, m.vrnd, m.value) for m, a in made]
    for a in (3, 5):
        for b in (8, 128):
            vtype = rng.choice([4, 4, 4, 7], (a, b)).astype(np.int32)
            vtype[:, ::3] = 7  # no acceptor agrees on every third lane
            cases.append((f"foreign a={a} b={b}", a, *(torch.from_numpy(x).to(dev) for x in (
                vtype,
                rng.integers(-3, 9, (a, b), dtype=np.int32),
                rng.integers(1, 2**31, (a, b, v), dtype=np.int32),
            ))))  # fmt: skip
    worst = 0
    for name, a, vtype, vrnd, value in cases:
        got = k_learner.learner_quorum_window(a // 2 + 1, vtype, vrnd, value)
        want = k_learner.learner_quorum_plain(a // 2 + 1, vtype, vrnd, value)
        err = max_abs_err(got, want)
        if name.startswith("foreign") and bool(got[2][::3].any()):
            raise AssertionError("K8 gave a value on a lane where no acceptor agrees")
        if err:
            raise AssertionError(f"K8 disagrees with its plain version: {name}")
        worst = max(worst, err)
    print(f"  K8: {len(cases)} cases, max_abs_err={worst}")
    return max(worst, check_k8_shapes(dev))


def k8_votes(rng, a: int, b: int, v: int, first: int | None, dev):
    """Votes whose first agreeing acceptor is ``first`` on every lane (None:
    no acceptor agrees): acceptors before it REJECT with non-zero values,
    after it P2B at the winning round or one below (which do not agree)."""
    vtype = np.full((a, b), 4, np.int32)
    vrnd = np.where(rng.random((a, b)) < 0.5, 7, 6).astype(np.int32)
    if first is None:
        vtype[:] = 7
    else:
        vtype[:first] = 7
        vrnd[first] = 7
    value = rng.integers(1, 2**31, (a, b, v), dtype=np.int32)
    return [torch.from_numpy(x).to(dev) for x in (vtype, vrnd, value)]


def check_k8_shapes(dev) -> int:
    """K8 where its design branches: the first agreeing acceptor 0, 1, A-1
    or none, at A = 1, 3, 5 and 9 (above the ``VOTE_CAP`` = 8 acceptors a
    thread loads up front, so it reloads past the cap); in both variants
    (V = 16; V = 5, and the vote values 4 bytes off 16: scalar); B = 100
    (not a multiple of a block's 32 lanes) and Table 1's B = 512.  Each case
    asserts the variant it took.  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 28)
    shapes = (  # V, B, vote values 4 bytes off 16, the variant
        (16, 128, False, "vector"),
        (16, 100, False, "vector"),
        (16, 512, False, "vector"),
        (5, 128, False, "scalar"),
        (16, 128, True, "scalar"),
    )
    worst, count = 0, 0
    for a in (1, 3, 5, k_learner.VOTE_CAP + 1):
        for first in sorted({0, min(1, a - 1), a - 1}) + [None]:
            for vc, b, off, want in shapes:
                vtype, vrnd, value = k8_votes(rng, a, b, vc, first, dev)
                if off:
                    value = off16(value)
                before = variants()
                got = k_learner.learner_quorum_window(a // 2 + 1, vtype, vrnd, value)
                plain = k_learner.learner_quorum_plain(a // 2 + 1, vtype, vrnd, value)
                sync(dev)
                variant = variant_since(before)
                err = max_abs_err(got, plain)
                if err or variant != want:
                    raise AssertionError(f"K8 at a={a} first={first} v={vc} b={b} off16={off}: "
                                         f"variant {variant}, max_abs_err {err}")  # fmt: skip
                if first is None and bool(got[2].any()):
                    raise AssertionError("K8 gave a value on a lane where no acceptor agrees")
                worst, count = max(worst, err), count + 1
            print(f"  K8 a={a} first agreeing={first}: {len(shapes)} shapes (vector and "
                  f"scalar, b=100, 512, off16) max_abs_err={worst}")  # fmt: skip
    print(f"  K8 shapes: {count} cases, max_abs_err={worst}")
    return worst


def mg_state(rng, g, a, n, v, b, bases, crnds, dev):
    """Random protocol-valid ``(G, ...)`` slabs for one cohort round: each
    group's promises straddle its round and part of its learner ring already
    holds its window's instances (duplicates)."""
    top = max(max(crnds), 0) + 3
    linst = rng.integers(-1, 1 << 20, (g, n), dtype=np.int32)
    for gi, base in enumerate(bases):
        inst = (np.int64(base) + np.arange(b)).astype(np.int64)
        inst = ((inst + 2**31) % 2**32 - 2**31).astype(np.int32)  # int32 wrap
        dup = rng.random(b) < 0.3
        linst[gi, inst[dup].astype(np.int64) % n] = inst[dup]

    def t(x, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    stack = AcceptorState(
        t(rng.integers(0, top, (g, a, n), dtype=np.int32)),
        t(rng.integers(-1, top, (g, a, n), dtype=np.int32)),
        t(rng.integers(-(2**31), 2**31, (g, a, n, v), dtype=np.int32)),
    )
    lstate = batched.LearnerState(
        t(rng.integers(0, 2, (g, n), dtype=np.int32)),
        t(linst),
        t(rng.integers(-(2**31), 2**31, (g, n, v), dtype=np.int32)),
    )
    return stack, lstate


def clone_slabs(stack, lstate):
    return (AcceptorState(*(x.clone() for x in vars(stack).values())),
            batched.LearnerState(*(x.clone() for x in vars(lstate).values())))  # fmt: skip


def cohort_cases(n: int, b: int):
    """The kernel phase's cohort cases at G=8: GB in {1, 2, 8}; gsel a single
    block, a subset and all blocks; disabled members inside selected
    (folded) blocks; enabled members of a block in lockstep at a base that
    is aligned, misaligned, at the ring end or across 2^31 (the int32 wrap
    of ``ni + lane``); inert members at divergent bases."""
    g = 8
    block_bases = [4096, 1003, 3 * n - b // 2, 2**31 - b // 2, 5 * n + 13, 640, 2 * n + 77, 9]
    sels = {
        1: {"single": [7], "subset": [1, 4, 6], "all": list(range(8))},
        2: {"single": [2], "subset": [0, 3], "all": [0, 1, 2, 3]},
        8: {"all": [0]},
    }
    out = []
    for gb, by_name in sels.items():
        for name, gsel in by_name.items():
            bases = [block_bases[gi // gb] for gi in range(g)]
            enabled = [1] * g
            for blk in gsel:
                if gb > 1:  # one inert member per selected folded block
                    k = blk * gb + 1
                    enabled[k] = 0
                    bases[k] = 7 * n + 3 * k  # a divergent base: it must not matter
            if gb == 1 and name != "single":
                enabled[gsel[-1]] = 0  # an inert one-group block
            out.append(dict(gb=gb, sel=name, gsel=gsel, bases=bases, enabled=enabled))
    return out


def check_k1_cohort(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K1 in cohort form (``ops.cohort_fused_round``) against its plain
    version (``batched.cohort_fused_round``) at A=3, N=65,536, V=16, G=8,
    B in {16, 128}, over ``cohort_cases`` (and every third of them at V=5
    and with the burst or the learner's values 4 bytes off 16: the scalar
    variant), with dead acceptors (one group
    below quorum), a frozen group (NO_ROUND), a reclaim limit inside a
    window and one that wrapped past int32 max (negative: it refuses every
    lane but those whose instance wrapped too), the state updated in place;
    and the full-width slice (``ops.multigroup_fused_round``) against
    ``batched.multigroup_fused_round``.  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 12)
    g, a, q = 8, 3, 2
    alive = np.ones((g, a), bool)
    alive[2, 1] = False  # one dead acceptor: still a quorum
    alive[5, [0, 2]] = False  # two dead: below quorum, nothing decides
    worst = 0
    # (B, V, the value tensor held 4 bytes off 16): the paths' vector variant,
    # then the scalar one at V = 5 and on misaligned views, on every third case
    for b, vc, off in ((16, v, None), (128, v, None), (128, 5, None), (128, v, "values"),
                       (128, v, "lval")):  # fmt: skip
        full_width = [dict(gb=8, sel="full width", gsel=None, bases=None)]
        cases = cohort_cases(n, b)
        for case in (cases if vc == v and off is None else cases[::3]) + full_width:
            full = case["gsel"] is None
            bases = case["bases"] or [4096 + 128 * (gi % 2) for gi in range(g)]
            enabled = case.get("enabled") or [1, 1, 0, 1, 1, 1, 1, 1]
            crnds = [int(c) for c in rng.integers(1, 7, g)]
            crnds[6] = -1  # a frozen group
            marks = [0] * g
            marks[3] = 2**31 - 100  # its limit wraps to a negative number
            limit = np.asarray(marks, np.int32) + n  # the reference's expression
            limit[1] = np.int32(bases[1] + b // 2)  # refuses the upper half
            stack, lstate = mg_state(rng, g, a, n, vc, b, bases, crnds, dev)
            twin = clone_slabs(stack, lstate)
            stack, lstate = held(stack, lstate, off)
            ptrs = [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())]

            def t(x, dt=torch.int32):
                return torch.from_numpy(np.asarray(x)).to(dev, dt)

            ni, cr, al, en = t(bases), t(crnds), t(alive, torch.bool), t(enabled)
            before = variants()
            if full:
                values = t(rng.integers(-(2**31), 2**31, (g, b, vc), dtype=np.int32))
                cstate = CoordinatorState(ni, cr)
                act = torch.ones((g, b), dtype=torch.bool, device=dev)
                got = ops.multigroup_fused_round(cstate, stack, lstate,
                                                 off16(values) if off == "values" else values,
                                                 act, al, q, en, limit, group_block=8)  # fmt: skip
                want = batched.multigroup_fused_round(cstate, *twin, values, act, al, q, en, limit)
                outs = [got[0].next_inst, got[0].crnd, *got[3:]]
                ref = [want[0].next_inst, want[0].crnd, *want[3:]]
            else:
                gb, gsel = case["gb"], case["gsel"]
                values = t(rng.integers(-(2**31), 2**31, (len(gsel) * gb, b, vc), dtype=np.int32))
                got = ops.cohort_fused_round(stack, lstate, gsel, ni, cr, al, q,
                                             off16(values) if off == "values" else values, en,
                                             limit, group_block=gb)  # fmt: skip
                want = batched.cohort_fused_round(*twin, gsel, ni, cr, al, q, values, en, limit,
                                                  group_block=gb)  # fmt: skip
                outs, ref = list(got[2:]), list(want[2:])
                rows = [blk * gb + k for blk in gsel for k in range(gb)]
                for r, gi in enumerate(rows):  # inert, frozen and sub-quorum rows decide nothing
                    if (not enabled[gi] or gi in (5, 6)) and bool(got[2][r].any()):
                        raise AssertionError(f"group {gi} decided while inert or refused")
                    inert = not enabled[gi] or gi == 6
                    if inert and (bool(got[4][r].any()) or bool((got[3][r] != -1).any())):
                        raise AssertionError(f"inert group {gi}: win not NO_ROUND or value not 0")
            sync(dev)
            variant = variant_since(before)
            now = [x.data_ptr() for x in (*vars(stack).values(), *vars(lstate).values())]
            if now != ptrs:
                raise AssertionError("K1 (cohort form) did not update the state in place")
            state = [*vars(stack).values(), *vars(lstate).values()]
            plain = [*vars(twin[0]).values(), *vars(twin[1]).values()]
            err = max_abs_err([*state, *(x.to(torch.int32) for x in outs)],
                              [*plain, *(x.to(torch.int32) for x in ref)])  # fmt: skip
            print(f"  K1-cohort b={b} v={vc} off16={off} gb={case['gb']} {case['sel']} "
                  f"gsel={case['gsel']} enabled={enabled}: variant={variant} "
                  f"max_abs_err={err}")  # fmt: skip
            if err:
                raise AssertionError(f"K1 (cohort form) disagrees with its plain version: {case}")
            if variant != ("vector" if vc % 4 == 0 and off is None else "scalar"):
                raise AssertionError(f"K1 (cohort form) took the {variant} variant at {case}")
            worst = max(worst, err)
    return worst


def wave_walk(bases, wen: np.ndarray, b: int) -> np.ndarray:
    """A wave descriptor's window bases: ``wni[0] = bases``, ``wni[k+1] =
    wni[k] + B * wen[k]``, in int32 (so a wave across 2^31 wraps)."""
    wni = np.zeros(wen.shape, np.int64)
    wni[0] = bases
    for r in range(1, wen.shape[0]):
        wni[r] = wni[r - 1] + b * wen[r - 1]
    return ((wni + 2**31) % 2**32 - 2**31).astype(np.int32)


def check_k5(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K5 (``ops.persistent_cohort_rounds``) against its plain version
    (``batched.persistent_cohort_rounds``) at A=3, N=65,536, V=16, G=8:
    B in {16, 128} with K cycling over {1, 2, 8}, and K * B = N (K=512 at
    B=128); the selections of ``cohort_cases`` (GB in {1, 2, 8}; one block,
    a subset, all; inert members inside folded blocks at divergent bases;
    windows across the ring end and across 2^31); one member of each wave
    frozen from round 2 on (``wen`` 0); dead acceptors (one group below
    quorum) and a frozen round (NO_ROUND); a limit inside the wave and one
    that wrapped past int32 max; blocks of 128, 64 and 256 threads (with
    ``block_b`` 128, 32 and 128, which changes nothing); the state updated
    in place; the vector variant, then the scalar one on a wave at V=5 and
    on waves whose burst, ``st_val`` or ``lval`` is 4 bytes off 16, each
    case printing its variant.  Then one wave against K sequential K1-cohort
    launches over the same descriptor, and waves at the grid's z edge.
    Returns the largest difference."""
    rng = np.random.default_rng(SEED + 16)
    g, a, q = 8, 3, 2
    alive = np.ones((g, a), bool)
    alive[2, 1] = False  # one dead acceptor: still a quorum
    alive[5, [0, 2]] = False  # two dead: below quorum, nothing decides

    def t(x, dt=torch.int32):
        return torch.from_numpy(np.asarray(x)).to(dev, dt)

    cases = [dict(case, b=b, k=(1, 2, 8)[i % 3]) for b in (16, 128)
             for i, case in enumerate(cohort_cases(n, b))]  # fmt: skip
    cases.append(dict(gb=8, sel="all, K*B = N", gsel=[0], bases=[4096] * g, enabled=[1] * g,
                      b=128, k=n // 128))  # fmt: skip
    cases.append(dict(cohort_cases(n, 128)[4], b=128, k=8, v=5))  # GB=2, a subset, V=5
    for i, off in ((1, "values"), (3, "st_val"), (6, "lval")):  # the scalar variant, V=16
        cases.append(dict(cohort_cases(n, 128)[i], b=128, k=8, off=off))
    worst = 0
    for case in cases:
        b, k, gb, gsel, bases = case["b"], case["k"], case["gb"], case["gsel"], case["bases"]
        vc, off = case.get("v", v), case.get("off")
        rows = [blk * gb + j for blk in gsel for j in range(gb)]
        wen = np.zeros((k, g), np.int32)
        for gi in rows:
            wen[:, gi] = case["enabled"][gi]
        frozen = next(gi for gi in rows if case["enabled"][gi])
        wen[2:, frozen] = 0  # frozen from round 2 on
        wni = wave_walk(bases, wen, b)
        crnds = [int(c) for c in rng.integers(1, 7, g)]
        crnds[6] = -1  # a frozen group
        marks = [0] * g
        marks[3] = 2**31 - 100  # its limit wraps to a negative number
        limit = np.asarray(marks, np.int32) + n  # the reference's expression
        limit[1] = np.int32(bases[1] + k * b // 2)  # bites inside the wave
        stack, lstate = mg_state(rng, g, a, n, vc, k * b, bases, crnds, dev)
        twin = clone_slabs(stack, lstate)
        cr, al = t(crnds), t(alive, torch.bool)
        values = t(rng.integers(-(2**31), 2**31, (k, len(rows), b, vc), dtype=np.int32))
        want = batched.persistent_cohort_rounds(*twin, gsel, wni, wen, cr, al, q, values, limit,
                                                group_block=gb)  # fmt: skip
        plain = [*vars(want[0]).values(), *vars(want[1]).values(), want[2].to(torch.int32),
                 *want[3:]]  # fmt: skip
        errs, ran = [], []
        for block_b, threads in ((128, 128), (32, 64), (128, 256)):
            mine = held(*clone_slabs(stack, lstate), off)
            ptrs = [x.data_ptr() for x in (*vars(mine[0]).values(), *vars(mine[1]).values())]
            before = variants()
            with lane_threads(threads):
                got = ops.persistent_cohort_rounds(
                    *mine, gsel, wni, wen, cr, al, q, off16(values) if off == "values" else values,
                    limit, group_block=gb, block_b=block_b,
                )  # fmt: skip
            sync(dev)
            ran.append(variant_since(before))
            state = [*vars(got[0]).values(), *vars(got[1]).values()]
            if [x.data_ptr() for x in state] != ptrs:
                raise AssertionError("K5 did not update the state in place")
            errs.append(max_abs_err([*state, got[2].to(torch.int32), *got[3:]], plain))
            inert = torch.from_numpy(wen[:, rows] == 0).to(dev)  # (K, C)
            if bool(got[2][inert].any() or (got[3][inert] != -1).any() or got[4][inert].any()):
                raise AssertionError(f"K5: an inert round of {case} decided or voted")
        print(f"  K5 b={b} k={k} v={vc} off16={off} gb={gb} {case['sel']} gsel={gsel} "
              f"frozen={frozen} from round 2: variant={ran[0]} max_abs_err={max(errs)} "
              f"(128, 64, 256 threads: {errs})")  # fmt: skip
        if max(errs):
            raise AssertionError(f"K5 disagrees with its plain version: {case}")
        if set(ran) != {"vector" if vc % 4 == 0 and off is None else "scalar"}:
            raise AssertionError(f"K5 took the {ran} variants at {case}")
        worst = max(worst, *errs)
    worst = max(worst, check_k5_against_k1(dev, n, v), check_k5_z_edge(dev))
    return worst


def check_k5_z_edge(dev) -> int:
    """K5 where the rounds outgrow the grid's z extent (65,535): at B = 1,
    K * B <= N admits K up to N, so waves of K = 65,535 (one round a z
    block) and K = 65,536 and 140,000 (blocks serve rounds z, z + 65,535,
    ...), G=2 with group 1 selected, windows across the ring end, a dead
    acceptor, both variants.  A wave of K rounds of one lane at B = 1 with
    every round enabled is one K-lane window: it is held against one
    ``batched.cohort_fused_round`` of B = K (outputs transposed), the state
    compared whole.  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 27)
    g, a, q, worst = 2, 3, 2, 0
    for k, n, vc in ((65_535, 1 << 16, 16), (1 << 16, 1 << 16, 16), (140_000, 1 << 18, 5)):
        base = n - 7
        stack, lstate = mg_state(rng, g, a, n, vc, k, [base] * g, [5] * g, dev)
        twin = clone_slabs(stack, lstate)
        wen = np.ones((k, g), np.int32)
        wni = wave_walk([base] * g, wen, 1)
        i32 = dict(dtype=torch.int32, device=dev)
        cr = torch.full((g,), 5, **i32)
        alive = torch.ones((g, a), dtype=torch.bool, device=dev)
        alive[1, 2] = False
        values = torch.from_numpy(
            rng.integers(-(2**31), 2**31, (k, 1, 1, vc), dtype=np.int32)).to(dev)  # fmt: skip
        before = variants()
        got = ops.persistent_cohort_rounds(stack, lstate, [1], wni, wen, cr, alive, q, values)
        want = batched.cohort_fused_round(*twin, [1], torch.tensor(wni[0], **i32), cr, alive, q,
                                          values.reshape(1, k, vc), [1] * g)  # fmt: skip
        sync(dev)
        variant = variant_since(before)
        err = max_abs_err(
            [*vars(stack).values(), *vars(lstate).values(), got[2].reshape(1, k).to(torch.int32),
             got[3].reshape(1, k), got[4].reshape(1, k, vc)],
            [*vars(twin[0]).values(), *vars(twin[1]).values(), want[2].to(torch.int32),
             want[3], want[4]],
        )  # fmt: skip
        print(f"  K5 z edge: k={k} b=1 n={n} v={vc}: grid z "
              f"{k_wirepath.wave_geometry(vc, 1, 1, k, n, True).grid[2]}, variant={variant} "
              f"max_abs_err={err}")  # fmt: skip
        if err:
            raise AssertionError(f"K5 disagrees with one K-lane round at K={k}")
        if variant != ("vector" if vc % 4 == 0 else "scalar"):
            raise AssertionError(f"K5 took the {variant} variant at K={k}, V={vc}")
        worst = max(worst, err)
    return worst


def check_k5_against_k1(dev, n: int, v: int) -> int:
    """One K5 wave (K1's team body, the rounds spread over the grid) against
    K sequential K1-cohort launches over the same descriptor, as the
    reference's chaos parity test: G=8, B=128, K=8,
    GB=2, every block selected, blocks across 2^31, across the ring end and
    aligned, group 5 frozen from round 3 on (its watermark stops walking),
    a dead acceptor and a wrapped limit.  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 18)
    g, a, q, b, k, gb = 8, 3, 2, 128, 8, 2
    gsel = [0, 1, 2, 3]
    bases = [blk for blk in (2**31 - 512, 3 * n - 300, 640, 9) for _ in range(gb)]
    wen = np.ones((k, g), np.int32)
    wen[3:, 5] = 0
    wni = wave_walk(bases, wen, b)
    crnds = [int(c) for c in rng.integers(1, 7, g)]
    alive = torch.ones((g, a), dtype=torch.bool, device=dev)
    alive[6, 0] = False
    limit = (np.asarray([0] * 7 + [2**31 - 100], np.int32) + n).astype(np.int32)
    stack, lstate = mg_state(rng, g, a, n, v, k * b, bases, crnds, dev)
    seq = clone_slabs(stack, lstate)
    cr = torch.tensor(crnds, dtype=torch.int32, device=dev)
    values = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, g, b, v), dtype=np.int32)).to(dev)
    got = ops.persistent_cohort_rounds(stack, lstate, gsel, wni, wen, cr, alive, q, values, limit,
                                       group_block=gb)  # fmt: skip
    outs = []
    for r in range(k):
        ni = torch.from_numpy(wni[r]).to(dev)
        *_, fresh, win, value = ops.cohort_fused_round(*seq, gsel, ni, cr, alive, q, values[r],
                                                       wen[r], limit, group_block=gb)  # fmt: skip
        outs.append((fresh.to(torch.int32), win, value))
    sync(dev)
    err = max_abs_err(
        [*vars(stack).values(), *vars(lstate).values(), got[2].to(torch.int32), *got[3:]],
        [*vars(seq[0]).values(), *vars(seq[1]).values(), *(torch.stack(x) for x in zip(*outs, strict=True))],
    )  # fmt: skip
    print(f"  K5 one wave (k={k}, gb={gb}, all blocks, group 5 frozen from round 3) against "
          f"{k} K1-cohort launches: max_abs_err={err}")  # fmt: skip
    if err:
        raise AssertionError("K5 disagrees with K sequential K1-cohort launches")
    return err


def packed_cases(n: int, b: int):
    """K6's cases at Gl in {8, 4}: C in {1, 2, 4}, each lane (row, base,
    enabled).  Ragged tables carry pads that name an enabled lane's row and
    row 0; bases are aligned, misaligned, at the ring end (the window wraps
    the ring) and across 2^31 (the int32 wrap of ``ni + lane``)."""
    out = []
    for gl in (8, 4):
        out += [
            dict(gl=gl, name="C=1", lanes=[(gl - 1, 4096, 1)]),
            dict(gl=gl, name="C=2, ring end", lanes=[(1, 3 * n - b // 2, 1), (0, 1003, 1)]),
            dict(gl=gl, name="C=4", lanes=[(3, 640, 1), (0, 2**31 - b // 2, 1), (2, 9, 1),
                                          (1, 5 * n + 13, 1)]),  # fmt: skip
            dict(gl=gl, name="C=4, ragged", lanes=[(2, 2 * n - 7, 1), (2, 0, 0), (1, 128, 1),
                                                   (0, 0, 0)]),  # fmt: skip
            dict(gl=gl, name="C=2, one pad", lanes=[(gl - 2, 77, 1), (gl - 2, 0, 0)]),
        ]
    # the scalar variant: V = 5, and V = 16 on value tensors 4 bytes off 16
    out += [
        dict(gl=8, name="C=4, ragged, V=5", lanes=[(2, 2 * n - 7, 1), (2, 0, 0), (1, 128, 1),
                                                   (5, n - 20, 1)], v=5),  # fmt: skip
        dict(gl=8, name="C=2, burst off 16", lanes=[(4, n - 20, 1), (0, 1003, 1)], off="values"),
        dict(gl=4, name="C=4, st_val off 16", lanes=[(3, 640, 1), (0, 2**31 - b // 2, 1),
                                                    (2, 9, 1), (1, 0, 0)], off="st_val"),  # fmt: skip
        dict(gl=4, name="C=1, lval off 16", lanes=[(1, 5 * n + 13, 1)], off="lval"),
    ]
    return out


def check_k6(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K6 (``ops.packed_shard_round``) against its plain version
    (``batched.packed_multigroup_round``) at A=3, N=65,536, V=16 (and V=5
    and value tensors 4 bytes off 16: the scalar variant), B=128, over
    ``packed_cases``, each at 128 threads a block (``block_b`` 128) and at
    64 (``block_b`` 32): a dead acceptor
    on lane 0, two dead (below quorum) on the last lane, a limit that
    refuses the upper half of lane 1's window, the state in place, pads
    inert (fresh 0, win -1, value 0) and rows no enabled lane names
    untouched.  Then K6 against K1's shard slice on the same cohort.
    Returns the largest difference."""
    rng = np.random.default_rng(SEED + 20)
    a, q, b = 3, 2, 128
    worst = 0

    def t(x, dt=torch.int32):
        return torch.from_numpy(np.asarray(x)).to(dev, dt)

    for case in packed_cases(n, b):
        gl, lanes = case["gl"], case["lanes"]
        vc, off = case.get("v", v), case.get("off")
        c = len(lanes)
        seg, ni, en = (t([lane[i] for lane in lanes]) for i in range(3))
        crnds = [int(x) for x in rng.integers(1, 7, c)]
        alive = np.ones((c, a), np.int32)
        alive[0, 1] = 0  # still a quorum
        if c > 2:
            alive[-1, [0, 2]] = 0  # below quorum: nothing decides
        limit = np.full((c,), 2**31 - 1, np.int64)
        if c > 1:
            limit[1] = lanes[1][1] + b // 2  # refuses the upper half
        bases = [4096] * gl
        for row, base, e in lanes:
            if e:
                bases[row] = base
        stack, lstate = mg_state(rng, gl, a, n, vc, b, bases, [max(crnds)] * gl, dev)
        values = t(rng.integers(-(2**31), 2**31, (c, b, vc), dtype=np.int32))
        cr, al, lim = t(crnds), t(alive), t(limit.astype(np.int32))
        twin = clone_slabs(stack, lstate)
        want = batched.packed_multigroup_round(*twin, seg, ni, cr, al, q, values, en, lim)
        plain = [*vars(want[0]).values(), *vars(want[1]).values(), want[2].to(torch.int32),
                 *want[3:]]  # fmt: skip
        errs, ran = [], []
        for block_b, threads in ((128, 128), (32, 64)):
            mine = held(*clone_slabs(stack, lstate), off)
            ptrs = [x.data_ptr() for x in (*vars(mine[0]).values(), *vars(mine[1]).values())]
            before = variants()
            with lane_threads(threads):
                got = ops.packed_shard_round(*mine, seg, ni, cr, al, q,
                                             off16(values) if off == "values" else values, en,
                                             lim, block_b=block_b)  # fmt: skip
            sync(dev)
            ran.append(variant_since(before))
            state = [*vars(got[0]).values(), *vars(got[1]).values()]
            if [x.data_ptr() for x in state] != ptrs:
                raise AssertionError("K6 did not update the state in place")
            errs.append(max_abs_err([*state, got[2].to(torch.int32), *got[3:]], plain))
            pads = en == 0
            if bool(got[2][pads].any() or (got[3][pads] != -1).any() or got[4][pads].any()):
                raise AssertionError(f"K6: a pad lane of {case} decided or voted")
            untouched = [r for r in range(gl) if r not in {row for row, _, e in lanes if e}]
            for x, y in zip(state, [*vars(stack).values(), *vars(lstate).values()], strict=True):
                if not torch.equal(x[untouched], y[untouched]):
                    raise AssertionError(f"K6 wrote a row no enabled lane names: {case}")
        print(f"  K6 gl={gl} {case['name']} lanes={lanes}: variant={ran[0]} "
              f"max_abs_err={max(errs)} (128 threads, block_b 128: {errs[0]}; 64 threads, "
              f"block_b 32: {errs[1]})")  # fmt: skip
        if max(errs):
            raise AssertionError(f"K6 disagrees with its plain version: {case}")
        if set(ran) != {"vector" if vc % 4 == 0 and off is None else "scalar"}:
            raise AssertionError(f"K6 took the {ran} variants at {case}")
        worst = max(worst, *errs)
    return max(worst, check_k6_against_k1_shard(dev, n, v))


def check_k6_against_k1_shard(dev, n: int, v: int) -> int:
    """One ragged cohort on a 2-shard slab of G=8 (Gl=4): shard 0 packs
    groups 1 and 2, shard 1 group 6 and a pad; K6 on each shard's view
    against K1's shard slice over the same slabs with only the cohort
    enabled, a dead acceptor on group 2.  The port of the reference's
    packed-versus-full-width test.  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 21)
    g, gl, a, q, b = 8, 4, 3, 2, 128
    bases = [4096, 2 * n - 64, 640, 9, 1003, 3 * n, 2**31 - 64, 77]
    stack, lstate = mg_state(rng, g, a, n, v, b, bases, [7] * g, dev)
    full = clone_slabs(stack, lstate)
    gids = [1, 2, 6]
    lanes = {0: [1, 2], 1: [6]}
    cohort = torch.from_numpy(rng.integers(-(2**31), 2**31, (3, b, v), dtype=np.int32)).to(dev)
    alive = torch.ones((g, a), dtype=torch.bool, device=dev)
    alive[2, 0] = False
    i32 = dict(dtype=torch.int32, device=dev)
    ni, cr = torch.tensor(bases, **i32), torch.full((g,), 7, **i32)
    en = torch.zeros((g,), **i32)
    en[gids] = 1
    vals_full = torch.zeros((g, b, v), **i32)
    vals_full[gids] = cohort
    outs_full, outs_packed = [], []
    for s in range(2):
        rows = slice(s * gl, (s + 1) * gl)
        shard = [type(x)(*(y[rows] for y in vars(x).values())) for x in full]
        *_, fresh, win, value = ops.shard_slab_round(s * gl, ni, cr, alive, q, *shard,
                                                     vals_full[rows].contiguous(), en)  # fmt: skip
        want = [gi - s * gl for gi in lanes[s]]
        outs_full.append([x[want] for x in (fresh.to(torch.int32), win, value)])
        shard = [type(x)(*(y[rows] for y in vars(x).values())) for x in (stack, lstate)]
        members = lanes[s]
        seg = torch.tensor([gi - s * gl for gi in members] + [0] * (2 - len(members)), **i32)
        pen = torch.tensor([1] * len(members) + [0] * (2 - len(members)), **i32)
        idx = [gids.index(gi) for gi in members]
        pv = torch.zeros((2, b, v), **i32)
        pv[: len(members)] = cohort[idx]
        pni = torch.tensor([bases[gi] for gi in members] + [0] * (2 - len(members)), **i32)
        pal = torch.ones((2, a), **i32)
        pal[: len(members)] = alive[members].to(torch.int32)
        *_, fresh, win, value = ops.packed_shard_round(*shard, seg, pni, cr[:2], pal, q, pv, pen)
        k = len(members)
        outs_packed.append([x[:k] for x in (fresh.to(torch.int32), win, value)])
    sync(dev)
    err = max_abs_err(
        [*vars(stack).values(), *vars(lstate).values(), *(x for o in outs_packed for x in o)],
        [*vars(full[0]).values(), *vars(full[1]).values(), *(x for o in outs_full for x in o)],
    )  # fmt: skip
    print(f"  K6 ragged 2-shard cohort {gids} against K1's shard slice: max_abs_err={err}")
    if err:
        raise AssertionError("K6 disagrees with K1's shard slice on the same cohort")
    return err


def check_k1_shard(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K1's shard slice (``ops.shard_slab_round``) against its plain version
    (``batched.shard_slab_round``) on the shard views of a G=8 slab at
    offsets 0 and Gl=4, GB in {1, 4}, B=128: windows aligned, across the
    ring end and across 2^31, a frozen group below quorum, a disabled group,
    a dead acceptor, a limit inside a window and one wrapped past int32 max;
    the other shard's rows untouched; then V=5, V=1 and value slabs 4 bytes
    off 16 (the scalar variant).  Returns the largest difference."""
    rng = np.random.default_rng(SEED + 22)
    g, gl, a, q, b = 8, 4, 3, 2, 128
    bases = [4096, 3 * n - b // 2, 2**31 - b // 2, 640, 1003, 9, 5 * n + 13, 4096]
    worst = 0
    # (offset, GB, V, the value slab held 4 bytes off 16): the vector variant,
    # then the scalar one
    for off, gb, vc, mis in ((0, 1, v, None), (0, 4, v, None), (gl, 1, v, None), (gl, 4, v, None),
                             (0, 1, 5, None), (gl, 4, v, "st_val"), (gl, 1, 1, "lval")):  # fmt: skip
        crnds = [int(c) for c in rng.integers(1, 7, g)]
        crnds[off + 1] = -1  # a frozen group
        stack, lstate = mg_state(rng, g, a, n, vc, b, bases, crnds, dev)
        twin = clone_slabs(stack, lstate)
        stack, lstate = held(stack, lstate, mis)
        i32 = dict(dtype=torch.int32, device=dev)
        alive = torch.ones((g, a), dtype=torch.bool, device=dev)
        alive[off, 1] = False
        alive[off + 1, [0, 2]] = False
        en = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], **i32)
        marks = np.zeros(g, np.int32)
        marks[off + 2] = 2**31 - 100  # its limit wraps to a negative number
        limit = marks + n
        limit[off] = np.int32(bases[off] + b // 2)
        lim = torch.from_numpy(limit).to(dev)
        values = torch.from_numpy(
            rng.integers(-(2**31), 2**31, (gl, b, vc), dtype=np.int32)
        ).to(dev)
        ni, cr = torch.tensor(bases, **i32), torch.tensor(crnds, **i32)

        def rows(st, off=off):
            return type(st)(*(x[off : off + gl] for x in vars(st).values()))

        before = variants()
        got = ops.shard_slab_round(off, ni, cr, alive, q, rows(stack), rows(lstate), values,
                                   en, lim, group_block=gb)  # fmt: skip
        want = batched.shard_slab_round(off, ni, cr, alive, q, rows(twin[0]), rows(twin[1]),
                                        values, en, lim)  # fmt: skip
        sync(dev)
        variant = variant_since(before)
        err = max_abs_err(
            [*vars(stack).values(), *vars(lstate).values(), got[2].to(torch.int32), *got[3:]],
            [*vars(twin[0]).values(), *vars(twin[1]).values(), want[2].to(torch.int32),
             *want[3:]],
        )  # fmt: skip
        print(f"  K1-shard offset={off} gb={gb} v={vc} off16={mis}: variant={variant} "
              f"max_abs_err={err}")  # fmt: skip
        if err:
            raise AssertionError(f"K1's shard slice disagrees with its plain version at {off}")
        if variant != ("vector" if vc % 4 == 0 and mis is None else "scalar"):
            raise AssertionError(f"K1's shard slice took the {variant} variant at {off}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------
def payloads(n_total: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_total):
        head = f"{i}:".encode()
        out.append(head + rng.bytes(int(rng.integers(0, 57 - len(head)))))
    return out


def plain_seal(insts: np.ndarray, values: np.ndarray, dev) -> int:
    """A seal recomputed by K4's plain version, on the card."""
    if insts.size == 0:
        return 0
    leaves = (torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev) for x in (insts, values))
    return k_digest.combine(int(k_digest.digest_plain(leaf)) for leaf in leaves)


def check_seals(run: dict, dev) -> int:
    """Every seal of the main path, which K4 computed, against the same
    prefix folded by K4's plain version.  Returns the largest difference."""
    worst = 0
    for seal, (insts, values) in zip(run["seals"], run["prefixes"], strict=True):
        want = plain_seal(insts, values, dev)
        print(f"  seal of {insts.size} instances ({insts.size}+{values.size} words): "
              f"{seal} vs plain {want}")  # fmt: skip
        if seal != want:
            raise AssertionError(f"K4's seal {seal} != its plain version's {want}")
        worst = max(worst, abs(seal - want))
    return worst


def run_main_path(use_kernels: bool, dev, cfg: PaxosConfig | None = None) -> dict:
    """The whole single-group service on the card: ~1.5 N payloads in slices
    of N/4, a snapshot after each slice, a kill and revive, a coordinator
    failover and restore, and an acceptor crash and restore.  The default
    configuration is the paper's deployment: A=3, N=65,536, 64-byte values,
    bursts of 128."""
    cfg = cfg or PaxosConfig()
    n = cfg.n_instances
    net = SimNet(FaultSpec(drop=0.01, dup=0.01, reorder=0.01), seed=SEED)
    ctx = PaxosContext(cfg, net=net, fused=True, use_kernels=use_kernels, snapshots=True, device=dev)
    hw = ctx.hw
    round_s: list[float] = []
    pipeline = hw.pipeline

    def timed_pipeline(values, active):
        t0 = time.perf_counter()
        out = pipeline(values, active)
        round_s.append(time.perf_counter() - t0)
        return out

    hw.pipeline = timed_pipeline
    data = payloads(3 * n // 2, SEED + 2)
    step = n // 4
    seals, prefixes = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lossy = net.faults

    def drain(chunk: list[bytes]) -> None:
        for p in chunk:
            ctx.submit(p)
        ctx.run_until_quiescent()
        if not ctx.quiescent():
            raise AssertionError("a slice did not drain")

    for s, lo in enumerate(range(0, len(data), step)):
        chunk = data[lo : lo + step]
        if s == 1:
            ctx.hw.kill_acceptor(2)
        if s == 2:
            drain(chunk[: step // 2])
            # the software coordinator starts from a high estimate of the
            # watermark, on the burst boundary; the instances it skips are
            # gaps, filled below by recover().  Its window runs lossless so
            # that its bursts are all full: the restore then needs no
            # burn-forward, which the reference applies only under
            # use_kernels, and the kernel and plain runs stay comparable.
            gap = ctx.hw._next_inst_host
            ctx.fail_coordinator(est_next_inst=-(-gap // cfg.batch) * cfg.batch)
            net.faults = FaultSpec()
            drain(chunk[step // 2 :])
            net.faults = lossy
            ctx.restore_hardware_coordinator()
            ctx.recover(gap)
            chunk = []
        if s == 4:
            ctx.crash_acceptor(1)
        drain(chunk)
        if s == 1:
            ctx.hw.revive_acceptor(2)
        seals.append(ctx.snapshot_group().seal)
        prefixes.append(ctx.snapshots.entries())
        if s == 4:
            ctx.restore_acceptor(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    log = ctx.full_group_log()
    insts = [i for i, _ in log]
    if len(set(insts)) != len(insts):
        raise AssertionError("an instance was delivered twice")
    if sorted(p for _, p in log) != sorted(data) or len(log) != len(data):
        raise AssertionError("not every payload was delivered exactly once")
    return dict(
        delivered_log=ctx.delivered_log,
        full_log=log,
        seals=seals,
        prefixes=prefixes,
        state=export_state(hw),
        wall=wall,
        rounds=len(round_s),
        round_s=round_s,
        stats=dict(ctx.stats),
        delivered=len(log),
        ring_laps=hw._next_inst_host / n,
    )


# ---------------------------------------------------------------------------
# staged path and per-role path
# ---------------------------------------------------------------------------
LAUNCHES = {  # kernel name -> (module, attribute) of its wrapper's count
    "wirepath_round": (k_wirepath, "launches"),
    "acceptor_vote_all": (k_wirepath, "vote_all_launches"),
    "coordinator_sequence": (k_coordinator, "launches"),
    "digest": (k_digest, "launches"),
    "acceptor_phase2": (k_acceptor, "launches"),
    "learner_quorum": (k_learner, "launches"),
    "K1-cohort": (k_wirepath, "cohort_launches"),
    "K5": (k_wirepath, "persistent_launches"),
    "K6": (k_wirepath, "packed_launches"),
    "K1-shard": (k_wirepath, "shard_launches"),
    "K9": (k_flash, "launches"),
    "team vector": (k_wirepath, "vector_launches"),  # K1, K5, K6, K2, K7 and K8
    "team scalar": (k_wirepath, "scalar_launches"),
}


def reset_launches() -> None:
    for mod, attr in LAUNCHES.values():
        setattr(mod, attr, 0)


def read_launches() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in LAUNCHES.items()}


class PlainCalls:
    """Counts the calls of a plain-engine function of ``batched`` while it is
    entered: ``_phase2`` (a Phase-2 vote) or ``_rows_round`` (a multi-group
    round).  Under ``use_kernels`` on the card there must be none."""

    def __init__(self, name: str = "_phase2"):
        self.calls = 0
        self._name = name
        self._orig = getattr(batched, name)

    def __enter__(self):
        def counted(*args):
            self.calls += 1
            return self._orig(*args)

        setattr(batched, self._name, counted)
        return self

    def __exit__(self, *exc):
        setattr(batched, self._name, self._orig)


class SealCalls:
    """Counts the seals made while entered: ``ops.tree_digest`` calls, each
    of which must be one K4 launch on the card."""

    def __init__(self):
        self.calls = 0
        self._orig = ops.tree_digest

    def __enter__(self):
        def counted(leaves):
            self.calls += 1
            return self._orig(leaves)

        ops.tree_digest = counted
        return self

    def __exit__(self, *exc):
        ops.tree_digest = self._orig


def require_seals(path: str, launches: dict[str, int], seals: SealCalls) -> None:
    """Each seal of a path was one K4 launch."""
    if not seals.calls or launches["digest"] != seals.calls:
        raise AssertionError(f"the {path} made {seals.calls} seals in {launches['digest']} K4 "
                             f"launches")  # fmt: skip


def run_staged_path(use_kernels: bool, dev, cfg: PaxosConfig | None = None) -> dict:
    """The paper's deployment as its users construct it, on the card:
    ``PaxosContext(PaxosConfig(), n_learners=2)`` with the default
    ``fused=False`` (the staged path: the coordinator sequences, the
    acceptor array votes, the votes travel over the lossy ``SimNet`` to two
    software learners).  About 1.5 N payloads in slices of N/4, so the ring
    wraps; an acceptor kill and revive; a failover whose estimate skips one
    burst of instances, traffic on the software coordinator, the restore,
    and a ``recover()`` of a skipped instance.  A round is the host time of
    ``sequence()`` + ``vote()`` + the fan-out of the votes to the learners."""
    cfg = cfg or PaxosConfig()
    n, b = cfg.n_instances, cfg.batch
    net = SimNet(FaultSpec(drop=0.01, dup=0.01, reorder=0.01), seed=SEED + 8)
    ctx = PaxosContext(cfg, net=net, n_learners=2, use_kernels=use_kernels, device=dev)
    if ctx.fused:
        raise AssertionError("the staged path must be the default")
    hw = ctx.hw
    calls = {"sequence": 0, "vote": 0}
    round_s: list[float] = []
    mark = {"start": None, "last": None}

    def close_round():
        if mark["start"] is not None and mark["last"] is not None:
            round_s.append(mark["last"] - mark["start"])
        mark["start"] = mark["last"] = None

    sequence, vote, send, recv_all = hw.sequence, hw.vote, net.send, net.recv_all

    def timed_sequence(values, active):
        close_round()
        calls["sequence"] += 1
        mark["start"] = time.perf_counter()
        return sequence(values, active)

    def counted_vote(p2a):
        calls["vote"] += 1
        return vote(p2a)

    def timed_send(dst, msg):
        send(dst, msg)
        if msg[0] == "votes" and mark["start"] is not None:
            mark["last"] = time.perf_counter()

    def timed_recv_all(dst):
        close_round()
        return recv_all(dst)

    hw.sequence, hw.vote, net.send, net.recv_all = (
        timed_sequence, counted_vote, timed_send, timed_recv_all)  # fmt: skip
    data = payloads(3 * n // 2, SEED + 9)
    step = n // 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def drain(chunk: list[bytes]) -> None:
        for p in chunk:
            ctx.submit(p)
        ctx.run_until_quiescent()
        if not ctx.quiescent():
            raise AssertionError("a slice did not drain")

    with PlainCalls() as plain_votes:
        for s, lo in enumerate(range(0, len(data), step)):
            chunk = data[lo : lo + step]
            if s == 1:
                hw.kill_acceptor(2)
            if s == 3:
                drain(chunk[: step // 2])
                gap = hw._next_inst_host
                # a burst-aligned estimate: the software coordinator's bursts
                # are full, so the restore burns nothing forward on either engine
                ctx.fail_coordinator(est_next_inst=gap + b)
                drain(chunk[step // 2 :])
                ctx.restore_hardware_coordinator()
                ctx.recover(gap + 5)
                chunk = []
            drain(chunk)
            if s == 1:
                hw.revive_acceptor(2)
        close_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    log = ctx.delivered_log
    insts = [i for i, _ in log]
    if len(set(insts)) != len(insts):
        raise AssertionError("an instance was delivered twice")
    if sorted(p for _, p in log) != sorted(data):
        raise AssertionError("not every payload was delivered exactly once")
    if hw._next_inst_host <= n:
        raise AssertionError("the staged path's ring did not wrap")
    return dict(
        delivered_log=log,
        learned=ctx.learned,
        state=export_state(hw),
        wall=wall,
        round_s=round_s,
        calls=calls,
        plain_votes=plain_votes.calls,
        stats=dict(ctx.stats),
        delivered=len(log),
        ring_laps=hw._next_inst_host / n,
    )


def run_per_role_path(dev) -> dict:
    """The paper's per-role components (Table 1) for one ring walk of bursts
    at ``PaxosConfig()``: ``ops.coordinator_sequence`` sequences each burst
    (K3), each of the A acceptors votes alone on its own register file with
    ``ops.acceptor_phase2`` (K7), and ``ops.learner_quorum`` takes the
    stacked votes (K8).  Held against the same bursts through
    ``ops.acceptor_phase2_all`` (K2) on a stacked twin and against K8's
    plain version: equal registers, votes and decisions.  Differences are
    accumulated on the card and read once."""
    cfg = PaxosConfig()
    a, n, v, b, q = cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, cfg.quorum
    rng = np.random.default_rng(SEED + 10)
    files = [AcceptorState.init(n, v, dev) for _ in range(a)]
    stack = AcceptorState.init(n, v, dev, n_acceptors=a)
    alive = torch.ones(a, dtype=torch.bool, device=dev)
    cstate = CoordinatorState.init(crnd=3, next_inst=n // 2, device=dev)  # wraps mid-walk
    walk = n // b
    bursts = torch.from_numpy(rng.integers(-(2**31), 2**31, (walk, b, v), dtype=np.int32)).to(dev)
    actives = torch.from_numpy(rng.random((walk, b)) < 0.9).to(dev)
    err = torch.zeros((), dtype=torch.int64, device=dev)
    delivered = torch.zeros((), dtype=torch.int64, device=dev)

    def diff(xs, ys):  # on the card: nothing is read until the walk ends
        pairs = zip(xs, ys, strict=True)
        return torch.stack([(x.long() - y.long()).abs().max() for x, y in pairs]).max()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(walk):
        cstate, p2a = ops.coordinator_sequence(cstate, bursts[k], actives[k])
        per = [ops.acceptor_phase2(files[i], p2a, i)[1] for i in range(a)]
        votes = MsgBatch(*(torch.stack([getattr(p, f) for p in per]) for f in MsgBatch.FIELDS))
        got = ops.learner_quorum(votes.msgtype, votes.inst, votes.vrnd, votes.value, q)
        _, staged = ops.acceptor_phase2_all(stack, p2a, alive)
        plain = k_learner.learner_quorum_plain(q, votes.msgtype, votes.vrnd, votes.value)
        err = torch.maximum(err, diff(votes.tensors(), staged.tensors()))
        err = torch.maximum(err, diff((got[0].to(torch.int32), got[2], got[3]), plain))
        err = torch.maximum(err, diff((got[1],), (p2a.inst,)))
        delivered += got[0].sum()
    for i in range(a):
        rows = [x[i] for x in vars(stack).values()]
        err = torch.maximum(err, diff(vars(files[i]).values(), rows))
    worst, n_delivered = int(err), int(delivered)
    wall = time.perf_counter() - t0
    print(f"  per-role path: {walk} bursts of {b}, {n_delivered} lanes decided, "
          f"max_abs_err against K2 and K8's plain version {worst}, {wall:.3f} s")  # fmt: skip
    if worst:
        raise AssertionError("the per-role path disagrees with the staged vote or plain K8")
    if n_delivered != walk * b:
        raise AssertionError("the per-role path did not decide every lane")
    return dict(max_abs_err=worst, bursts=walk, wall=wall)


# ---------------------------------------------------------------------------
# fabric consensus: one rank an acceptor, over torch.distributed
# ---------------------------------------------------------------------------
FABRIC_ROUNDS = 512  # at B = 384 the three-rank run laps the 65,536-slot ring three times
FABRIC_RANKS = 3  # the paper's acceptors, three processes on the one card over gloo


def fabric_schedule(n_acc: int, b_local: int, v: int, seed: int) -> dict[str, np.ndarray]:
    """``FABRIC_ROUNDS`` rounds of proposals from every rank: seeded values,
    90% of them active; the last acceptor dead for rounds 100-199 (with
    three, a quorum still decides), all but acceptor 0 dead for rounds
    200-209 (no decision), then all alive."""
    rng = np.random.default_rng(seed)
    b = b_local * n_acc
    alive = np.ones((FABRIC_ROUNDS, n_acc), bool)
    alive[100:200, -1] = False
    alive[200:210, 1:] = False
    return dict(
        values=rng.integers(-(2**31), 2**31, (FABRIC_ROUNDS, b, v)).astype(np.int32),
        active=rng.random((FABRIC_ROUNDS, b)) < 0.9,
        alive=alive,
    )


def fabric_rounds(mesh, sched: dict[str, np.ndarray], n: int) -> dict:
    """Drive ``make_fabric_consensus`` over ``mesh``'s ``acc`` axis through
    the schedule, each rank proposing its own rows of every round (uploaded
    once, in bulk).  Returns every round's ``decided``, ``inst`` and
    ``value``, this rank's final registers (a list of its one shard, whose
    leading dim is 1) and the watermark, on the host, and each round's host time (the card
    synchronised around it).  The registers are read shard by shard, never
    by ``full_tensor``: DTensor's functional all-gather over gloo on CUDA
    tensors dies of a segmentation fault in torch 2.11."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core.fabric import make_fabric_consensus

    dev = torch.device(mesh.device_type)
    me, n_acc = mesh.get_local_rank("acc"), mesh.size(0)
    rounds, b, v = sched["values"].shape
    bl = b // n_acc
    init_fn, step = make_fabric_consensus(mesh, axis="acc", n_instances=n, value_words=v)
    astate, cstate = init_fn()
    rows = slice(me * bl, (me + 1) * bl)
    values = torch.from_numpy(sched["values"][:, rows].copy()).to(dev)
    active = torch.from_numpy(sched["active"][:, rows].copy()).to(dev)
    alive = torch.from_numpy(sched["alive"][:, me : me + 1].copy()).to(dev)
    outs, round_s = [], []

    def local(x):
        return DTensor.from_local(x, mesh, (Shard(0),), run_check=False)

    for r in range(rounds):
        sync(dev)
        t = time.perf_counter()
        astate, cstate, *out = step(astate, cstate, local(values[r]), local(active[r]),
                                    local(alive[r]))  # fmt: skip
        sync(dev)
        round_s.append(time.perf_counter() - t)
        outs.append([x.to_local() for x in out])
    decided, inst, value = (torch.stack(x).cpu().numpy() for x in zip(*outs, strict=True))
    regs = [{k: x.to_local().cpu().numpy() for k, x in vars(astate).items()}]
    return dict(decided=decided, inst=inst, value=value, registers=regs,
                next_inst=int(cstate.next_inst.to_local()), round_s=round_s)  # fmt: skip


def fabric_breakdown(mesh, n: int, v: int, b: int, reps: int = 200) -> dict[str, float]:
    """Where a world-of-one round's host time goes, p50 ms over ``reps``
    calls each, the card synchronised around every call: ``step_fn`` on
    DTensors, ``consensus_round`` on the local tensors, K3 and K7 alone, and
    the round's three collectives alone.  Run after the phase's launches are
    read, on a register file of its own."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import fabric

    dev = torch.device(mesh.device_type)
    init_fn, step = fabric.make_fabric_consensus(mesh, axis="acc", n_instances=n, value_words=v)
    astate, cstate = init_fn()
    vals = torch.ones((b, v), dtype=torch.int32, device=dev)
    act = torch.ones(b, dtype=torch.bool, device=dev)
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    dv, da, dl = (DTensor.from_local(x, mesh, (Shard(0),), run_check=False)
                  for x in (vals, act, alive))  # fmt: skip
    loc, lc = AcceptorState.init(n, v, dev), CoordinatorState.init(device=dev)
    group = mesh.get_group("acc")
    count = torch.ones(b, dtype=torch.int32, device=dev)
    parts = {
        "step_fn": lambda: step(astate, cstate, dv, da, dl),
        "consensus_round": lambda: fabric.consensus_round(loc, lc, vals, act, alive[0],
                                                          axis="acc", quorum=1, mesh=mesh),
        "K3 + K7": lambda: ops.acceptor_phase2(loc, ops.coordinator_sequence(lc, vals, act)[1], 0),
        "collectives": lambda: (fabric._gather(vals, group), fabric._gather(act, group),
                                dist.all_reduce(count, group=group)),
    }  # fmt: skip
    out = {}
    for name, fn in parts.items():
        for _ in range(20):
            fn()
        times = []
        for _ in range(reps):
            sync(dev)
            t = time.perf_counter()
            fn()
            sync(dev)
            times.append(time.perf_counter() - t)
        out[name] = percentiles(times)[0]
    return out


def fabric_replay(sched: dict[str, np.ndarray], n: int) -> dict:
    """The same rounds on one process with no collective: the plain
    ``batched`` sequencer on the whole burst, then each acceptor's plain
    vote on its own register file in turn (a dead one's too), its agree
    bits counted where it is alive."""
    rounds, b, v = sched["values"].shape
    n_acc = sched["alive"].shape[1]
    q = n_acc // 2 + 1
    files = [AcceptorState.init(n, v, "cpu") for _ in range(n_acc)]
    cstate = CoordinatorState.init()
    decided, inst = [], []
    for r in range(rounds):
        vals, act = torch.from_numpy(sched["values"][r]), torch.from_numpy(sched["active"][r])
        cstate, p2a = batched.coordinator_sequence(cstate, vals, act)
        count = torch.zeros(b, dtype=torch.int32)
        for a in range(n_acc):
            _, votes = batched.acceptor_phase2(files[a], p2a, a)
            if sched["alive"][r, a]:
                count += (votes.msgtype == MSG_P2B).to(torch.int32)
        decided.append((count >= q).numpy())
        inst.append(p2a.inst.numpy())
    regs = [{k: x[None].numpy() for k, x in vars(f).items()} for f in files]
    return dict(decided=np.stack(decided), inst=np.stack(inst), value=sched["values"],
                registers=regs, next_inst=int(cstate.next_inst))


def same_fabric(what: str, got: dict, want: dict) -> None:
    """Every round's outputs, the final registers and watermark equal; a
    run's registers are its acceptors' shards, in rank order."""
    for key in ("decided", "inst", "value"):
        if got[key].shape != want[key].shape or not np.array_equal(got[key], want[key]):
            bad = np.nonzero((got[key] != want[key]).reshape(len(want[key]), -1).any(1))[0]
            raise AssertionError(f"the fabric's {key} differs from {what} in rounds {bad[:8]}")
    for key in want["registers"][0]:
        regs = [np.concatenate([x[key] for x in run_["registers"]]) for run_ in (got, want)]
        if not np.array_equal(*regs):
            raise AssertionError(f"the fabric's final {key} registers differ from {what}")
    if got["next_inst"] != want["next_inst"]:
        raise AssertionError(f"the fabric's watermark {got['next_inst']} is not {what}'s")


def fabric_rank(rank: int, world: int, out: str) -> None:
    """One rank of the three-rank run (``--fabric-ranks``): a process on the
    one card, joined to the others over gloo; the schedule on a ``cuda``
    mesh (K3 and K7, the collectives over gloo on CUDA tensors), then on a
    ``cpu`` mesh (the plain route).  Writes its results and launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    torch.set_num_threads(1)  # three ranks and their parent share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                            rank=rank, world_size=world)  # fmt: skip
    try:
        cfg = PaxosConfig()
        sched = fabric_schedule(world, cfg.batch, cfg.value_words, SEED + 35)
        res = {}
        for kind in ("cuda", "cpu"):
            mesh = init_device_mesh(kind, (world,), mesh_dim_names=("acc",))
            reset_launches()
            res[kind] = fabric_rounds(mesh, sched, cfg.n_instances)
            res[kind]["launches"] = read_launches()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def fabric_ranks(out: str) -> None:
    """Start ``FABRIC_RANKS`` ranks on the one card and wait for them all."""
    import torch.multiprocessing as mp

    mp.spawn(fabric_rank, args=(FABRIC_RANKS, out), nprocs=FABRIC_RANKS)


def fabric_launches(what: str, launches: dict[str, int], rounds: int) -> None:
    """One K3 and one K7 launch a round, K7 in its vector variant."""
    want = {"coordinator_sequence": rounds, "acceptor_phase2": rounds}
    require_launched(what, launches, list(want))
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"the {what}'s launches are not {want}: {launches}")
    require_variant(what, launches, ["acceptor_phase2"])


def fabric_decisions(what: str, run_: dict, sched: dict[str, np.ndarray]) -> None:
    """A round decides every proposal where a quorum is alive, none where
    not: the schedule's faults show."""
    n_acc = sched["alive"].shape[1]
    quorate = sched["alive"].sum(1) >= n_acc // 2 + 1
    if not (run_["decided"].all(1) == quorate).all() or run_["decided"][~quorate].any():
        raise AssertionError(f"the {what} did not decide exactly the quorate rounds")


def run_fabric(dev) -> dict:
    """``core.fabric.make_fabric_consensus`` at the paper's deployment (N =
    65,536, V = 16, 128 proposals a rank): a world of one on NCCL in this
    process on a (1,) mesh, then ``FABRIC_RANKS`` ranks on the one card
    over gloo in a subprocess, each against the plain replay (and the
    ranks also against their own run on the CPU), bit for bit in every
    round and in the final registers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import ensure_process_group

    t0 = time.perf_counter()
    cfg = PaxosConfig()
    n = cfg.n_instances
    one = fabric_schedule(1, cfg.batch, cfg.value_words, SEED + 34)
    owned = not dist.is_initialized()
    ensure_process_group(dev)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("acc",))
        reset_launches()
        solo = fabric_rounds(mesh, one, n)
        solo_launches = read_launches()
        parts = fabric_breakdown(mesh, n, cfg.value_words, cfg.batch)
        reset_launches()
    finally:
        if owned:
            dist.destroy_process_group()
    fabric_launches("fabric, world of one", solo_launches, FABRIC_ROUNDS)
    same_fabric("the plain replay", solo, fabric_replay(one, n))
    fabric_decisions("fabric, world of one", solo, one)
    solo_s = time.perf_counter() - t0
    p50, p99 = percentiles(solo["round_s"])
    print(f"  world of one on NCCL, (1,) mesh: {FABRIC_ROUNDS} rounds of {cfg.batch}, "
          f"{int(solo['decided'].sum())} decided, equal to the plain replay; launches "
          f"{solo_launches}; round ms p50 {p50}, p99 {p99}; {solo_s:.3f} s")  # fmt: skip
    print(f"  world of one, a round's parts, p50 ms: {parts}")

    t1 = time.perf_counter()
    sched = fabric_schedule(FABRIC_RANKS, cfg.batch, cfg.value_words, SEED + 35)
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--fabric-ranks", d],
                             cwd=root, capture_output=True, text=True, timeout=600)  # fmt: skip
        if out.returncode:
            raise AssertionError(f"the fabric's ranks failed (exit {out.returncode}): "
                                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")  # fmt: skip
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(FABRIC_RANKS)]  # fmt: skip
    replay = fabric_replay(sched, n)
    shards = {kind: [res[kind]["registers"][0] for res in ranks] for kind in ("cuda", "cpu")}
    for r, res in enumerate(ranks):
        fabric_launches(f"fabric, rank {r} on the card", res["cuda"]["launches"], FABRIC_ROUNDS)
        if any(res["cpu"]["launches"].values()):
            raise AssertionError(f"the fabric's CPU run launched kernels: {res['cpu']['launches']}")
        card, cpu = (dict(res[kind], registers=shards[kind]) for kind in ("cuda", "cpu"))
        same_fabric(f"rank {r}'s CPU run", card, cpu)
        same_fabric("the plain replay", card, replay)
    fabric_decisions(f"fabric on {FABRIC_RANKS} ranks", ranks[0]["cuda"], sched)
    ranks_s = time.perf_counter() - t1
    card = percentiles([x for res in ranks for x in res["cuda"]["round_s"]])
    cpu = percentiles([x for res in ranks for x in res["cpu"]["round_s"]])
    laps = FABRIC_ROUNDS * cfg.batch * FABRIC_RANKS / n
    launches = {k: sum(res["cuda"]["launches"][k] for res in ranks) for k in LAUNCHES}
    decided = int(ranks[0]["cuda"]["decided"].sum())
    print(f"  {FABRIC_RANKS} ranks on the one card over gloo: {FABRIC_ROUNDS} rounds of "
          f"{cfg.batch * FABRIC_RANKS} ({laps:.3f} ring laps), {decided} decided, every rank "
          f"equal to its CPU run and to the plain replay; launches {launches}; round ms p50 "
          f"{card[0]}, p99 {card[1]} (CPU run: p50 {cpu[0]}, p99 {cpu[1]}); {ranks_s:.3f} s; "
          f"the phase {time.perf_counter() - t0:.3f} s")  # fmt: skip
    return dict(
        launches={k: solo_launches[k] + launches[k] for k in LAUNCHES},
        solo=dict(rounds=FABRIC_ROUNDS, burst=cfg.batch, round_ms_p50=p50, round_ms_p99=p99,
                  decided=int(solo["decided"].sum()), wall_s=solo_s,
                  parts_ms_p50=parts),
        ranks=dict(ranks=FABRIC_RANKS, rounds=FABRIC_ROUNDS, burst=cfg.batch * FABRIC_RANKS,
                   ring_laps=laps, round_ms_p50=card[0], round_ms_p99=card[1],
                   cpu_round_ms_p50=cpu[0], cpu_round_ms_p99=cpu[1], decided=decided,
                   wall_s=ranks_s),
    )  # fmt: skip


# ---------------------------------------------------------------------------
# multi-group path
# ---------------------------------------------------------------------------
def multigroup_config() -> PaxosConfig:
    """The multi-group service at the paper's widths: 8 groups of A=3,
    N=65,536, 64-byte values, bursts of 128; no persistent waves
    (``persistent_rounds=1``), realignment after 4 fragmented rounds."""
    return PaxosConfig(n_groups=8, persistent_rounds=1, realign_after=4)


def default_multigroup_config() -> PaxosConfig:
    """The same service at the reference's defaults: persistent waves of up
    to 8 rounds (``persistent_rounds=8``) and the async pump."""
    return PaxosConfig(n_groups=8, realign_after=4)


def group_mesh(dev) -> GroupMesh:
    """The groups mesh of the sharded phases: one shard per card where the
    machine has several and they split the 8 groups of
    ``default_multigroup_config``, else two logical shards of ``dev``, each
    slab an allocation of its own."""
    cards = torch.cuda.device_count()
    if cards > 1 and default_multigroup_config().n_groups % cards == 0:
        return make_group_mesh()
    return make_group_mesh(2, dev)


def mesh_line(mesh: GroupMesh) -> str:
    return (f"groups mesh: {mesh.n_shards} shards on {[str(d) for d in mesh.devices]}, "
            f"torch.cuda.device_count() {torch.cuda.device_count()}")  # fmt: skip


def check_slabs(hw, mesh: GroupMesh) -> None:
    """Every shard's slab tensors lie on its device of ``mesh``, and no two
    slab tensors share an allocation."""
    ptrs = set()
    for s_, (st, ls) in enumerate(zip(hw.stacks, hw.lstates, strict=True)):
        want = mesh.devices[s_]
        for x in (*vars(st).values(), *vars(ls).values()):
            if x.device.type != want.type or want.index not in (None, x.device.index):
                raise AssertionError(f"shard {s_}'s slab is on {x.device}, not {want}")
            ptrs.add(x.untyped_storage().data_ptr())
    if len(ptrs) != 6 * mesh.n_shards:
        raise AssertionError("two shards' slab tensors share an allocation")


def sharded_dispatch_parts(dev, mesh: GroupMesh, reps: int = 150) -> dict:
    """Where a sharded dispatch's host time goes, p50 ms over ``reps``
    dispatches of each kind (after 20 unmeasured), on a service of its own
    at the defaults' widths over ``mesh``: a full-width ``pipeline`` (K1's
    shard slice on every shard) and a ``pipeline_cohort`` of three groups
    (K6 on every shard).  The card is synchronised before each dispatch, not
    inside it.  ``uploads`` times ``fabric._upload``, ``launches`` the
    kernels' wrappers, ``read_back`` ``fabric._read_back`` (which waits for
    the shards' kernels), ``host`` the rest of ``total``.  Run after the
    phase's launches are read."""
    from repro_torch.core import ShardedMultiGroupDataplane, fabric

    cfg = default_multigroup_config()
    g, b, v = cfg.n_groups, cfg.batch, cfg.value_words
    hw = ShardedMultiGroupDataplane(cfg, mesh=mesh, use_kernels=True)
    rng = np.random.default_rng(SEED + 41)
    vals = rng.integers(-(2**31), 2**31 - 1, (g, b, v), dtype=np.int32)
    act = np.ones((g, b), bool)
    gids = [0, 3, g - 2]
    kinds = {
        "full_width": lambda: hw.pipeline(vals, act),
        "cohort_of_3": lambda: hw.pipeline_cohort(gids, vals[: len(gids)], act[: len(gids)]),
    }
    spent: dict[str, float] = {}

    def timer(name: str, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t

        return call

    patches = [
        (fabric, "_upload", "uploads"),
        (fabric, "_read_back", "read_back"),
        (ops, "shard_slab_round", "launches"),
        (ops, "packed_shard_round", "launches"),
    ]
    saved = [getattr(mod, attr) for mod, attr, _ in patches]
    out = {}
    try:
        for mod, attr, name in patches:
            setattr(mod, attr, timer(name, getattr(mod, attr)))
        for kind, fn in kinds.items():
            rows: dict[str, list[float]] = {}
            for i in range(20 + reps):
                spent.clear()
                for d in mesh.devices:
                    sync(d)
                t = time.perf_counter()
                fn()
                total = time.perf_counter() - t
                if i < 20:
                    continue
                parts = {k: spent.get(k, 0.0) for k in ("uploads", "launches", "read_back")}
                parts["host"] = total - sum(parts.values())
                for k, x in (("total", total), *parts.items()):
                    rows.setdefault(k, []).append(x)
            out[kind] = {k: percentiles(x)[0] for k, x in rows.items()}
    finally:
        for (mod, attr, _), fn in zip(patches, saved, strict=True):
            setattr(mod, attr, fn)
    return out


def run_multigroup_path(
    use_kernels: bool,
    dev,
    cfg: PaxosConfig | None = None,
    mesh: GroupMesh | None = None,
    deep: bool | None = None,
) -> dict:
    """The multi-group service on the card under a seeded lossy ``SimNet``:
    a uniform phase of N/4 payloads to each group (so the full-width fold
    engages); a skewed phase of 1.25 N more to group 0 (its ring wraps, a
    snapshot of it every N/4) while the other groups trickle small bursts
    (cohorts of fold width 1 or 2 form; with persistent waves on, group 0
    gets 2 to 12 batches per pump, so its waves take several depths), each
    slice of N/4 started with the
    trickling groups burned forward to group 0's watermark and ended with a
    snapshot of every group; then an acceptor kill and revive in
    group 1, a coordinator failover of group 2 with the others under load
    and its restore, a crash and restore of an acceptor in group 4,
    ``retire_group(7)`` + ``create_group()``, and ``retire_group(6)`` +
    ``adopt_group`` of group 3's snapshot; last, traffic to every group and
    a snapshot of each.  A dispatch's latency is the host time of
    ``pipeline_cohort`` or ``pipeline_persistent`` plus that of its
    read-back; ``depths`` counts dispatches by wave depth (1: a single
    round), ``order`` lists the ``deliver`` callbacks in order.

    ``deep`` (default: whether ``cfg`` has persistent waves) gives group 0
    its 2 to 12 batches per pump in the skewed phase; otherwise 8.

    ``mesh`` (a ``GroupMesh`` of S shards) runs the groups-sharded service
    instead, each shard's slab on its device, and ends the schedule with a
    live migration: ``retire_group`` of a group on the last shard,
    ``migrate_group(0, S - 1)``, then traffic to every live group and a
    snapshot of each (``before_move`` holds the group logs, dispatch count
    and planner report before it).  A sharded context plans no persistent
    waves, as the reference's does."""
    cfg = cfg or multigroup_config()
    deep = cfg.persistent_rounds > 1 if deep is None else deep
    g, n, b = cfg.n_groups, cfg.n_instances, cfg.batch
    net = SimNet(FaultSpec(drop=0.01, dup=0.01, reorder=0.01), seed=SEED + 13)
    order: list[tuple[int, bytes]] = []
    shards = mesh.n_shards if mesh is not None else 0
    ctx = PaxosContext(cfg, net=net, use_kernels=use_kernels, snapshots=True, device=dev,
                       mesh=mesh,
                       deliver=lambda payload, _size, inst: order.append((inst, payload)))
    hw = ctx.hw
    dispatch_s: list[float] = []
    folds: dict[int, int] = {}
    depths: dict[int, int] = {}

    def timed(dispatch, wave: bool):
        def call(gids, values, active, defer=False):
            t0 = time.perf_counter()
            handle = dispatch(gids, values, active, defer=True)
            spent = time.perf_counter() - t0
            folds[hw.last_gb] = folds.get(hw.last_gb, 0) + 1
            k = values.shape[0] if wave else 1
            depths[k] = depths.get(k, 0) + 1
            resolve = handle.resolve

            def timed_resolve():
                t1 = time.perf_counter()
                out = resolve()
                dispatch_s.append(spent + time.perf_counter() - t1)
                return out

            handle.resolve = timed_resolve
            return handle if defer else handle.resolve()

        return call

    hw.pipeline_cohort = timed(hw.pipeline_cohort, False)
    hw.pipeline_persistent = timed(hw.pipeline_persistent, True)
    rng = np.random.default_rng(SEED + 14)
    count = [0]
    sent: list[list[bytes]] = [[] for _ in range(g)]  # the current tenant's
    retired: list[tuple[int, list]] = []
    seals, prefixes = [], []
    lossy = net.faults

    def submit(gid: int, k: int) -> None:
        for _ in range(k):
            head = f"{gid}:{count[0]}:".encode()
            count[0] += 1
            p = head + rng.bytes(int(rng.integers(0, cfg.max_payload_bytes + 1 - len(head))))
            sent[gid].append(p)
            ctx.submit(p, group=gid)

    def drain() -> None:
        ctx.run_until_quiescent()
        if not ctx.quiescent():
            raise AssertionError("a slice did not drain")

    def snap(gid: int) -> None:
        seals.append(ctx.snapshot_group(gid).seal)
        prefixes.append(ctx.snapshots.entries(gid))

    sync(dev)
    t0 = time.perf_counter()
    quarter, slice_ = n // 4, 8 * b
    for lo in range(0, quarter, slice_):  # uniform
        for gid in range(g):
            submit(gid, min(slice_, quarter - lo))
        drain()
    for gid in range(g):
        snap(gid)
    for _ in range(5):  # skewed: 1.25 N to group 0, the others trickle
        # the realignment sweep burns a trickling group forward to the
        # leader's watermark in one jump; a group that lagged group 0 by N
        # would then pass its reclaim boundary.  So each slice starts with
        # the trickling groups at group 0's block-aligned watermark
        top = -(-hw.next_inst_host[0] // b) * b
        for gid in range(1, g):
            hw.burn_forward(gid, max(top, hw.next_inst_host[gid]))
        sent0 = 0
        while sent0 < quarter:
            k0 = int(rng.integers(2 * b, 12 * b + 1)) if deep else slice_
            k0 = min(k0, quarter - sent0)
            submit(0, k0)
            sent0 += k0
            for gid in range(1, g):
                submit(gid, int(rng.integers(0, 12)))
            drain()
        for gid in range(g):  # group 0's ring wraps
            snap(gid)
    hw.kill_acceptor(1, 0)
    for gid in range(g):
        submit(gid, 100)
    drain()
    hw.revive_acceptor(1, 0)
    # failover of group 2 from a burst-aligned estimate of its watermark
    # (the instances it skips are gaps, one filled by recover() below); the
    # window runs lossless so the software coordinator's bursts are full and
    # the restore burns nothing forward, which the reference does only under
    # use_kernels: the kernel and plain runs stay comparable
    gap = hw.next_inst_host[2]
    ctx.fail_coordinator(est_next_inst=-(-gap // b) * b, group=2)
    net.faults = FaultSpec()
    for _ in range(2):
        submit(2, b)
        for gid in (0, 1, 3, 4, 5, 6, 7):
            submit(gid, 40)
        drain()
    net.faults = lossy
    ctx.restore_hardware_coordinator(group=2)
    ctx.recover(gap, group=2)
    drain()
    ctx.crash_acceptor(1, group=4)
    for gid in range(g):
        submit(gid, 60)
    drain()
    snap(4)
    ctx.restore_acceptor(1, group=4)
    retired.append((7, ctx.retire_group(7)))
    if ctx.create_group() != 7:
        raise AssertionError("create_group did not reuse the lowest free slot")
    # the new tenant starts at 0: move it to the service's block-aligned
    # watermark and drain it (an empty snapshot), for the same reason as
    # the burns of the skewed phase
    hw.burn_forward(7, -(-max(hw.next_inst_host) // b) * b)
    snap(7)
    retired.append((6, ctx.retire_group(6)))
    # an aligned snapshot watermark: adopt_group realigns only under use_kernels
    hw.burn_forward(3, -(-hw.next_inst_host[3] // b) * b)
    snap(3)
    prefix = ctx.full_group_log(3)
    if ctx.adopt_group(ctx.snapshots.snapshot(3), prefix) != 6:
        raise AssertionError("adopt_group did not reuse the lowest free slot")
    for tenant, log in retired:
        if sorted(p for _, p in log) != sorted(sent[tenant]):
            raise AssertionError(f"retired group {tenant} did not deliver each payload once")
        sent[tenant] = []
    for gid in range(g):
        submit(gid, 200)
    drain()
    for gid in range(g):
        snap(gid)
    before_move = dict(
        logs=[list(ctx.full_group_log(gid)) for gid in range(g)],
        dispatch_count=hw.dispatch_count,
        report=ctx.planner.report(),
    )
    if shards:
        check_slabs(hw, mesh)
        # live migration: vacate a slot on the last shard, move group 0
        # there while the service runs, and serve on
        gone = next(h for h in (g - 3, g - 1) if hw.shard_of_group(h) == shards - 1)
        retired.append((gone, ctx.retire_group(gone)))
        if sorted(p for _, p in retired[-1][1]) != sorted(sent[gone]):
            raise AssertionError(f"retired group {gone} did not deliver each payload once")
        sent[gone] = []
        # an aligned drain watermark: the move re-seats the sequencer there,
        # realigned only under use_kernels (as adopt_group above)
        hw.burn_forward(0, -(-hw.next_inst_host[0] // b) * b)
        seals.append(ctx.migrate_group(0, shards - 1).seal)
        prefixes.append(ctx.snapshots.entries(0))
        if hw.shard_of_group(0) != shards - 1:
            raise AssertionError(f"group 0 did not move: {hw.group_placement()}")
        for gid in ctx.live_groups():
            submit(gid, 300)
        drain()
        for gid in ctx.live_groups():
            snap(gid)
    sync(dev)
    wall = time.perf_counter() - t0

    logs = [ctx.full_group_log(gid) for gid in range(g)]
    for gid in ctx.live_groups():
        log = logs[gid]
        own = log[len(prefix) :] if gid == 6 else log
        if len({i for i, _ in own}) != len(own):
            raise AssertionError(f"group {gid}: an instance was delivered twice")
        if sorted(p for _, p in own) != sorted(sent[gid]):
            raise AssertionError(f"group {gid}: not every payload was delivered exactly once")
    return dict(
        logs=logs,
        retired=retired,
        seals=seals,
        prefixes=prefixes,
        state=export_state(hw),
        dispatch_count=hw.dispatch_count,
        last_gb=hw.last_gb,
        report=ctx.planner.report(),
        wall=wall,
        dispatch_s=dispatch_s,
        folds=folds,
        depths=depths,
        order=order,
        stats=dict(ctx.stats),
        delivered=ctx.stats["delivered"],
        ring_laps=hw.next_inst_host[0] / n,
        before_move=before_move,
        placement=hw.group_placement() if shards else None,
    )


# ---------------------------------------------------------------------------
# replicated KV: the service and the KV tier over the defaults' dataplane
# ---------------------------------------------------------------------------
KV_SESSIONS = 1024  # client sessions, routed onto the groups by session_hash
KV_WAVES = 12  # the chaos schedule of run_kv_twins (tests/test_kv_linearizable.py)
KV_BURST, KV_READS = 128, 4096  # the KV row of benchmarks/bench_wirepath.py
KV_PROBES = 8  # sessions a wave that read right after a write (one read-index op each)


def kv_key(i: int, j: int) -> bytes:
    return b"%06dk%d" % (i, j)  # 8 bytes: session i's key j


def kv_value(i: int, c: int) -> bytes:
    return b"%06dv%05d" % (i, c % 100_000)  # 12 bytes: session i's op c


def apply_op(state: dict, op: KvOp) -> None:
    """The KV tier's apply rule on one segment's key -> value map: a cas
    applies against the segment's own value (absent and deleted both read
    as ``None``)."""
    if op.op == OP_PUT or (op.op == OP_CAS and state.get(op.key) == op.expect):
        state[op.key] = op.value
    elif op.op == OP_DELETE:
        state[op.key] = None


class KvModel:
    """What each session wrote, segment by segment, by the KV tier's rules:
    a cas applies against its own ``(group, generation)`` segment's value
    (absent and deleted both read as ``None``); a key present in a newer
    segment of the session's chain masks the older ones.  With every key
    written by one session only, the model's answer is the session's last
    write."""

    def __init__(self):
        self.segs: dict[int, dict[tuple[int, int], dict[bytes, bytes | None]]] = {}

    def apply(self, i: int, seg, op: KvOp) -> None:
        apply_op(self.segs.setdefault(i, {}).setdefault(seg, {}), op)

    def get(self, i: int, chain, key: bytes) -> bytes | None:
        mine = self.segs.get(i, {})
        for seg in reversed(chain):
            if key in mine.get(seg, {}):
                return mine[seg][key]
        return None


def decode_segments(svc: ConsensusService, segs) -> dict:
    """The read oracle: every segment's log decoded afresh into its key ->
    value map, apart from the replicas the KV tier keeps."""
    out = {}
    for seg in segs:
        state: dict[bytes, bytes | None] = {}
        for _inst, payload in svc.log_segment(*seg):
            apply_op(state, decode_op(payload))
        out[seg] = state
    return out


def replica_of(log) -> tuple:
    """A fresh apply loop over a whole log: the twins' side of the check."""
    rep = GroupReplica()
    rep.apply_log(list(log))
    return rep.signature()


class KvClients:
    """1,024 sessions over a ``ReplicatedKV``, each the single writer of two
    keys, with the op mix of ``run_kv_twins``: 50% put, 20% delete, 30% cas
    (a third expect-absent, two thirds a value expect that mostly misses),
    8-byte keys and 12-byte values (a cas frame is 18 + 8 + 12 + 12 bytes).
    ``reads`` gets a key of every session and holds each answer to the
    model and to the oracle that decodes the session's stitched chain; a
    leased get must leave ``dispatch_count`` where it was."""

    def __init__(self, svc: ConsensusService, kv: ReplicatedKV, n: int, rng, clock):
        self.svc, self.kv, self.rng, self.clock = svc, kv, rng, clock
        self.sids = [f"kv-{i:04d}" for i in range(n)]
        self.counters = [0] * n
        self.model = KvModel()
        self.writes = self.gets = 0
        self.answers: list = []

    def op(self, i: int) -> None:
        self.counters[i] += 1
        c = self.counters[i]
        key = kv_key(i, int(self.rng.integers(2)))
        r = self.rng.random()
        if r < 0.5:
            op = KvOp(OP_PUT, key, kv_value(i, c))
        elif r < 0.7:
            op = KvOp(OP_DELETE, key)
        else:
            expect = None if r < 0.8 else kv_value(i, int(self.rng.integers(c)))
            op = KvOp(OP_CAS, key, kv_value(i, c), expect)
        self.write(i, op)

    def write(self, i: int, op: KvOp) -> None:
        s = self.kv.session(self.sids[i])
        if op.op == OP_PUT:
            t = s.put(op.key, op.value)
        elif op.op == OP_DELETE:
            t = s.delete(op.key)
        else:
            t = s.cas(op.key, op.expect, op.value)
        self.model.apply(i, (t.group, self.svc.group_generation(t.group)), op)
        self.writes += 1

    def get(self, i: int, key: bytes, oracle: dict | None = None) -> bytes | None:
        kv, hw = self.kv, self.svc.ctx.hw
        leased, base = kv.stats["leased_gets"], hw.dispatch_count
        got = kv.session(self.sids[i]).get(key)
        self.gets += 1
        chain = self.svc.session_chain(self.sids[i])
        want = self.model.get(i, chain, key)
        if got != want:
            raise AssertionError(f"stale read: session {i} key {key!r} got {got!r}, "
                                 f"its last write {want!r}")  # fmt: skip
        if oracle is not None:
            seen = None
            for seg in reversed(chain):
                if key in oracle[seg]:
                    seen = oracle[seg][key]
                    break
            if got != seen:
                raise AssertionError(f"session {i} key {key!r} got {got!r}, its chain {seen!r}")
        if kv.stats["leased_gets"] > leased and hw.dispatch_count != base:
            raise AssertionError(f"a leased get of session {i} dispatched to the card")
        self.answers.append(got)
        return got

    def reads(self) -> None:
        t0 = time.perf_counter()
        segs = {seg for sid in self.sids for seg in self.svc.session_chain(sid)}
        oracle = decode_segments(self.svc, segs)
        self.clock["oracle_s"] += time.perf_counter() - t0
        for i in range(len(self.sids)):
            self.get(i, kv_key(i, int(self.rng.integers(2))), oracle)


def quiesce(svc: ConsensusService) -> None:
    svc.run_until_quiescent()
    if not svc.ctx.quiescent():
        raise AssertionError("the service did not drain")


def aligned(x: int, b: int) -> int:
    return -(-x // b) * b


def feed_twins(ctx, twins: list, clock: dict) -> None:
    """Every value the service submits to group g goes to twin g too, and
    each pump of the service pumps every twin: the same schedule at the same
    cadence.  The twins' share of the wall goes to ``clock["twins_s"]``."""
    submit, pump = ctx.submit, ctx.pump

    def fed_submit(payload: bytes, group: int = 0) -> int:
        seq = submit(payload, group=group)
        t0 = time.perf_counter()
        if twins[group] is not None:  # an adopted group has no twin
            twins[group].submit(payload)
        clock["twins_s"] += time.perf_counter() - t0
        return seq

    def fed_pump(rounds: int = 1) -> None:
        pump(rounds)
        t0 = time.perf_counter()
        for twin in twins:
            if twin is not None:
                twin.pump(rounds)
        clock["twins_s"] += time.perf_counter() - t0

    ctx.submit, ctx.pump = fed_submit, fed_pump


def kv_bench(svc: ConsensusService, kv: ReplicatedKV) -> dict:
    """``benchmarks/bench_wirepath.py``'s KV row: a write burst of 128 puts,
    one round trip each through the dispatch, then 4,096 leased gets, each
    the best of 3 by the host clock; the gets must dispatch nothing."""
    s = kv.session("kv-bench")
    write_s, read_s = [], []
    for t in range(3):
        sync(svc.ctx.hw.device)
        t0 = time.perf_counter()
        for j in range(KV_BURST):
            s.put(b"bnch%04d" % (j & 63), b"t%03dj%07d" % (t, j))
        svc.run_until_quiescent()
        kv.refresh()
        sync(svc.ctx.hw.device)
        write_s.append(time.perf_counter() - t0)
    if s.get(b"bnch0001") != b"t002j%07d" % (64 + 1):  # settle: the lease validates
        raise AssertionError("the write burst's last value did not land")
    base, leased = svc.ctx.hw.dispatch_count, kv.stats["leased_gets"]
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(KV_READS):
            s.get(b"bnch0001")
        read_s.append(time.perf_counter() - t0)
    if svc.ctx.hw.dispatch_count != base or kv.stats["leased_gets"] != leased + 3 * KV_READS:
        raise AssertionError("the bench's leased gets dispatched to the card")
    write_us, read_us = min(write_s) / KV_BURST * 1e6, min(read_s) / KV_READS * 1e6
    return dict(write_us_per_op=write_us, leased_get_us_per_op=read_us,
                read_write_ratio=write_us / read_us)  # fmt: skip


def run_kv_path(use_kernels: bool, dev) -> dict:
    """The replicated KV tier on the defaults' service (``PaxosConfig(
    n_groups=8, realign_after=4)``, snapshots on): ``ConsensusService`` and
    ``ReplicatedKV`` over 8 groups of A=3, N=65,536, 64-byte values, with
    eight fused single-group twins (snapshots on) fed the same values at the
    same cadence.  ``KV_WAVES`` waves of 2 to 4 ops from each of 1,024
    sessions, the first ``KV_PROBES`` of them reading right after a write,
    then a get of every session; on ``run_kv_twins``'s chaos schedule:
    group 0's coordinator fails in wave 3 and is restored in wave 5 (its
    window carries whole bursts from a burst-aligned estimate, so that the
    restore burns nothing forward, which the engine does only under
    ``use_kernels``: the kernel and plain runs stay comparable), an
    acceptor of group 0 crashes with its state in wave 6 and is restored
    from the snapshot in wave 9, group 7 retires in wave 7 (its replica held
    to a fresh apply over its twin's log) and is created again in wave 10,
    and every group is compacted every 4 waves.  Then a second context's
    sealed snapshot of its group 3 is adopted into the slot group 6 vacates
    (its replica must equal the source's, with no dispatch), one more wave,
    every live group's replica held to a fresh apply over its twin's log,
    and the KV bench row (``kv_bench``)."""
    cfg = default_multigroup_config()
    g, b = cfg.n_groups, cfg.batch
    ctx = PaxosContext(cfg, use_kernels=use_kernels, snapshots=True, device=dev)
    hw = ctx.hw
    svc = ConsensusService(ctx)
    kv = ReplicatedKV(svc)
    single = dataclasses.replace(cfg, n_groups=1)

    def twin():
        return PaxosContext(single, use_kernels=use_kernels, fused=True, snapshots=True,
                            device=dev)  # fmt: skip

    twins = [twin() for _ in range(g)]
    clock = {"twins_s": 0.0, "oracle_s": 0.0}
    feed_twins(ctx, twins, clock)
    rng = np.random.default_rng(SEED + 25)
    clients = KvClients(svc, kv, KV_SESSIONS, rng, clock)
    seals, retire_sigs = [], []
    churn, window = g - 1, (3, 4)
    sync(dev)
    t0 = time.perf_counter()

    def wave(w: int) -> None:
        hot = [i for i in range(KV_SESSIONS) if svc.group_of(clients.sids[i]) == 0]
        hot_set = set(hot)
        in_window = w in window
        for i in range(KV_SESSIONS):
            if in_window and i in hot_set:
                continue
            for _ in range(int(rng.integers(2, 5))):
                clients.op(i)
        if in_window:  # whole bursts to group 0's software coordinator
            for k in range(b):
                clients.op(hot[k % len(hot)])
        probes = [i for i in range(KV_SESSIONS) if not (in_window and i in hot_set)][:KV_PROBES]
        for i in probes:  # a pending write: the get takes one read-index op
            op = KvOp(OP_PUT, kv_key(i, 0), kv_value(i, 99_999))
            clients.write(i, op)
            clients.get(i, op.key)
        quiesce(svc)
        clients.reads()

    for w in range(KV_WAVES):
        if w == 3:
            gap = hw.next_inst_host[0]
            ctx.fail_coordinator(est_next_inst=aligned(gap, b), group=0)
            twins[0].fail_coordinator()
        if w == 5:
            ctx.restore_hardware_coordinator(group=0)
            twins[0].restore_hardware_coordinator()
        if w == 6:
            ctx.crash_acceptor(2, group=0)
            twins[0].crash_acceptor(2)
        if w == 7:
            gen = svc.group_generation(churn)
            svc.retire_group(churn)
            kv.refresh()
            sig = kv.replica(churn, gen).signature()
            if sig != replica_of(twins[churn].delivered_log):
                raise AssertionError(f"retired group {churn}'s replica differs from its twin's")
            retire_sigs.append(sig)
            twins[churn] = None
        if w == 9:
            if ctx.snapshots.watermark(0) <= 0:
                raise AssertionError("group 0 has no snapshot to restore from")
            ctx.restore_acceptor(2, group=0)
            twins[0].restore_acceptor(2)
        if w == 10:
            if svc.create_group() != churn:
                raise AssertionError("create_group did not reuse the retired slot")
            twins[churn] = twin()
        wave(w)
        if (w + 1) % 4 == 0:  # compaction mid-stream, both sides
            for gid in ctx.live_groups():
                seals.append(ctx.snapshot_group(gid).seal)
                twins[gid].snapshot_group()
    sync(dev)
    wall = time.perf_counter() - t0
    chaos = dict(clock, writes=clients.writes, gets=clients.gets, wall_s=wall)

    # a sealed snapshot from a second context, adopted into a vacated slot
    peer = PaxosContext(cfg, use_kernels=use_kernels, snapshots=True, device=dev)
    peer_svc = ConsensusService(peer)
    peer_kv = ReplicatedKV(peer_svc)
    src = 3
    sids = [sid for sid in (f"peer-{i}" for i in range(4096)) if peer_svc.group_of(sid) == src]
    for k, sid in enumerate(sids[:64]):
        for j in range(4):
            peer_kv.session(sid).put(b"p%07d" % (4 * k + j), b"peer%08d" % j)
    quiesce(peer_svc)
    peer.hw.burn_forward(src, aligned(peer.hw.next_inst_host[src], b))  # realigned under kernels
    snap = peer.snapshot_group(src)
    peer_kv.refresh()
    want = peer_kv.replica(src).signature()
    vacated = g - 2
    svc.retire_group(vacated)
    twins[vacated] = None
    base = hw.dispatch_count
    if svc.adopt_group(snap, list(peer.snapshots.log_prefix(src))) != vacated:
        raise AssertionError("adopt_group did not reuse the vacated slot")
    kv.refresh()
    if kv.replica(vacated).signature() != want or hw.dispatch_count != base:
        raise AssertionError("the adopted snapshot was not applied host-side as the source's")
    seals.append(snap.seal)
    wave(KV_WAVES)
    for twin_ in twins:
        if twin_ is not None:
            twin_.run_until_quiescent()
    for gid in ctx.live_groups():
        log = ctx.full_group_log(gid)
        if twins[gid] is not None:
            theirs = twins[gid].full_group_log()
            if [p for _, p in log] != [p for _, p in theirs]:
                raise AssertionError(f"group {gid}'s payloads differ from its twin's")
        else:
            theirs = log
        if kv.replica(gid).signature() != replica_of(theirs):
            raise AssertionError(f"group {gid}'s replica differs from a fresh apply")
    del ctx.submit, ctx.pump  # the twins stop here: the bench times the service alone
    if not kv.stats["leased_gets"] or not kv.stats["read_index_gets"]:
        raise AssertionError(f"the schedule did not take both read paths: {kv.stats}")
    bench = kv_bench(svc, kv)
    return dict(
        logs=[ctx.full_group_log(gid) for gid in range(g)],
        archived=svc.archived_segments(),
        signatures={key: rep.signature() for key, rep in kv._replicas.items()},
        retire_sigs=retire_sigs,
        answers=clients.answers,
        stats=dict(kv.stats),
        dispatch_count=hw.dispatch_count,
        seals=seals,
        report=svc.plan_report(),
        epoch=svc.routing_epoch,
        state=export_state(hw),
        chaos=chaos,
        bench=bench,
    )


def kv_metrics(run_: dict, counts: dict | None = None) -> dict:
    """A KV run's numbers: client ops (writes and gets) a second over the
    schedule's wall less the twins' and the read oracle's host time, and
    the bench row where the run has one."""
    c = run_["chaos"]
    own_s = c["wall_s"] - c.get("twins_s", 0.0) - c["oracle_s"]
    out = dict(kv_ops_per_s=(c["writes"] + c["gets"]) / own_s, **c, own_wall_s=own_s,
               **run_.get("bench", {}))  # fmt: skip
    if counts is not None:
        out["launches"] = {key: n for key, n in counts.items() if n}
    return out


def run_kv_sharded(use_kernels: bool, dev, mesh: GroupMesh) -> dict:
    """The KV tier on the defaults' service sharded over ``mesh``
    (``group_mesh``: two shards of four groups on the card): three waves of
    puts from every session, the sessions of one group writing four times
    as much; one ``plan_placement`` of the loads; a retire on the shard the
    plan gives the hot group (the next shard if the plan keeps it) and
    ``migrate_group`` of the hot group there, from a burst-aligned drain
    watermark (the move re-seats the sequencer, realigned only under
    ``use_kernels``).  The hot group's sessions read the same values after
    the move as before, each get leased and dispatching nothing; two more
    waves, every get held to the model and the chain oracle."""
    cfg = default_multigroup_config()
    b = cfg.batch
    ctx = PaxosContext(cfg, use_kernels=use_kernels, snapshots=True, device=dev,
                       mesh=mesh)  # fmt: skip
    hw = ctx.hw
    svc = ConsensusService(ctx)
    kv = ReplicatedKV(svc)
    clock = {"oracle_s": 0.0}
    clients = KvClients(svc, kv, KV_SESSIONS, np.random.default_rng(SEED + 26), clock)
    hot = svc.group_of(clients.sids[0])

    def wave(w: int) -> None:
        for i, sid in enumerate(clients.sids):
            for j in range(4 if svc.group_of(sid) == hot else 1):
                clients.write(i, KvOp(OP_PUT, kv_key(i, j % 2), kv_value(i, 10 * w + j)))
        quiesce(svc)
        clients.reads()

    sync(dev)
    t0 = time.perf_counter()
    for w in range(3):
        wave(w)
    plan = svc.plan_placement()
    dst = plan.shard_of(hot)
    if dst == svc.shard_of(clients.sids[0]):
        dst = (dst + 1) % mesh.n_shards
    gone = next(h for h in ctx.live_groups() if h != hot and svc.group_placement()[h] == dst)
    svc.retire_group(gone)
    movers = [i for i, sid in enumerate(clients.sids) if svc.group_of(sid) == hot]
    before = [kv.session(clients.sids[i]).get(kv_key(i, 0)) for i in movers]
    hw.burn_forward(hot, aligned(hw.next_inst_host[hot], b))
    snap = svc.migrate_group(hot, dst)
    if hw.shard_of_group(hot) != dst or any(svc.shard_of(clients.sids[i]) != dst for i in movers):
        raise AssertionError(f"group {hot} did not move to shard {dst}: {svc.group_placement()}")
    base, leased = hw.dispatch_count, kv.stats["leased_gets"]
    after = [clients.get(i, kv_key(i, 0)) for i in movers]
    if after != before or hw.dispatch_count != base:
        raise AssertionError("the moved group's sessions read other values, or dispatched")
    if kv.stats["leased_gets"] != leased + len(movers):
        raise AssertionError("a get of the moved group's sessions was not leased")
    for w in range(3, 5):
        wave(w)
    sync(dev)
    wall = time.perf_counter() - t0
    return dict(
        logs=[ctx.full_group_log(gid) for gid in range(cfg.n_groups)],
        signatures={key: rep.signature() for key, rep in kv._replicas.items()},
        answers=clients.answers,
        stats=dict(kv.stats),
        dispatch_count=hw.dispatch_count,
        seals=[snap.seal],
        placement=svc.group_placement(),
        plan=plan.slot_of,
        moved=(hot, gone, dst, len(movers)),
        report=svc.plan_report(),
        state=export_state(hw),
        chaos=dict(clock, writes=clients.writes, gets=clients.gets, wall_s=wall),
    )


# ---------------------------------------------------------------------------
# LM serving: K9 and the transformer at gemma3-27b's and llama4-scout's widths
# ---------------------------------------------------------------------------
LM_ARCH, LM_LAYERS = "gemma3-27b", 12  # depth cut from 62 layers: two 5:1 superblocks
K9_PATH = (2, 32, 16, 2048, 128)  # B, H, KVH, S, D of the LM path's prefill
DECODE_LEN = 1536  # the prefill-against-decode prompt: longer than the window (1024)
MOE_ARCH, MOE_LAYERS = "llama4-scout-17b-a16e", 4  # depth cut from 48 layers
MOE_K9 = (2, 40, 8, 2048, 128)  # B, H, KVH, S, D of the MoE path's prefill: G = 5
MOE_DECODE_LEN = 512  # the MoE prefill-against-decode prompt
# at most this share of the bf16 MoE prefill's routing decisions may differ
# between the run on K9 and the run on its plain version (run_moe_prefill)
MOE_ROUTES_SHARE = 0.01
# K9 against its plain version, the tolerances of tests/test_flash_kernel.py:
# float32 sums in another order; bf16 rounds the output and p once each
F32_ATOL, BF16_ATOL = 2e-5, 2e-2
# last logits (under 1 in size) of the bf16 prefill on K9 against the same
# step on K9's plain version: both round q.k's inputs and p to bf16, the
# output to bf16 at other points of its sums, through 12 layers (gemma3-27b)
# or 4 (llama4-scout, on the rows whose last token took the same experts in
# both runs: run_moe_prefill)
PREFILL_BF16_ATOL = 2e-2
# float32 prefill against teacher-forced decode, and the reduced models on
# the card against the CPU: float32 sums in other orders through the layers,
# on logits of order 1
PREFILL_DECODE_ATOL = SMALL_ATOL = 1e-4
# rwkv6-3b's (family "ssm") own bound.  Its gap, 1.07e-4 on logits up to
# 4.36, is float32 rounding (prefill_decode_gap, NVIDIA H100 80GB HBM3 at
# 700 W): on the same weights and prompt it is 2.5e-13 in float64; the
# float32 prefill lies 1.0e-4 and decode 5.3e-5 from the float64 run; the
# gap grows with depth, 3.4e-5, 5.8e-5 and 1.07e-4 at 8, 16 and 32 layers.
# 3e-4 is twice those two errors added, 7e-5 of the largest logit
PREFILL_DECODE_ATOL_BY_FAMILY = {"ssm": 3e-4}

K9_CHECKS = [  # (b, h, kvh, sq, sk, d, window, causal, dtype[, "views"])
    # tests/test_flash_kernel.py: the causal sweep, the windows, non-causal, bf16
    (1, 4, 2, 256, 256, 64, 0, True, torch.float32),
    (2, 4, 4, 128, 128, 128, 0, True, torch.float32),
    (1, 8, 1, 256, 256, 64, 0, True, torch.float32),
    (1, 2, 2, 384, 384, 128, 0, True, torch.float32),
    (1, 4, 2, 256, 256, 64, 64, True, torch.float32),
    (1, 4, 2, 256, 256, 64, 128, True, torch.float32),
    (1, 4, 2, 256, 256, 64, 1024, True, torch.float32),
    (1, 2, 1, 128, 128, 64, 0, False, torch.float32),
    (1, 4, 2, 128, 128, 128, 0, True, torch.bfloat16),
    # rows 191 and up see no key (causal, window 64, Sq 256 > Sk 128)
    (1, 4, 2, 256, 128, 64, 64, True, torch.float32),
    (1, 4, 2, 256, 128, 64, 64, True, torch.bfloat16),
    # ragged lengths
    (1, 4, 2, 200, 200, 64, 0, True, torch.float32),
    (1, 4, 2, 200, 200, 64, 0, True, torch.bfloat16),
    # the LM path's shapes: a global layer and a local one
    (2, 32, 16, 2048, 2048, 128, 0, True, torch.bfloat16),
    (2, 32, 16, 2048, 2048, 128, 1024, True, torch.bfloat16),
    # the float32 prefill-against-decode run's shapes, a global and a local layer
    (1, 32, 16, 1536, 1536, 128, 0, True, torch.float32),
    (1, 32, 16, 1536, 1536, 128, 1024, True, torch.float32),
    # "views": (B, H, S, D) views of (B, S, H, D) tensors, as the models hand
    # them over: the LM path's two layers, ragged lengths across a 128-row
    # and a 128-key tile edge, a Whisper-shaped cross-attention, and S=8192 at
    # window 1024, where the K/V ring wraps many times
    (2, 32, 16, 2048, 2048, 128, 0, True, torch.bfloat16, "views"),
    (2, 32, 16, 2048, 2048, 128, 1024, True, torch.bfloat16, "views"),
    (1, 32, 16, 1536, 1536, 128, 1024, True, torch.float32, "views"),
    # the MoE path's: llama4-scout's bf16 prefill and float32 prefill-against-decode
    (2, 40, 8, 2048, 2048, 128, 0, True, torch.bfloat16, "views"),
    (1, 40, 8, 512, 512, 128, 0, True, torch.float32, "views"),
    (1, 4, 2, 200, 333, 128, 0, True, torch.bfloat16, "views"),
    (1, 8, 8, 448, 1500, 64, 0, False, torch.bfloat16, "views"),
    (1, 2, 1, 8192, 8192, 128, 1024, True, torch.bfloat16, "views"),
    # head dims that fill no whole register tile (16, 32, 80) and D=256,
    # whose 64-key tiles ring through many stages at S=1024
    (2, 4, 2, 77, 200, 32, 0, False, torch.bfloat16),
    (1, 2, 1, 200, 131, 16, 50, False, torch.bfloat16),
    (1, 4, 2, 150, 150, 80, 0, True, torch.bfloat16),
    (1, 2, 1, 100, 100, 256, 33, True, torch.bfloat16),
    (1, 4, 2, 1024, 1024, 256, 512, True, torch.bfloat16),
    (1, 4, 2, 1024, 1024, 256, 512, True, torch.float32),
    # griffin's (recurrentgemma-2b: 10 heads over 1 kv head, D = 256, window
    # 2048): the bf16 prefill, S past the window, and the float32
    # prefill-against-decode run's
    (2, 10, 1, 4096, 4096, 256, 2048, True, torch.bfloat16, "views"),
    (1, 10, 1, 512, 512, 256, 2048, True, torch.float32, "views"),
    # whisper-base's bf16 prefill (B = 4, 8 heads of 64): the encoder over 1500
    # frames, the decoder's causal self-attention and its cross-attention over
    # 448 tokens; then the float32 prefill-against-decode run's three
    (4, 8, 8, 1500, 1500, 64, 0, False, torch.bfloat16, "views"),
    (4, 8, 8, 448, 448, 64, 0, True, torch.bfloat16, "views"),
    (4, 8, 8, 448, 1500, 64, 0, False, torch.bfloat16, "views"),
    (1, 8, 8, 1500, 1500, 64, 0, False, torch.float32, "views"),
    (1, 8, 8, 448, 448, 64, 0, True, torch.float32, "views"),
    (1, 8, 8, 448, 1500, 64, 0, False, torch.float32, "views"),
]


def k9_inputs(gen, b, h, kvh, sq, sk, d, dtype, dev, views: bool = False):
    """q, k, v as (B, H, S, D): contiguous, or ``views`` of (B, S, H, D)
    tensors as the models make them."""
    shapes = ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))
    if not views:
        return tuple(torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes)
    return tuple(torch.randn((s[0], s[2], s[1], s[3]), generator=gen, device=dev).to(dtype)
                 .permute(0, 2, 1, 3) for s in shapes)  # fmt: skip


def check_k9(dev) -> float:
    """K9 against its plain version on the card at ``K9_CHECKS`` (the plain
    version on contiguous copies of the views); rows that see no key must
    also be the mean of V over all Sk keys, and the output of views must be
    laid out as q is.  Returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    worst = 0.0
    for b, h, kvh, sq, sk, d, window, causal, dtype, *layout in K9_CHECKS:
        views = layout == ["views"]
        q, k, v = k9_inputs(gen, b, h, kvh, sq, sk, d, dtype, dev, views)
        got = k_flash.flash_attention(q, k, v, window=window, causal=causal)
        if views and (got.stride() != q.stride() or q.is_contiguous()):
            raise AssertionError(f"K9 on views: output strides {got.stride()}, q's {q.stride()}")
        want = k_flash.flash_attention_plain(*(t.contiguous() for t in (q, k, v)), window=window,
                                             causal=causal)  # fmt: skip
        err = (got.float() - want.float()).abs().max().item()
        atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        blind = sk + window - 1  # the first row that sees no key, where there is one
        if window and blind < sq:
            mean = v.float().mean(dim=2).repeat_interleave(h // kvh, dim=1)[:, :, None]
            err = max(err, (got[:, :, blind:].float() - mean).abs().max().item())
        print(f"  K9 B={b} H={h} KVH={kvh} Sq={sq} Sk={sk} D={d} window={window} "
              f"causal={causal} {str(dtype)[6:]}{' views' if views else ''}: "
              f"max_abs_err {err}")  # fmt: skip
        if not (bool(got.isfinite().all()) and err <= atol):
            raise AssertionError(f"K9 differs from its plain version by {err} > {atol}")
        worst = max(worst, err)
    return worst


SMALL_ARCHS = ["gemma3-27b", "qwen3-4b", "llama4-scout-17b-a16e", "dbrx-132b", "internvl2-76b",
               "recurrentgemma-2b", "rwkv6-3b", "whisper-base"]  # fmt: skip


def check_lm_small(dev) -> None:
    """The reduced models on the card (K9 in float32 at head dim 16) against
    the same models on the CPU (the chunked attention that the CPU tests
    hold against the reference): the dense gemma3-27b and qwen3-4b, the MoE
    llama4-scout (top-1 and a shared expert) and dbrx (top-2), internvl2
    with seeded patches in front of its tokens, recurrentgemma (griffin),
    rwkv6 and whisper with seeded frames; griffin's and whisper's attention
    at unit q and k spread, as their CPU tests take it (``unit_qk``).
    Prefill's last logits within ``SMALL_ATOL`` and ``ServeLoop``'s tokens
    equal (whisper's on zero cross caches, as the reference's ``ServeLoop``
    takes no frames; griffin's, at ``max_len`` 24, through its 8-slot
    attention ring, which wraps)."""
    for arch in SMALL_ARCHS:
        cfg = get_config(arch).reduced()
        on_cpu = lm_registry.init_params(cfg, torch.Generator().manual_seed(SEED))
        if cfg.family in ("hybrid", "encdec"):
            unit_qk(cfg, on_cpu)
        on_card = lm_layers.tree_map(lambda t: t.to(dev), on_cpu)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
        frontend = {"vlm": ("patches", cfg.n_patches), "encdec": ("frames", cfg.src_len)}
        if cfg.family in frontend:
            name, n = frontend[cfg.family]
            shape = (2, n, cfg.d_model)
            batch[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        step = make_prefill_step(cfg)
        got = step(on_card, {key: t.to(dev) for key, t in batch.items()})[0].cpu()
        err = (got - step(on_cpu, batch)[0]).abs().max().item()
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(np.int32), max_new=6)
                for i, n in enumerate([5, 12, 0, 9, 3])]  # fmt: skip
        want = ServeLoop(cfg, on_cpu, 4, 24, device="cpu").run(reqs)
        got = ServeLoop(cfg, on_card, 4, 24, device=dev).run(reqs)
        with_ = f" with {frontend[cfg.family][0]}" if cfg.family in frontend else ""
        print(f"  reduced {arch}{with_}, card against CPU: prefill logits max_abs_err {err}, "
              f"ServeLoop tokens equal: {got == want}")  # fmt: skip
        if err > SMALL_ATOL or got != want:
            raise AssertionError(f"reduced {arch} differs between the card and the CPU")


def lm_config(dtype: str):
    return dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS, dtype=dtype)


def moe_config(dtype: str, **kw):
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS, dtype=dtype, **kw)


def unit_qk(cfg, params: dict) -> dict:
    """``params`` with every attention's ``wq`` and ``wk`` (a dict holding
    both, each ``(..., d_model, heads, head_dim)``) scaled in place by
    sqrt(heads / d_model), so that q and k have unit spread."""
    if "wq" in params and "wk" in params:
        for name in ("wq", "wk"):
            params[name].mul_(math.sqrt(params[name].shape[-2] / cfg.d_model))
    for sub in params.values():
        if isinstance(sub, dict):
            unit_qk(cfg, sub)
    return params


def lm_params(cfg, dev) -> tuple[dict, dict]:
    """The weights of ``cfg`` (float32) and their bf16 cast, drawn on the
    card by ``registry.init_params`` from a seeded generator, then every
    attention's ``wq`` and ``wk`` scaled by sqrt(heads / d_model)
    (``unit_qk``).

    The reference's fan-in rule takes a (d_model, heads, head_dim) weight's
    head count as its fan-in, which at gemma3-27b's width gives q and k a
    spread of about 13 and 18 and the scores one of about 240: near one-hot
    attention, whose near-ties carry a difference in the last bits of any
    sum from layer to layer until the logits differ entirely (a 12-layer
    model of this kind at d_model 1024 gave float32 prefill and decode
    logits 0.48 apart, as large as the logits).  The scaling gives q and k
    unit spread, so the comparisons below can tell a right kernel from a
    wrong one."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = unit_qk(cfg, lm_registry.init_params(cfg, gen))
    return params, lm_layers.tree_map(lambda t: t.to(torch.bfloat16), params)


class PlainAttention:
    """Counts the calls of K9's plain version while entered.  With
    ``route=True`` every attention call goes to the plain version instead of
    K9: the comparison run on the card (a hook of this script, not a path of
    the port)."""

    def __init__(self, route: bool = False):
        self.calls = 0
        self._route = route

    def __enter__(self):
        self._plain, self._router = k_flash.flash_attention_plain, k_flash.flash_attention

        def counted(*args, **kw):
            self.calls += 1
            return self._plain(*args, **kw)

        k_flash.flash_attention_plain = counted
        if self._route:
            k_flash.flash_attention = counted
        return self

    def __exit__(self, *exc):
        k_flash.flash_attention_plain, k_flash.flash_attention = self._plain, self._router


class K9Layouts:
    """Records, while entered, what each model attention call hands K9: the
    layer's q, k, v (dense in the models' (B, S, ., D) layout, or copied by
    ``.contiguous()``) and K9's (views of the layer's storage, or copies)."""

    def __init__(self):
        self.layer_dense, self.k9_views = [], []

    def __enter__(self):
        self._layer, self._k9 = lm_layers.flash_attention, k_flash.flash_attention

        def layer(q, k, v, **kw):
            self.layer_dense.append([t.is_contiguous() for t in (q, k, v)])
            self._inputs = (q, k, v)
            return self._layer(q, k, v, **kw)

        def k9(q, k, v, **kw):
            self.k9_views.append([not t.is_contiguous() and t.data_ptr() == src.data_ptr()
                                  for t, src in zip((q, k, v), self._inputs)])  # fmt: skip
            return self._k9(q, k, v, **kw)

        lm_layers.flash_attention, k_flash.flash_attention = layer, k9
        return self

    def __exit__(self, *exc):
        lm_layers.flash_attention, k_flash.flash_attention = self._layer, self._k9


class Routes:
    """Records, while entered, the experts ``layers.moe_route`` chooses for
    each (token, choice) of every MoE layer, a ``(g, tokens, top_k)`` tensor
    a layer in call order."""

    def __init__(self):
        self.idx = []

    def __enter__(self):
        self._route = lm_layers.moe_route

        def recorded(router, xt, k):
            gate, idx = self._route(router, xt, k)
            self.idx.append(idx)
            return gate, idx

        lm_layers.moe_route = recorded
        return self

    def __exit__(self, *exc):
        lm_layers.moe_route = self._route


def timed_prefill(dev, step, params: dict, batch: dict, layers: int, calls: int):
    """``calls`` calls of the prefill ``step`` on the host clock, with the
    launch counts and the peak memory set to 0 just before them: K9 must
    launch once a layer a call and the plain attention never.  Returns the
    last call's logits and cache, the seconds a call, the launch counts and
    the peak memory in GB."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    call_s = []
    with PlainAttention() as plain:
        for _ in range(calls):
            t0 = time.perf_counter()
            last, cache = step(params, batch)
            sync(dev)
            call_s.append(time.perf_counter() - t0)
    launches = read_launches()
    if launches["K9"] != layers * calls or plain.calls:
        raise AssertionError(f"the prefill did not run K9 once a layer: {launches}, "
                             f"plain attention calls {plain.calls}")  # fmt: skip
    if not bool(last.isfinite().all()):
        raise AssertionError("the prefill's logits are not finite")
    return last, cache, call_s, launches, torch.cuda.max_memory_allocated(dev) / 1e9


def plain_prefill(step, params: dict, batch: dict, layers: int) -> torch.Tensor:
    """The prefill ``step``'s last logits with every attention call on K9's
    plain version (and no K9 launch)."""
    before = k_flash.launches
    with PlainAttention(route=True) as ref:
        ref_last, _ = step(params, batch)
    if ref.calls != layers or k_flash.launches != before:
        raise AssertionError("the comparison prefill did not run on K9's plain version")
    return ref_last


def run_lm_prefill(dev, params: dict, calls: int = 5) -> dict:
    """``make_prefill_step`` on B=2 prompts of S=2048 tokens, bf16: one
    warm-up call, then ``calls`` timed calls with the launch counts set to 0
    just before them, then one call on K9's plain version to compare."""
    cfg = lm_config("bfloat16")
    b, _, kvh, s, hd = K9_PATH
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s)))
    batch = {"tokens": tokens.to(dev)}
    step = make_prefill_step(cfg)
    with K9Layouts() as layouts:  # the warm-up call
        step(params, batch)
    sync(dev)
    print(f"  layer inputs q, k, v dense in (B, S, ., D), so .contiguous() copies none: "
          f"{layouts.layer_dense[0]} (every layer alike: "
          f"{all(x == layouts.layer_dense[0] for x in layouts.layer_dense)}); K9 handed views "
          f"of their storage, no copies: {all(map(all, layouts.k9_views))}")  # fmt: skip
    if len(layouts.k9_views) != LM_LAYERS or not all(map(all, layouts.k9_views)):
        raise AssertionError(f"the prefill copied q, k or v around K9: {layouts.k9_views}")
    last, cache, call_s, launches, peak_gb = timed_prefill(dev, step, params, batch, LM_LAYERS,
                                                           calls)  # fmt: skip
    want_cache = (LM_LAYERS, b, s, kvh, hd)
    if tuple(last.shape) != (b, cfg.vocab) or tuple(cache["k"].shape) != want_cache:
        raise AssertionError(f"prefill shapes {tuple(last.shape)}, {tuple(cache['k'].shape)}")
    ref_last = plain_prefill(step, params, batch, LM_LAYERS)
    err = (last.float() - ref_last.float()).abs().max().item()
    same = (last.argmax(-1) == ref_last.argmax(-1)).tolist()
    print(f"  K9 launches {launches['K9']} in {calls} calls, plain attention calls 0; last "
          f"logits against the plain attention's: max_abs_err {err} "
          f"(|logit| up to {ref_last.float().abs().max().item()}), argmax equal {same}")
    if err > PREFILL_BF16_ATOL:
        raise AssertionError(f"prefill on K9 differs from prefill on its plain version by {err}")
    p50, _ = percentiles(call_s)
    return dict(launches=launches, max_abs_err=err, argmax_equal=same, call_s=call_s,
                prefill_ms_p50=p50, tokens_per_s=b * s / (p50 / 1e3),
                max_memory_allocated_gb=peak_gb,
                layer_inputs_dense=layouts.layer_dense[0])  # fmt: skip


def dropped(cfg, idx: torch.Tensor) -> int:
    """(token, choice) pairs of one layer's routes ``idx`` (g, tokens, k)
    over their expert's capacity in their dispatch group."""
    cap = lm_layers.moe_capacity(cfg, idx.shape[1])
    load = torch.stack([torch.bincount(row.flatten(), minlength=cfg.n_experts) for row in idx])
    return int((load - cap).clamp(min=0).sum().item())


def run_moe_prefill(dev, params: dict, calls: int = 5) -> dict:
    """``make_prefill_step`` of llama4-scout at full width (``MOE_LAYERS``
    layers) on B=2 prompts of S=2048 tokens, bf16, at the default capacity
    factor: a warm-up call that records every layer's routes, then
    ``calls`` timed calls with the launch counts set to 0 just before them
    (K9 once a layer, the plain attention never), then one call on K9's
    plain version, routes recorded, to compare.

    At most ``MOE_ROUTES_SHARE`` of the routing decisions may differ
    between the two (bf16 router logits tie and round: a last-bit
    difference in attention moves a token to another expert, and so may
    move which tokens its expert drops).  The last logits of a row are held
    within ``PREFILL_BF16_ATOL`` where its last token took the same experts
    in every layer in both runs; a row whose last token did not is printed
    and not held (its own expert output differs by design), and at least
    one row must be held."""
    cfg = moe_config("bfloat16")
    b, h, kvh, s, hd = MOE_K9
    tokens = torch.from_numpy(np.random.default_rng(SEED + 7).integers(0, cfg.vocab, (b, s)))
    batch = {"tokens": tokens.to(dev)}
    step = make_prefill_step(cfg)
    with Routes() as routes:  # the warm-up call
        last, _ = step(params, batch)
    sync(dev)
    timed_last, cache, call_s, launches, peak_gb = timed_prefill(dev, step, params, batch,
                                                                 MOE_LAYERS, calls)  # fmt: skip
    if tuple(timed_last.shape) != (b, cfg.vocab) or tuple(cache["k"].shape) != (
        MOE_LAYERS, b, s, kvh, hd
    ):
        raise AssertionError(f"MoE prefill shapes {tuple(timed_last.shape)}, "
                             f"{tuple(cache['k'].shape)}")  # fmt: skip
    if not bool(last.isfinite().all()):
        raise AssertionError("the MoE prefill's logits are not finite")
    with Routes() as ref_routes:
        ref_last = plain_prefill(step, params, batch, MOE_LAYERS)
    if len(routes.idx) != MOE_LAYERS or len(ref_routes.idx) != MOE_LAYERS:
        raise AssertionError(f"{len(routes.idx)} and {len(ref_routes.idx)} MoE layers routed")
    differ = [int((x != y).sum().item()) for x, y in zip(routes.idx, ref_routes.idx)]
    decisions = MOE_LAYERS * b * s * cfg.top_k
    # a row's last token: the last of its s tokens in (batch, position) order
    lasts = [r * s + s - 1 for r in range(b)]
    alike = [all(bool((x[0, i] == y[0, i]).all()) for x, y in zip(routes.idx, ref_routes.idx))
             for i in lasts]  # fmt: skip
    errs = (last.float() - ref_last.float()).abs().amax(dim=-1).tolist()
    same = (last.argmax(-1) == ref_last.argmax(-1)).tolist()
    drops = [dropped(cfg, x) for x in routes.idx]
    load = torch.bincount(routes.idx[0].flatten(), minlength=cfg.n_experts).tolist()
    print(f"  K9 launches {launches['K9']} in {calls} calls, plain attention calls 0; routes "
          f"that differ from the plain attention's run: {sum(differ)} of "
          f"{decisions} (by layer {differ}); rows whose last token routed alike in every layer "
          f"{alike}; last logits against the plain attention's by row: max_abs_err {errs} "
          f"(|logit| up to {ref_last.float().abs().max().item()}), argmax equal {same}; "
          f"tokens dropped by layer {drops} of {b * s} (capacity factor "
          f"{cfg.capacity_factor}); layer 0's expert load {load}")  # fmt: skip
    if sum(differ) > MOE_ROUTES_SHARE * decisions:
        raise AssertionError(f"{sum(differ)} of {decisions} routes differ from the plain run")
    held = [e for e, a in zip(errs, alike) if a]
    if not held or max(held) > PREFILL_BF16_ATOL:
        raise AssertionError(f"MoE prefill on K9 differs from its plain version: {errs}, {alike}")
    p50, _ = percentiles(call_s)
    return dict(launches=launches, max_abs_err=max(held), row_max_abs_err=errs,
                rows_held=alike, argmax_equal=same, routes_differ=sum(differ),
                routes_differ_by_layer=differ, routing_decisions=decisions,
                dropped_by_layer=drops, call_s=call_s, prefill_ms_p50=p50,
                tokens_per_s=b * s / (p50 / 1e3), max_memory_allocated_gb=peak_gb)  # fmt: skip


def model_batch(cfg, tokens: torch.Tensor, seed: int) -> dict:
    """A prefill batch of ``tokens``; whisper's with standard-normal frames
    (B, src_len, d_model) drawn on the tokens' device from ``seed``, in the
    model's dtype (the stub frontend's)."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        gen = torch.Generator(device=tokens.device).manual_seed(seed)
        shape = (tokens.shape[0], cfg.src_len, cfg.d_model)
        frames = torch.randn(shape, generator=gen, device=tokens.device)
        batch["frames"] = frames.to(getattr(torch, cfg.dtype))
    return batch


def prefill_decode_atol(cfg) -> float:
    return PREFILL_DECODE_ATOL_BY_FAMILY.get(cfg.family, PREFILL_DECODE_ATOL)


def prefill_and_decode(dev, params: dict, cfg, tokens: torch.Tensor, seed: int):
    """The prefill step's last logits on ``tokens`` (B = 1; whisper's over
    frames seeded by ``seed``), then teacher-forced ``serve_step`` decode's
    at the same position; whisper's decode reads the prefill's cross keys
    and values (``tests/test_serve.py`` seeds its cache so).  Returns both
    logits, K9's launches in the prefill and the decode's seconds."""
    s = tokens.shape[1]
    before = k_flash.launches
    last, pre = make_prefill_step(cfg)(params, model_batch(cfg, tokens, seed))
    k9 = k_flash.launches - before
    dtype = getattr(torch, cfg.dtype)
    cache = lm_registry.family_module(cfg).init_cache(cfg, 1, s, dtype, dev)
    for key in ("cross_k", "cross_v"):
        if key in cache:
            cache[key].copy_(pre[key])
    del pre
    step = make_serve_step(cfg)
    sync(dev)
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = step(params, tokens[:, t : t + 1], cache, t)
    sync(dev)
    return last, logits.reshape(last.shape), k9, time.perf_counter() - t0


def run_prefill_against_decode(dev, params: dict, cfg, s: int, seed: int) -> dict:
    """Float32, B=1, ``s`` tokens (whisper's over seeded frames): the prefill
    step's last logits against teacher-forced decode's at the same position
    (``prefill_and_decode``), within the family's bound
    (``prefill_decode_atol``).  Returns the tokens and the prefill's last
    logits too, for the ring phase."""
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (1, s)))
    tokens = tokens.to(dev)
    last, logits, k9, decode_s = prefill_and_decode(dev, params, cfg, tokens, seed)
    if k9 != lm_registry.attention_calls(cfg):
        raise AssertionError("the float32 prefill did not run K9 once an attention call")
    err = (logits - last).abs().max().item()
    same = bool(logits.argmax() == last.argmax())
    top = last.abs().max().item()
    bound = prefill_decode_atol(cfg)
    print(f"  prefill against {s} decode steps: last logits max_abs_err {err} (|logit| up to "
          f"{top}, bound {bound}), argmax equal {same}, decode {decode_s:.3f} s")
    if not (err <= bound and same and bool(last.isfinite().all())):
        raise AssertionError(f"float32 prefill and decode differ: {err}, argmax equal {same}")
    return dict(max_abs_err=err, max_abs_logit=top, bound=bound, argmax_equal=same,
                decode_steps=s, decode_s=decode_s, tokens=tokens, last=last)  # fmt: skip


GAP_ARCH, GAP_DEPTHS = "rwkv6-3b", (8, 16, 32)  # prefill_decode_gap's model and its depths


def prefill_decode_gap(dev) -> list[dict]:
    """The float32 gap between ``GAP_ARCH``'s prefill and decode, witnessed:
    ``run_family``'s phase (its weights, its prompt) on the first
    ``GAP_DEPTHS`` layers of the same weights, in float32 and in float64
    (the port's float32 norms and recurrences widen with the input), with
    each float32 run's distance from the float64 one.  Float32 rounding
    leaves a float64 gap near 1e-12 and puts each float32 run about as far
    from the float64 one as from the other; a fault in prefill or decode
    keeps its gap in float64.  Run with ``--prefill-decode-gap``."""
    seed = family_seed(GAP_ARCH) + 1  # run_family's prompt
    cfg32 = dataclasses.replace(get_config(GAP_ARCH), dtype="float32")
    params32 = lm_params(cfg32, dev)[0]
    s = FAMILY_DECODE_LEN[GAP_ARCH]
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg32.vocab, (1, s)))
    rows = []
    for depth in GAP_DEPTHS:
        runs = {}
        for dtype in ("float32", "float64"):
            cfg = dataclasses.replace(cfg32, n_layers=depth, dtype=dtype)
            dt = getattr(torch, dtype)
            params = {key: lm_layers.tree_map(lambda a, blocks=key == "blocks":
                                              (a[:depth] if blocks else a).to(dt), sub)
                      for key, sub in params32.items()}  # fmt: skip
            last, logits, _, decode_s = prefill_and_decode(dev, params, cfg, tokens.to(dev), seed)
            runs[dtype] = (last.double(), logits.double(), decode_s)
            del params
        (p32, d32, _), (p64, d64, _) = runs["float32"], runs["float64"]
        top = [t.argmax().item() for t in (p32, d32, p64)]
        row = dict(layers=depth, gap_float32=(p32 - d32).abs().max().item(),
                   gap_float64=(p64 - d64).abs().max().item(),
                   prefill_float32_from_float64=(p32 - p64).abs().max().item(),
                   decode_float32_from_float64=(d32 - d64).abs().max().item(),
                   max_abs_logit=p64.abs().max().item(),
                   argmax_equal=top[0] == top[1] == top[2],
                   decode_s_float32=runs["float32"][2],
                   decode_s_float64=runs["float64"][2])  # fmt: skip
        print(f"  {GAP_ARCH}, first {depth} layers, {s} tokens: {json.dumps(row)}")
        rows.append(row)
    return rows


def nbytes(tensors: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def run_ring_decode(dev, params32: dict, params16: dict, flat: dict, steps: int = 24) -> dict:
    """The grouped ring cache (``ring_local_cache=True``) on the 12-layer
    gemma3-27b: float32 teacher-forced decode of ``flat``'s ``DECODE_LEN``
    tokens, past the 1024-slot rings of the local layers (so each wraps),
    whose last logits must be within ``PREFILL_DECODE_ATOL`` of the same
    prompt's prefill (``flat['last']``); then the cache's bytes with and
    without the rings at B = 4 and S = 8192 (bf16), and the bf16 decode
    step at that size both ways, ``steps`` steps each, the first 4 left out."""
    cfg = dataclasses.replace(lm_config("float32"), ring_local_cache=True)
    tokens, last = flat["tokens"], flat["last"]
    s = tokens.shape[1]
    cache = transformer.init_cache(cfg, 1, s, torch.float32, dev)
    if "lk" not in cache or cache["lk"].shape[3] != cfg.local_window or cfg.local_window >= s:
        raise AssertionError(f"no ring that wraps: {({k: t.shape for k, t in cache.items()})}")
    slots = cfg.local_window
    step = make_serve_step(cfg)
    sync(dev)
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = step(params32, tokens[:, t : t + 1], cache, t)
    sync(dev)
    decode_s = time.perf_counter() - t0
    err = (logits - last).abs().max().item()
    same = bool(logits.argmax() == last.argmax())
    oldest = int(cache["lkp"].min().item())  # the rings hold positions s - slots .. s - 1
    wraps = oldest == s - slots
    print(f"  ring cache, {s} decode steps through {slots}-slot rings (oldest position kept "
          f"{oldest}): last logits against the prefill's max_abs_err "
          f"{err}, argmax equal {same}, decode {decode_s:.3f} s")  # fmt: skip
    if not (err <= PREFILL_DECODE_ATOL and same and wraps):
        raise AssertionError(f"ring-cache decode differs from prefill: {err}, {same}, {wraps}")

    b, max_len = 4, 8192
    half = lm_config("bfloat16")
    sizes = {name: nbytes(transformer.cache_specs(c, b, max_len, torch.bfloat16))
             for name, c in (("ring", cfg), ("flat", half))}  # fmt: skip
    ms = {}
    rng = np.random.default_rng(SEED + 8)
    for name, c in (("ring", dataclasses.replace(half, ring_local_cache=True)), ("flat", half)):
        cache = transformer.init_cache(c, b, max_len, torch.bfloat16, dev)
        step = make_serve_step(c)
        step_s = []
        for t in range(steps):
            tok = torch.from_numpy(rng.integers(0, c.vocab, (b, 1))).to(dev)
            t0 = time.perf_counter()
            step(params16, tok, cache, t)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
        ms[name] = percentiles(step_s[4:])
        del cache
    print(f"  B={b}, S={max_len}, bf16: cache {sizes['ring'] / 1e9:.3f} GB with the rings, "
          f"{sizes['flat'] / 1e9:.3f} GB without ({sizes['flat'] / sizes['ring']:.2f}x); decode "
          f"step p50 {ms['ring'][0]:.3f} ms with the rings, {ms['flat'][0]:.3f} ms "
          f"without")  # fmt: skip
    return dict(decode_steps=s, ring_slots=slots, max_abs_err=err, argmax_equal=same,
                decode_s=decode_s, cache_bytes_ring=sizes["ring"], cache_bytes_flat=sizes["flat"],
                batch=b, max_len=max_len, step_ms_p50_ring=ms["ring"][0],
                step_ms_p99_ring=ms["ring"][1], step_ms_p50_flat=ms["flat"][0],
                step_ms_p99_flat=ms["flat"][1])  # fmt: skip


def run_lm_serving(dev, params: dict, cfg, longest: int = 512) -> dict:
    """``ServeLoop`` at batch 4 on 8 requests of 64-``longest`` prompt
    tokens and 16 new ones; again on the same requests; the two shortest
    alone."""
    rng = np.random.default_rng(SEED + 6)
    lens = rng.integers(64, longest + 1, 8)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(np.int32), max_new=16)
            for i, n in enumerate(lens)]  # fmt: skip
    batch, max_len = 4, int(lens.max()) + 16

    def loop():
        return ServeLoop(cfg, params, batch_size=batch, max_len=max_len, device=dev)

    first, step_s = loop(), []
    decode = first._decode

    def timed(*args):
        t0 = time.perf_counter()
        out = decode(*args)
        sync(dev)
        step_s.append(time.perf_counter() - t0)
        return out

    first._decode = timed
    t0 = time.perf_counter()
    out = first.run(reqs)
    wall = time.perf_counter() - t0
    again = loop().run(reqs)
    solo = {r.rid: loop().run([r])[r.rid] for r in sorted(reqs, key=lambda r: len(r.prompt))[:2]}
    tokens = sum(len(g) for g in out.values())
    print(f"  {len(reqs)} requests, prompt lengths {lens.tolist()}: {tokens} tokens in "
          f"{first.steps} decode steps; again alike: {again == out}; requests {sorted(solo)} "
          f"alone as in the batch: {all(out[i] == g for i, g in solo.items())}")  # fmt: skip
    if sorted(out) != list(range(len(reqs))) or any(len(g) != 16 for g in out.values()):
        raise AssertionError("a request did not get its 16 tokens")
    if again != out or any(out[i] != g for i, g in solo.items()):
        raise AssertionError("ServeLoop is not deterministic, or a request alone differs")
    p50, p99 = percentiles(step_s)
    return dict(requests=len(reqs), generated_tokens=tokens, wall_s=wall, decode_steps=first.steps,
                generated_tokens_per_s=tokens / wall, decode_step_ms_p50=p50,
                decode_step_ms_p99=p99, batch=batch, max_len=max_len)  # fmt: skip


# ---------------------------------------------------------------------------
# the other families at full width and full depth: griffin (recurrentgemma-2b),
# rwkv6-3b and whisper-base
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("recurrentgemma-2b", "rwkv6-3b", "whisper-base")
FAMILY_PREFILL = {  # arch -> B, S of the bf16 prefill, and its timed calls
    "recurrentgemma-2b": (2, 4096, 5),  # S past the 2048-token window, so the window masks
    "rwkv6-3b": (2, 2048, 3),  # its WKV loop takes seconds a call
    "whisper-base": (4, 448, 5),  # Whisper's text context (n_text_ctx) over 1500 frames
}
# the float32 prefill-against-decode prompt: whisper's whole text context
FAMILY_DECODE_LEN = {"recurrentgemma-2b": 512, "rwkv6-3b": 512, "whisper-base": 448}
# ServeLoop's longest prompt, 128, where gemma3's is 512: a decode step's
# work does not grow with the context in rwkv6 (its state) and hardly in
# griffin (its ring of min(max_len, 2048) slots), whisper's prompts are a few
# task tokens and some previous text, and 64-128-token prompts take about a
# third of the host-bound steps (the run's time)
FAMILY_LONGEST = 128


def family_seed(arch: str) -> int:
    """``run_family``'s seed for ``arch``: its weights' prompts and frames."""
    return SEED + 20 + 10 * FAMILY_ARCHS.index(arch)


def time_wkv(dev, step, params: dict, batch: dict) -> dict:
    """An rwkv6 prefill call (the warm-up call) with each layer's WKV loop
    (``rwkv6._wkv_scan``, a Python loop over T of float32 ops) between CUDA
    events: the loop's milliseconds a layer, and all loops' share of the
    call (host clock, synchronised)."""
    scan, events = rwkv6._wkv_scan, []

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*args)
        end.record()
        events.append((start, end))
        return out

    rwkv6._wkv_scan = timed
    try:
        t0 = time.perf_counter()
        step(params, batch)
        sync(dev)
        call_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rwkv6._wkv_scan = scan
    ms = [start.elapsed_time(end) for start, end in events]
    print(f"  WKV loop: {len(ms)} layers, {np.mean(ms):.3f} ms a layer (CUDA events), "
          f"{sum(ms):.3f} ms of a {call_ms:.3f} ms call: {sum(ms) / call_ms:.4f}")  # fmt: skip
    return dict(wkv_layers=len(ms), wkv_ms_per_layer=float(np.mean(ms)), wkv_ms=sum(ms),
                wkv_call_ms=call_ms, wkv_share=sum(ms) / call_ms)  # fmt: skip


def run_family_prefill(dev, cfg, params: dict, b: int, s: int, calls: int, seed: int) -> dict:
    """``make_prefill_step`` of ``cfg`` (bf16) on ``b`` prompts of ``s``
    tokens (whisper's over seeded frames): a warm-up call, then ``calls``
    timed calls with the launch counts set to 0 just before them (K9
    ``registry.attention_calls`` times a call, the plain attention never);
    where K9 runs, one call on K9's plain version, whose last logits must be within
    ``PREFILL_BF16_ATOL``: the attention's bf16 roundings differ, and each
    difference rides the residual stream and, in griffin, the RG-LRU's
    recurrence (a decay below 1, so it is carried, not grown) through the
    later layers, as through gemma3's 12 layers (0.0039 on an H100, two
    bf16 steps at 0.5).  rwkv6 runs no kernel: its logits must be finite, and
    its warm-up call times its WKV loops (``time_wkv``)."""
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)))
    batch = model_batch(cfg, tokens.to(dev), seed)
    step = make_prefill_step(cfg)
    wkv = {}
    if cfg.family == "ssm":
        wkv = time_wkv(dev, step, params, batch)  # the warm-up call, its WKV loops timed
    else:
        step(params, batch)  # the warm-up call
    sync(dev)
    n_k9 = lm_registry.attention_calls(cfg)
    last, cache, call_s, launches, peak_gb = timed_prefill(dev, step, params, batch, n_k9, calls)
    if tuple(last.shape) != (b, cfg.vocab):
        raise AssertionError(f"{cfg.name} prefill logits of shape {tuple(last.shape)}")
    p50, _ = percentiles(call_s)
    out = dict(launches=launches, call_s=call_s, batch=b, prompt_tokens=s, prefill_ms_p50=p50,
               tokens_per_s=b * s / (p50 / 1e3), max_memory_allocated_gb=peak_gb,
               cache={key: list(t.shape) for key, t in cache.items()})  # fmt: skip
    if cfg.family == "encdec":
        out["frames_per_s"] = b * cfg.src_len / (p50 / 1e3)
    del cache
    said = f"  K9 launches {launches['K9']} in {calls} calls, plain attention calls 0; last logits"
    if n_k9:
        ref_last = plain_prefill(step, params, batch, n_k9)
        err = (last.float() - ref_last.float()).abs().max().item()
        same = (last.argmax(-1) == ref_last.argmax(-1)).tolist()
        print(f"{said} against the plain attention's: max_abs_err {err} (|logit| up to "
              f"{ref_last.float().abs().max().item()}), argmax equal {same}")  # fmt: skip
        if err > PREFILL_BF16_ATOL:
            raise AssertionError(f"{cfg.name} prefill on K9 differs from its plain version: {err}")
        out.update(max_abs_err=err, argmax_equal=same)
    else:
        print(f"{said} finite, |logit| up to {last.float().abs().max().item()}")
    print(f"  prefill p50 {p50:.3f} ms, {out['tokens_per_s']:.1f} prompt tokens/s, peak memory "
          f"{peak_gb:.3f} GB")  # fmt: skip
    return dict(out, **wkv)


def run_family(dev, arch: str, seed: int) -> dict:
    """One family at its full width and depth on random weights (``lm_params``):
    the bf16 prefill (``run_family_prefill``), the float32 prefill against
    teacher-forced decode, and ``ServeLoop`` in bf16; each phase's weights
    freed before the next phase."""
    cfg32, cfg16 = (dataclasses.replace(get_config(arch), dtype=d) for d in ("float32", "bfloat16"))
    print(f"{arch} weights: full width, all {cfg32.n_layers} layers"
          f"{f' and {cfg32.n_enc_layers} encoder layers' if cfg32.n_enc_layers else ''}, random "
          f"from a seeded generator on the card, float32 and bfloat16")  # fmt: skip
    params32, params16 = lm_params(cfg32, dev)
    n = sum(t.numel() for t in lm_layers.tree_leaves(params16))
    print(f"  {n} params: {4 * n / 1e9:.2f} GB in float32, {2 * n / 1e9:.2f} GB in bf16")
    b, s, calls = FAMILY_PREFILL[arch]
    frames = f" over {cfg16.src_len} seeded frames" if cfg16.family == "encdec" else ""
    print(f"{arch} prefill path: make_prefill_step on {b} prompts of {s} tokens{frames}, "
          f"bfloat16")  # fmt: skip
    pre = run_family_prefill(dev, cfg16, params16, b, s, calls, seed)
    if lm_registry.attention_calls(cfg16):
        require_launched(f"{arch} prefill path", pre["launches"], ["K9"])
    s = FAMILY_DECODE_LEN[arch]
    print(f"{arch} prefill against decode: float32, 1 prompt of {s} tokens{frames}, TF32 off")
    dec = run_prefill_against_decode(dev, params32, cfg32, s, seed + 1)
    del params32, dec["tokens"], dec["last"]
    print(f"{arch} serving: ServeLoop(batch_size=4), bfloat16"
          f"{', zero cross caches (ServeLoop takes no frames)' if frames else ''}")  # fmt: skip
    serve = run_lm_serving(dev, params16, cfg16, FAMILY_LONGEST)
    del params16
    torch.cuda.empty_cache()
    left = memory_left(dev, f"after {arch}'s weights are freed")
    return dict(params=n, prefill=pre, decode=dec, serving=serve, memory_left=left)


def memory_left(dev, where: str) -> int:
    """Prints and returns the bytes still allocated on ``dev`` ``where``."""
    allocated = torch.cuda.memory_allocated(dev)
    print(f"  memory allocated {where}: {allocated / 1e9:.3f} GB")
    return allocated


# ---------------------------------------------------------------------------
# training: launch/train.py's path, quorum-committed steps, checkpoints
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 8  # qwen3-4b's depth cut from 36 layers; every width is the published one
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_STRAGGLERS = 4, 2048, 10, 0.3
# card against CPU, reduced qwen3-4b in float32, 3 steps of AdamW at lr 1e-3:
# loss and grad_norm within 1e-4 relative (K9's float32 tolerance carried
# through the layers); params within 1e-4, a tenth of one step's size, so a
# wrong update of any leaf shows (5.79e-6 measured on an H100 at 700 W)
TRAIN_PARITY_RTOL = 1e-4
TRAIN_PARITY_PARAMS_ATOL = 1e-4
TRAIN_PARITY_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# one step's gradients through K9 and its backward pass against autograd
# through the chunked softmax on the card, relative to each leaf's largest
# entry (tests/test_torch_cuda.py's)
MODEL_GRAD_RTOL = 1e-4
# a resumed run against the uninterrupted one, the same steps on the same
# card: equal unless an accumulation on the card runs in another order
RESUME_ATOL = 1e-5


def train_config():
    return dataclasses.replace(get_config("qwen3-4b"), n_layers=TRAIN_LAYERS)


def train_paxos(dev) -> PaxosContext:
    """``launch/train.py``'s consensus context: the staged path (K3, K2)."""
    return PaxosContext(PaxosConfig(n_acceptors=3, n_instances=4096, batch=16), device=dev)


def step_records(log) -> list[tuple[int, int]]:
    """(step, digest) of every ``step:`` record of a delivered log, in order."""
    return [(int.from_bytes(p[5:9], "little"), int.from_bytes(p[9:13], "little", signed=True))
            for _, p in log if p.startswith(b"step:")]  # fmt: skip


class ChunkedAttention:
    """While entered, the models' attention on the card runs the chunked
    softmax (``models.layers._chunked_attention``) under autograd instead of
    ``K9Attention``: K9's forward and its backward pass both replaced by an
    independent autograd route (a hook of this script, not a path of the
    port).  Counts its calls."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self._router = lm_layers.flash_attention

        def chunked(q, k, v, *, causal=True, window=0, q_offset=0, k_positions=None,
                    chunk_q=512, chunk_k=512, softmax_scale=None):  # fmt: skip
            self.calls += 1
            scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
            return lm_layers._chunked_attention(q, k, v, causal, int(window), int(q_offset),
                                                k_positions, chunk_q, chunk_k, scale)  # fmt: skip

        lm_layers.flash_attention = chunked
        return self

    def __exit__(self, *exc):
        lm_layers.flash_attention = self._router


class RecordedSteps:
    """A train step that records each step's digest and host time (the
    digest's read-back synchronises the device)."""

    def __init__(self, step, dev):
        self.step, self.dev, self.digests, self.step_s = step, dev, [], []

    def __call__(self, state, batch):
        t0 = time.perf_counter()
        state, metrics = self.step(state, batch)
        self.digests.append(int(metrics["digest"]))
        sync(self.dev)
        self.step_s.append(time.perf_counter() - t0)
        return state, metrics


def batches(stream, start: int, dev):
    for i in itertools.count(start):
        yield {k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(i).items()}


def time_training_attention(dev) -> dict:
    """One layer's attention at the training shape (B=4, H=32, KVH=8,
    S=2048, D=128, bf16, causal): K9's forward on views of the models'
    layout in a CUDA graph, and the backward pass (``attention_vjp``, the
    chunked softmax recomputed in PyTorch ops) by CUDA events, median of 3."""
    b, h, kvh, s, d = TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 93)
    qh, kh, vh = k9_inputs(gen, b, h, kvh, s, s, d, torch.bfloat16, dev, views=True)
    k9_ms = time_walk(lambda i: k_flash.flash_attention(qh, kh, vh), 20, True)
    q = qh.permute(0, 2, 1, 3).reshape(b, s, kvh, h // kvh, d)
    k, v = kh.permute(0, 2, 1, 3), vh.permute(0, 2, 1, 3)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    vjp = []
    for _ in range(4):
        start.record()
        k_flash.attention_vjp(q, k, v, dout, True, 0, d**-0.5)
        end.record()
        torch.cuda.synchronize()
        vjp.append(start.elapsed_time(end))
    return dict(k9_ms=k9_ms, vjp_ms=float(np.median(vjp[1:])))


def run_training_full_width(dev) -> dict:
    """``launch/train.py``'s path at qwen3-4b's full width, 8 layers, bf16:
    ``init_state``, ``make_train_step`` and ``run_loop`` with the staged
    context, 10 steps of 4 x 2048 tokens from the uniform stream, stragglers
    at 0.3; launches counted from 0."""
    cfg = train_config()
    print(f"  {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} kv heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"depth cut from {get_config('qwen3-4b').n_layers} to {cfg.n_layers} layers, "
          f"{lm_registry.count_params(cfg) / 1e9:.3f} G params in {cfg.dtype}, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}")  # fmt: skip
    torch.cuda.reset_peak_memory_stats(dev)
    state = train_loop.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ, seed=SEED))  # fmt: skip
    ctx = train_paxos(dev)
    step = RecordedSteps(train_loop.make_train_step(cfg, OptConfig(total_steps=TRAIN_STEPS)), dev)
    loop = LoopConfig(steps=TRAIN_STEPS, straggler_prob=TRAIN_STRAGGLERS)
    reset_launches()
    with PlainCalls() as plain_votes, PlainAttention() as plain_attention:
        state, hist = run_loop(cfg, state, iter(stream), loop=loop, train_step=step,
                               paxos_ctx=ctx, rng_seed=SEED)  # fmt: skip
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = hist["loss"]
    # the draws themselves are held against the reference's run_loop in
    # tests/test_torch_train.py; here each step commits by the 2-of-3 quorum
    # rule, and exactly the committed steps reach the log with their digests
    quorum = [3 - s >= 2 for s in hist["straggled"]]
    want = [(i + 1, step.digests[i]) for i, c in enumerate(hist["committed"]) if c]
    got = step_records(ctx.delivered_log)
    print(f"  losses {losses}; committed {hist['committed']}, straggled {hist['straggled']}; "
          f"step records {got}")  # fmt: skip
    print(f"  launches: {launches}, plain Phase-2 votes {plain_votes.calls}, plain attention "
          f"calls {plain_attention.calls}")  # fmt: skip
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - math.log(cfg.vocab)) > 0.5:
        raise AssertionError(f"training losses {losses}: not finite, or the first not within "
                             f"0.5 of ln({cfg.vocab}) = {math.log(cfg.vocab)}")  # fmt: skip
    if hist["committed"] != quorum or len(quorum) != TRAIN_STEPS or not 0 < sum(quorum):
        raise AssertionError(f"committed {hist['committed']} does not follow the quorum rule "
                             f"on straggled {hist['straggled']}")  # fmt: skip
    if got != want:
        raise AssertionError(f"the delivered step records {got} are not the committed "
                             f"steps' {want}")  # fmt: skip
    require_launched("training path", launches, ["K9", "coordinator_sequence",
                                                 "acceptor_vote_all"])  # fmt: skip
    if launches["K9"] < cfg.n_layers * TRAIN_STEPS or plain_votes.calls or plain_attention.calls:
        raise AssertionError(f"the training path did not attend through K9 in every layer or "
                             f"voted on the plain engine: {launches}")  # fmt: skip
    del state
    torch.cuda.empty_cache()
    p50, p99 = percentiles(step.step_s[1:])  # the first step builds the cuBLAS plans
    att = time_training_attention(dev)
    k9_per_step = launches["K9"] / TRAIN_STEPS
    print(f"  step p50 {p50:.3f} ms (first step {step.step_s[0] * 1e3:.3f} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3):.1f} tokens/s, peak memory {peak / 1e9:.3f} GB; "
          f"K9 {att['k9_ms']:.5f} ms a launch x {k9_per_step:g} a step = "
          f"{100 * k9_per_step * att['k9_ms'] / p50:.2f}% of a step; the attention's backward "
          f"pass {att['vjp_ms']:.3f} ms a layer = "
          f"{100 * cfg.n_layers * att['vjp_ms'] / p50:.1f}%")  # fmt: skip
    return dict(
        layers=cfg.n_layers, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        first_step_ms=step.step_s[0] * 1e3, step_ms_p50=p50, step_ms_p99=p99,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3), max_memory_allocated_gb=peak / 1e9,
        losses=losses, committed=sum(hist["committed"]), straggled=sum(hist["straggled"]),
        digests=step.digests, k9_launches_per_step=k9_per_step,
        k9_ms=att["k9_ms"], k9_share=k9_per_step * att["k9_ms"] / p50,
        attention_vjp_ms=att["vjp_ms"], attention_vjp_share=cfg.n_layers * att["vjp_ms"] / p50,
        launches={name: n for name, n in launches.items() if n},
    )  # fmt: skip


def run_training_parity(dev) -> dict:
    """The reduced qwen3-4b in float32: three steps on the card against the
    same three steps on the CPU from the same state (``models.convert``'s
    carry-over), then one step's gradients through ``K9Attention`` (K9 and
    ``attention_vjp``) against autograd through the chunked softmax on the
    card."""
    cfg = get_config("qwen3-4b").reduced()
    start = state_to_numpy(train_loop.init_state(cfg, torch.Generator().manual_seed(SEED)))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=64, seed=SEED))
    runs = {}
    for d in (dev, torch.device("cpu")):
        state, metrics = state_from_numpy(start, d), []
        step = train_loop.make_train_step(cfg, OptConfig(**TRAIN_PARITY_OPT))
        before = k_flash.launches
        for batch in itertools.islice(batches(stream, 0, d), 3):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["digest"])))
        runs[d.type] = (state, metrics, k_flash.launches - before)
    (card, got, k9), (cpu, want, k9_cpu) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for g, w in zip(got, want) for a, b in zip(g[:2], w[:2]))
    pairs = zip(lm_layers.tree_leaves(card.params), lm_layers.tree_leaves(cpu.params))
    param_err = max((a.cpu() - b).abs().max().item() for a, b in pairs)
    print(f"  reduced qwen3-4b, 3 steps, card against CPU: (loss, grad_norm, digest) "
          f"{got} against {want}; largest relative difference {rel}, params max_abs_err "
          f"{param_err}; K9 launches {k9} on the card, {k9_cpu} on the CPU")  # fmt: skip
    if rel > TRAIN_PARITY_RTOL or param_err > TRAIN_PARITY_PARAMS_ATOL or not k9 or k9_cpu:
        raise AssertionError("the reduced training steps differ between the card and the CPU")

    vg = train_loop.value_and_grad(train_loop.make_loss_fn(cfg))
    params, batch = state_from_numpy(start, dev).params, next(batches(stream, 3, dev))
    before = k_flash.launches
    loss, grads = vg(params, batch)
    if k_flash.launches == before:
        raise AssertionError("the gradient step did not launch K9")
    launched = k_flash.launches
    with ChunkedAttention() as plain:
        plain_loss, plain_grads = vg(params, batch)
    if not plain.calls or k_flash.launches != launched:
        raise AssertionError("the comparison step did not run the chunked attention alone")
    grad_err = 0.0
    for a, b in zip(lm_layers.tree_leaves(grads), lm_layers.tree_leaves(plain_grads)):
        grad_err = max(grad_err, (a - b).abs().max().item() / b.abs().max().item())
    attn = grads["blocks"]["attn"]
    reached = {n: [bool(attn[n][i].abs().max() > 0) for i in range(cfg.n_layers)]
               for n in ("wq", "wk", "wv")}  # fmt: skip
    print(f"  one step's gradients through K9Attention (K9, attention_vjp) against autograd "
          f"through the chunked attention on the card: loss "
          f"{float(loss)} and {float(plain_loss)}, largest difference {grad_err} of a leaf's "
          f"largest entry; non-zero wq, wk, wv gradient in every layer: {reached}")  # fmt: skip
    if grad_err > MODEL_GRAD_RTOL or not all(map(all, reached.values())):
        raise AssertionError("the gradients through K9Attention differ from the chunked "
                             "attention's")
    return dict(on_card=got, on_cpu=want, max_rel=rel, params_max_abs_err=param_err,
                grad_max_rel=grad_err)  # fmt: skip


def run_training_convergence() -> dict:
    """``examples/torch_train_100m.py`` at its defaults on the card: 30 steps
    of qwen3-100m on the arith stream with the fused context (K1 at G=1),
    its own asserts (the loss falls, every step commits, the committed
    checkpoint restores, the log survives a failover)."""
    path = Path(__file__).resolve().parent / "examples" / "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    reset_launches()
    t0 = time.perf_counter()
    hist = example.main(["--steps", "30"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"  launches: {launches}; losses {hist['loss']}")
    require_launched("training example", launches, ["K9", "wirepath_round"])
    return dict(wall_s=wall, first_loss=hist["loss"][0], last_loss=hist["loss"][-1],
                launches={name: n for name, n in launches.items() if n})  # fmt: skip


def run_training_checkpoints(dev) -> dict:
    """Reduced qwen3-4b on the card with the staged context: a checkpoint at
    step 3 committed through consensus, restored bit for bit, resumed to
    step 6 with the uninterrupted run's losses; with acceptors 0 and 1
    killed, a save stays invisible to ``latest_committed``."""
    cfg = get_config("qwen3-4b").reduced()
    start = state_to_numpy(train_loop.init_state(cfg, torch.Generator().manual_seed(SEED + 1)))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=64, seed=SEED))
    step = train_loop.make_train_step(cfg, OptConfig(**TRAIN_PARITY_OPT))
    _, whole = run_loop(cfg, state_from_numpy(start, dev), iter(stream),
                        loop=LoopConfig(steps=6), train_step=step)  # fmt: skip
    ctx = train_paxos(dev)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, paxos_ctx=ctx)
        state, first = run_loop(cfg, state_from_numpy(start, dev), iter(stream),
                                loop=LoopConfig(steps=3, checkpoint_every=3), train_step=step,
                                paxos_ctx=ctx, checkpoint_mgr=mgr)  # fmt: skip
        path = mgr.latest_committed()
        record = [p for _, p in ctx.delivered_log if p.startswith(b"ckpt:3:")]
        if path is None or not Path(path, "COMMITTED").exists() or len(record) != 1:
            raise AssertionError(f"the step-3 checkpoint did not commit: {path}, {record}")
        restored, at = mgr.restore(state_from_numpy(start, dev))
        same = at == 3 and all(
            a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(lm_layers.tree_leaves(restored), lm_layers.tree_leaves(state))
        )  # fmt: skip
        rest = (stream.batch_at(i) for i in itertools.count(3))
        _, resumed = run_loop(cfg, restored, rest, loop=LoopConfig(steps=3), train_step=step)
    losses = first["loss"] + resumed["loss"]
    resume_err = max(abs(a - b) for a, b in zip(losses, whole["loss"]))
    dead = train_paxos(dev)
    dead.hw.kill_acceptor(0)
    dead.hw.kill_acceptor(1)
    with tempfile.TemporaryDirectory() as d:
        orphan = CheckpointManager(d, paxos_ctx=dead)
        orphan.save(state, step=1)
        invisible = orphan.latest_committed() is None and Path(d, "step_00000001").exists()
    print(f"  checkpoint at step 3: {Path(path).name} committed ({record[0].decode()}); restored "
          f"bit for bit: {same}; resumed losses {resumed['loss']} against the uninterrupted "
          f"{whole['loss'][3:]} (max difference {resume_err}); with acceptors 0 and 1 killed "
          f"the save is invisible: {invisible}")  # fmt: skip
    if not same or resume_err > RESUME_ATOL or not invisible:
        raise AssertionError("checkpoint commit, restore, resume or invisibility failed")
    return dict(resume_max_abs_err=resume_err)


MESH_STEPS = 4  # the first warms up; the p50 step time is over the others
MESH_GAP = 1e-3  # the meshed losses' largest relative gap from the unmeshed ones


def run_mesh(dev) -> dict:
    """``launch/``'s path on the card: ``MESH_STEPS`` train steps of qwen3-4b
    at the training phase's width and depth on ``make_host_mesh()``, a (1, 1)
    ``(data, model)`` mesh over NCCL in a world of one, the state and each
    batch placed as DTensors by ``BASE_RULES`` and the activation sharder
    installed, against the same steps unmeshed from the same state and
    batches, each side's steps timed alone (the card synchronised around
    each, the host's clock; the p50 over the steps after the first); then
    ``launch.dryrun``'s qwen3-4b ``train_4k`` cell on the (16, 16)
    production mesh, a subprocess on a fake group of 256 ranks (it never
    meets the NCCL group)."""
    import torch.distributed as dist

    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    cfg = train_config()
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ, seed=SEED))  # fmt: skip
    opt = OptConfig(total_steps=TRAIN_STEPS)

    def steps(place=lambda t: t, place_batch=lambda b: b):
        state = place(train_loop.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED)))
        step, out, ms = train_loop.make_train_step(cfg, opt), [], []
        for batch in itertools.islice(batches(stream, 0, dev), MESH_STEPS):
            batch = place_batch(batch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            out.append((float(m["loss"]), int(m["digest"])))
        return out, ms

    unmeshed, unmeshed_ms = steps()
    gc.collect()
    torch.cuda.empty_cache()
    owned = not dist.is_initialized()
    mesh = make_host_mesh(device=dev)
    rules = sh.BASE_RULES
    state_sh = sh.tree_shardings(train_loop.state_shapes(cfg), train_loop.state_axes(cfg), rules,
                                 mesh)  # fmt: skip
    shape = ShapeConfig("mesh", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch_sh = sh.batch_shardings(lm_registry.input_specs(cfg, shape), cfg, rules, mesh)
    sh.calls = 0
    reset_launches()
    with sh.use_rules(mesh, rules):
        meshed, meshed_ms = steps(
            lambda s: sh.place_tree(s, state_sh),
            lambda b: {k: batch_sh[k].place(v) for k, v in b.items()},
        )
    launches, calls = read_launches(), sh.calls
    if owned:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    gap = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(meshed, unmeshed, strict=True))
    step_s = time.perf_counter() - t0
    p50 = {"meshed": float(np.median(meshed_ms[1:])), "unmeshed": float(np.median(unmeshed_ms[1:]))}
    print(f"  {cfg.name}, {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{MESH_STEPS} steps on a {tuple(mesh.shape)} {mesh.mesh_dim_names} mesh over "
          f"{mesh.device_type}: (loss, digest) meshed {meshed}, unmeshed {unmeshed}; largest "
          f"relative loss gap {gap}; shard calls {calls}; launches {launches}; step ms meshed "
          f"{meshed_ms}, unmeshed {unmeshed_ms}; p50 after the first {p50}")  # fmt: skip
    if gap >= MESH_GAP or not calls or not launches["K9"]:
        raise AssertionError(f"the meshed steps' loss gap {gap} is not under {MESH_GAP}, or the "
                             f"sharder ({calls}) or K9 ({launches['K9']}) never ran")  # fmt: skip

    t1 = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b", "--shape",
               "train_4k", "--mesh", "single", "--out", d]  # fmt: skip
        out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
        print("  " + "\n  ".join(out.stdout.strip().splitlines()))
        files = list(Path(d).glob("*.json"))
        rec = json.loads(files[0].read_text()) if files else {}
    dry_s = time.perf_counter() - t1
    print(f"  dry run record: {json.dumps({k: v for k, v in rec.items() if k != 'traceback'})}")
    if out.returncode or rec.get("ok") is not True:
        raise AssertionError(f"the dry run failed (exit {out.returncode}): "
                             f"{rec.get('traceback', out.stderr[-3000:])}")  # fmt: skip
    return dict(layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_STEPS,
                mesh=list(mesh.shape), meshed=meshed, unmeshed=unmeshed, loss_gap=gap,
                shard_calls=calls, k9_launches=launches["K9"], steps_s=step_s,
                meshed_step_ms=meshed_ms, unmeshed_step_ms=unmeshed_ms,
                meshed_p50_ms=p50["meshed"], unmeshed_p50_ms=p50["unmeshed"], dryrun_s=dry_s,
                dryrun=rec)  # fmt: skip


def run_training(dev) -> dict:
    print("training path: launch/train.py's path, qwen3-4b, PaxosContext(PaxosConfig("
          "n_acceptors=3, n_instances=4096, batch=16)), staged")  # fmt: skip
    full = run_training_full_width(dev)
    print("training, card against CPU: reduced qwen3-4b, float32, TF32 off")
    parity = run_training_parity(dev)
    print("training convergence: examples/torch_train_100m.py --steps 30, fused context")
    convergence = run_training_convergence()
    print("training checkpoints: reduced qwen3-4b on the card")
    checkpoints = run_training_checkpoints(dev)
    return dict(full=full, parity=parity, convergence=convergence, checkpoints=checkpoints)


def roofline_line(cfg, kind: str, b: int, s: int, p50_ms: float) -> dict:
    """A model phase's roofline on one card beside its measured p50:
    ``analytic_terms`` of ``cfg`` (the phase's own cut config) at ``b``
    sequences of ``s`` tokens (a decode step's context: its cache's
    length) on ``MeshInfo(1, 1, 1, 1)``, fed into ``Roofline``.
    ``bound_share`` is ``t_bound`` over the p50, ``mfu`` the model FLOPs
    over the p50 at the bf16 peak.  Beside the reference's approximate
    parameter counts (``n_params``, ``n_active_params``, which the terms
    use), the count of the port's own leaves (``registry.count_params``)."""
    one_card = MeshInfo(chips=1, dp=1, fsdp=1, tp=1)
    terms = analytic_terms(cfg, ShapeConfig(kind, s, b, kind), one_card)
    roof = Roofline(cfg.name, kind, "1 card", 1, terms["flops"], terms["hbm_bytes"], 0.0,
                    terms["model_flops"])  # fmt: skip
    return dict(
        card=CARD, arch=cfg.name, layers=cfg.n_layers, kind=kind, batch=b, seq=s,
        t_compute_ms=roof.t_compute * 1e3, t_memory_ms=roof.t_memory * 1e3,
        t_collective_ms=roof.t_collective * 1e3, dominant=roof.dominant,
        t_bound_ms=roof.t_bound * 1e3, p50_ms=p50_ms, bound_share=roof.t_bound * 1e3 / p50_ms,
        mfu=roof.model_flops / (p50_ms * 1e-3 * PEAK_FLOPS), flops=roof.flops_dev,
        hbm_bytes=roof.hbm_bytes_dev, model_flops=roof.model_flops,
        useful_ratio=roof.useful_ratio, n_params=cfg.n_params,
        n_active_params=cfg.n_active_params, count_params=lm_registry.count_params(cfg),
    )  # fmt: skip


def rooflines(lm, moe, families, trained, serving, ring) -> dict:
    """``roofline_line`` of every model phase, on the phase's own cut config,
    B and S: the prefills, the training step, and each decode step
    (``ServeLoop``'s at batch 4 on its ``max_len`` cache; gemma3's also
    at B = 4, S = 8192 with and without the ring cache)."""
    lm16, moe16 = lm_config("bfloat16"), moe_config("bfloat16")
    out = {
        f"{LM_ARCH} prefill": roofline_line(lm16, "prefill", K9_PATH[0], K9_PATH[3],
                                            lm["prefill_ms_p50"]),
        f"{MOE_ARCH} prefill": roofline_line(moe16, "prefill", MOE_K9[0], MOE_K9[3],
                                             moe["prefill_ms_p50"]),
    }  # fmt: skip
    for arch, fam in families.items():
        pre = fam["prefill"]
        out[f"{arch} prefill"] = roofline_line(
            get_config(arch), "prefill", pre["batch"], pre["prompt_tokens"], pre["prefill_ms_p50"]
        )
    out["qwen3-4b training step"] = roofline_line(train_config(), "train", TRAIN_BATCH, TRAIN_SEQ,
                                                  trained["step_ms_p50"])  # fmt: skip
    configs = {LM_ARCH: lm16, MOE_ARCH: moe16, **{a: get_config(a) for a in FAMILY_ARCHS}}
    for arch, srv in serving.items():
        out[f"{arch} decode step"] = roofline_line(
            configs[arch], "decode", srv["batch"], srv["max_len"], srv["decode_step_ms_p50"]
        )
    for cache, cfg in (("ring", dataclasses.replace(lm16, ring_local_cache=True)), ("flat", lm16)):
        out[f"{LM_ARCH} decode step, {cache} cache"] = roofline_line(
            cfg, "decode", ring["batch"], ring["max_len"], ring[f"step_ms_p50_{cache}"])
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_walk(call, count: int, graph: bool, restore=lambda: None, reps: int = 5) -> float:
    """Milliseconds per call over ``call(0) .. call(count - 1)``: captured in
    one CUDA graph and replayed between CUDA events (device time, host
    launch cost left out), or issued from the host (launch cost included).
    ``restore()`` resets the state before each timed walk, so every walk
    does the same work.  The median of ``reps`` walks."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for k in range(min(3, count)):
            call(k)
    torch.cuda.current_stream().wait_stream(stream)

    def walk():
        for k in range(count):
            call(k)

    run = walk
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            walk()
        run = g.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        restore()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / count)
    return float(np.median(times))


def time_k1(dev) -> dict:
    """K1 at the main path's shape (A=3, N=65,536, V=16, B=128, reclamation
    on), over one walk of the whole ring: N/B consecutive windows, each with
    its own burst, the state restored before each timed walk, so every
    timed launch serves a new window as the main path does.  The ring holds
    the main path's steady state after a lap: every promise at or below the
    round and every learner slot holding the previous lap's instance, so
    every lane is accepted by all acceptors and is fresh, and each launch
    moves exactly ``k1_bytes`` (checked below from the data)."""
    cfg = PaxosConfig()
    a, n, v, b, q = cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, cfg.quorum
    crnd, walk = 5, n // b
    limit = 2 * n  # the reclaim mark one lap back: every lane may sequence
    rng = np.random.default_rng(SEED + 3)

    def words(*shape):
        return rng.integers(-(2**31), 2**31, shape, dtype=np.int32)

    inst = np.arange(n, 2 * n, dtype=np.int32)  # the walk's instances: the second lap
    host = dict(
        rnd=rng.integers(0, crnd + 1, (a, n), dtype=np.int32),
        vrnd=rng.integers(-1, crnd + 1, (a, n), dtype=np.int32),
        val=words(a, n, v),
        ldel=np.ones(n, np.int32),
        linst=inst - n,
        lval=words(n, v),
    )
    init = {k: torch.from_numpy(np.ascontiguousarray(x)).to(dev) for k, x in host.items()}
    live = {k: x.clone() for k, x in init.items()}
    bursts = torch.from_numpy(words(walk, b, v)).to(dev)
    bases = torch.arange(n, 2 * n, b, dtype=torch.int32, device=dev)
    crnd_t = torch.tensor(crnd, dtype=torch.int32, device=dev)
    alive = torch.ones(a, dtype=torch.bool, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    stack = AcceptorState(live["rnd"], live["vrnd"], live["val"])
    lstate = batched.LearnerState(live["ldel"], live["linst"], live["lval"])

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    def kernel(k):
        k_wirepath.wirepath_round(bases[k], crnd_t, q, alive, *vars(stack).values(),
                                  *vars(lstate).values(), bursts[k], limit)  # fmt: skip

    def plain(k):
        cstate = CoordinatorState(bases[k], crnd_t)
        batched.fused_round(cstate, stack, lstate, bursts[k], active, alive, q, limit)

    accept = (crnd >= host["rnd"]) & (inst < limit)[None]
    fresh = (accept.sum(0) >= q) & ~((host["ldel"] != 0) & (host["linst"] == inst))
    if not (accept.all() and fresh.all()):
        raise AssertionError("the timed walk must accept and deliver every lane")
    nbytes = k1_bytes(a, b, v)
    bms, by = bound_ms(nbytes, k1_operations(a, b, v))
    out = dict(
        ms=time_walk(kernel, walk, True, restore),
        plain_ms=time_walk(plain, walk, True, restore),
        eager_ms=time_walk(kernel, walk, False, restore),
        plain_eager_ms=time_walk(plain, walk, False, restore),
        bound_ms=bms, bound_by=by, bytes_per_launch=nbytes,
        **team_times(kernel, walk, restore, k_wirepath.lane_geometry(v, b, 1, True), dev),
    )  # fmt: skip
    restore()
    return out


def time_launch_floor(geo, walk: int, dev) -> float:
    """``csrc/wirepath.cu``'s empty kernel on ``geo``'s grid (1-, 2- or
    3-D) and block, ``walk`` launches in one CUDA graph, as ``time_walk``
    times each kernel: the floor under a launch of that shape."""
    fn = k_wirepath.launch_floor()
    gx, gy, gz = (*geo.grid, 1, 1)[:3]

    def launch(k):
        _build.check(fn(gx, gy, gz, geo.block, torch.cuda.current_stream(dev).cuda_stream),
                     "launch_floor")  # fmt: skip

    return time_walk(launch, walk, True)


def team_times(kernel, walk: int, restore, geo, dev) -> dict:
    """Beside a team kernel's time at the default block: the launch floor of
    its grid ``geo`` (2-D, or K5's 3-D) and its times at 64, 128 and 256
    threads a block, all in this call."""
    by_threads = {}
    for threads in (64, 128, 256):
        with lane_threads(threads):
            by_threads[threads] = time_walk(kernel, walk, True, restore)
    return dict(
        threads=geo.block, team=geo.team, grid=list(geo.grid),
        floor_ms=time_launch_floor(geo, walk, dev), ms_by_threads=by_threads,
    )  # fmt: skip


L2_FLUSH_BYTES = 128 << 20  # more than twice the card's 50 MB L2


def seal_copies(k: int, v: int, dev, seed: int) -> list[list[torch.Tensor]]:
    """Copies of a seal's leaves (``seal_leaves``), as many as hold
    ``L2_FLUSH_BYTES`` together and at least one: a walk that folds them in
    turn finds each copy gone from L2, which has read more than twice its
    size since, so every launch reads its bytes from HBM."""
    count = max(1, -(-L2_FLUSH_BYTES // (4 * k * (1 + v))))
    return [seal_leaves(k, v, dev, seed + c) for c in range(count)]


def time_seal(copies: list[list[torch.Tensor]], walk: int, dev) -> dict:
    """One seal's fold on K4 (one launch), the floor of K4's grid and
    ``torch.sum`` in int64 over the same bytes (a library reduction, not a
    call that computes the digest), each over a walk of ``walk`` launches,
    or one a copy if there are more copies, in a CUDA graph, each launch on
    the next copy (``seal_copies``); the rate and the share of the bound
    against the bytes, read from HBM."""
    n = len(copies)
    walk = max(walk, n)
    leaves = copies[0]
    words = [x.numel() for x in leaves]
    nbytes = k4_bytes(words)
    for c in copies:
        if c[1].data_ptr() != c[0].data_ptr() + 4 * c[0].numel():
            raise AssertionError("a seal's leaves must lie in one buffer")
    wholes = [c[0].as_strided((sum(x.numel() for x in c),), (1,)) for c in copies]
    geo = seal_geometry(leaves)
    bms, by = bound_ms(nbytes, k4_operations(words))
    out = dict(
        mbytes=nbytes / 2**20, copies=n, grid=geo.grid[0],
        ms=time_walk(lambda k: k_digest.tree_digest(copies[k % n]), walk, True),
        floor_ms=time_launch_floor(geo, walk, dev),
        library_reduction_ms=time_walk(lambda k: torch.sum(wholes[k % n], dtype=torch.int64),
                                       walk, True),
        bound_ms=bms, bound_by=by,
    )  # fmt: skip
    out["gb_per_s"] = nbytes / out["ms"] / 1e6
    out["bound_share"] = bms / out["ms"]
    return out


def time_k4(dev, n_leaf: int) -> dict:
    """The seal of one N/4-instance snapshot, insts (K,) and values (K, V),
    in one buffer: ``time_seal``, K4's plain version over the same copies;
    then, on one copy, eager, host launch cost included, K4 and the seal
    with its read-back.  Then the sweep:
    the same leaf shapes at prefixes of 6.4 MiB (the main path's last seal,
    6N/4 instances), 64 MiB and 256 MiB, beside the N/4 seal's 1.06 MiB."""
    v = 16
    copies = seal_copies(n_leaf, v, dev, SEED + 4)
    leaves, n = copies[0], len(copies)
    out = time_seal(copies, 50, dev)
    sweep = {n_leaf: dict(out)}
    out.update(
        plain_ms=time_walk(lambda k: k_digest.tree_digest_plain(copies[k % n]), max(50, n), True),
        eager_ms=time_walk(lambda _: k_digest.tree_digest(leaves), 50, False),
        seal_ms=time_walk(lambda _: ops.tree_digest(leaves), 50, False),
    )  # fmt: skip
    del copies, leaves
    for k in (6 * n_leaf, (64 << 20) // (4 * (1 + v)), (256 << 20) // (4 * (1 + v))):
        sweep[k] = time_seal(seal_copies(k, v, dev, SEED + k), 20, dev)
        torch.cuda.empty_cache()
    out["sweep"] = sweep
    return out


def time_staged(dev) -> dict:
    """K3, K2, K7 and K8 at the staged and per-role paths' shape (A=3,
    N=65,536, V=16, B=128), each over one walk of the ring: N/B consecutive
    windows of the second lap, each with its own burst, the registers
    restored before each timed walk.  Every promise is at or below the
    round, every acceptor alive and every lane a P2A, so every lane is
    accepted by every acceptor, as on the staged path with all alive, and K8
    sees every lane agreed; each launch moves exactly the bytes counted
    (checked below from the data)."""
    cfg = PaxosConfig()
    a, n, v, b, q = cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, cfg.quorum
    crnd, walk = 5, n // b
    rng = np.random.default_rng(SEED + 11)

    def words(*shape):
        return torch.from_numpy(rng.integers(-(2**31), 2**31, shape, dtype=np.int32)).to(dev)

    host_rnd = rng.integers(0, crnd + 1, (a, n), dtype=np.int32)
    init = dict(
        rnd=torch.from_numpy(host_rnd).to(dev),
        vrnd=torch.from_numpy(rng.integers(-1, crnd + 1, (a, n), dtype=np.int32)).to(dev),
        val=words(a, n, v),
    )
    live = {k: x.clone() for k, x in init.items()}
    stack = AcceptorState(live["rnd"], live["vrnd"], live["val"])
    file0 = AcceptorState(live["rnd"][0], live["vrnd"][0], live["val"][0])  # acceptor 0's file

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    i32 = dict(dtype=torch.int32, device=dev)
    bases = torch.arange(n, 2 * n, b, **i32)
    msgs = [
        MsgBatch(
            msgtype=torch.full((b,), 3, **i32), inst=torch.arange(n + k * b, n + (k + 1) * b, **i32),
            rnd=torch.full((b,), crnd, **i32), vrnd=torch.full((b,), -1, **i32),
            swid=torch.zeros(b, **i32), value=words(b, v),
        )
        for k in range(walk)
    ]  # fmt: skip
    crnd_t = torch.tensor(crnd, **i32)
    alive = torch.ones(a, dtype=torch.bool, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    vote_type = torch.full((walk, a, b), 4, **i32)
    vote_vrnd = torch.full((walk, a, b), crnd, **i32)
    vote_val = words(walk, a, b, v)
    if not (host_rnd <= crnd).all():
        raise AssertionError("the timed walk must accept every lane")

    def vote_args(k):
        m = msgs[k]
        return m.msgtype, m.inst, m.rnd, m.value

    runs = {
        "coordinator_sequence": (
            lambda k: k_coordinator.coordinator_sequence_window(bases[k], crnd_t, active),
            lambda k: batched.coordinator_sequence(
                CoordinatorState(bases[k], crnd_t), msgs[k].value, active),
            k3_bytes(b), k3_operations(b),
        ),
        "acceptor_vote_all": (
            lambda k: k_wirepath.acceptor_vote_all_window(
                *vars(stack).values(), alive, *vote_args(k)),
            lambda k: batched.acceptor_phase2_all(stack, msgs[k], alive),
            k2_bytes(a, b, v), k2_operations(a, b),
        ),
        "acceptor_phase2": (
            lambda k: k_acceptor.acceptor_phase2_window(*vars(file0).values(), 0, *vote_args(k)),
            lambda k: batched.acceptor_phase2(file0, msgs[k], 0),
            k7_bytes(b, v), k7_operations(b),
        ),
        "learner_quorum": (
            lambda k: k_learner.learner_quorum_window(q, vote_type[k], vote_vrnd[k], vote_val[k]),
            lambda k: k_learner.learner_quorum_plain(q, vote_type[k], vote_vrnd[k], vote_val[k]),
            k8_bytes(a, b, v, b), k8_operations(a, b),
        ),
    }  # fmt: skip
    out = {}
    for name, (kernel, plain, nbytes, ops_) in runs.items():
        bms, by = bound_ms(nbytes, ops_)
        out[name] = dict(
            ms=time_walk(kernel, walk, True, restore),
            plain_ms=time_walk(plain, walk, True, restore),
            eager_ms=time_walk(kernel, walk, False, restore),
            bound_ms=bms, bound_by=by, bytes_per_launch=nbytes,
        )  # fmt: skip
    # K3: the floor of its grid
    geo = k_coordinator.sequence_geometry(b)
    out["coordinator_sequence"].update(threads=geo.block, grid=list(geo.grid),
                                       floor_ms=time_launch_floor(geo, walk, dev))  # fmt: skip
    # K2, a team kernel on a (lane blocks, A) grid: its floor and block sizes
    geo = k_wirepath.lane_geometry(v, b, a, True)
    out["acceptor_vote_all"].update(team_times(runs["acceptor_vote_all"][0], walk, restore, geo,
                                               dev))  # fmt: skip
    # K7 and K8, team kernels on one row of lane blocks: their floor and block
    # sizes; K7 also beside its first design (the witness, one thread a lane)
    # on the same windows
    geo = k_wirepath.lane_geometry(v, b, 1, True)
    out["acceptor_phase2"].update(
        first_design_ms=time_walk(lambda k: k_acceptor.acceptor_phase2_witness(
            *vars(file0).values(), 0, *vote_args(k)), walk, True, restore),
        **team_times(runs["acceptor_phase2"][0], walk, restore, geo, dev),
    )  # fmt: skip
    # acceptor 0 rejects every lane, so the first agreeing acceptor is 1: the
    # speculative load of acceptor 0's value is wasted, the bytes the same
    reject0 = vote_type.clone()
    reject0[:, 0] = 7
    deliver, _, value = k_learner.learner_quorum_window(q, reject0[0], vote_vrnd[0], vote_val[0])
    if not (bool(deliver.all()) and torch.equal(value, vote_val[0][1])):
        raise AssertionError("K8's timed walk must deliver acceptor 1's value on every lane")
    # K8 after the same restore as its time above (the restore copies 14 MB,
    # so the walk finds part of its votes gone from L2), and once without it,
    # its votes in L2 as the per-role walk finds the votes K7 has just written
    out["learner_quorum"].update(
        first_agreeing_1_ms=time_walk(lambda k: k_learner.learner_quorum_window(
            q, reject0[k], vote_vrnd[k], vote_val[k]), walk, True, restore),
        votes_in_l2_ms=time_walk(runs["learner_quorum"][0], walk, True),
        **team_times(runs["learner_quorum"][0], walk, restore, geo, dev),
    )  # fmt: skip
    restore()
    return out


def time_table1(dev) -> dict:
    """The port's per-message row of the paper's Table 1, at the shape of the
    reference's ``benchmarks/table1_component_latency.py``: bursts of B =
    512 messages, V = 16, N = 65,536, A = 3, quorum 2.  K3 sequences a
    burst, K7 votes it for one acceptor, K8 takes three acceptors' votes;
    beside them forwarding, one copy of the same batch's bytes (its five
    header fields and its values, B*(5+V)*4 bytes) on the card, as the
    reference's forwarding row moves the batch through an identity.  Each
    over a walk of N/B = 128 bursts of the ring's second lap in a CUDA
    graph, the register file restored before each timed walk, every lane
    accepted and agreed by all; microseconds a message = ms * 1000 / B."""
    a, n, v, b, q = 3, 1 << 16, 16, 512, 2
    crnd, walk = 5, n // b
    rng = np.random.default_rng(SEED + 12)
    i32 = dict(dtype=torch.int32, device=dev)

    def words(*shape):
        return torch.from_numpy(rng.integers(-(2**31), 2**31, shape, dtype=np.int32)).to(dev)

    init = dict(
        rnd=torch.from_numpy(rng.integers(0, crnd + 1, n, dtype=np.int32)).to(dev),
        vrnd=torch.from_numpy(rng.integers(-1, crnd + 1, n, dtype=np.int32)).to(dev),
        val=words(n, v),
    )
    live = {k: x.clone() for k, x in init.items()}
    file0 = AcceptorState(live["rnd"], live["vrnd"], live["val"])

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    bases = torch.arange(n, 2 * n, b, **i32)
    crnd_t = torch.tensor(crnd, **i32)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    # the walk's batches, packed (walk, B, 5 + V): msgtype, inst, rnd, vrnd, swid, value
    packed = torch.empty((walk, b, 5 + v), **i32)
    packed[:, :, 0] = 3
    packed[:, :, 1] = torch.arange(n, 2 * n, **i32).view(walk, b)
    packed[:, :, 2] = crnd
    packed[:, :, 3] = -1
    packed[:, :, 4] = 0
    packed[:, :, 5:] = words(walk, b, v)
    heads = packed[:, :, :5].permute(0, 2, 1).contiguous()  # (walk, 5, B)
    values = packed[:, :, 5:].contiguous()
    forwarded = torch.empty_like(packed[0])
    vote_type = torch.full((walk, a, b), 4, **i32)
    vote_vrnd = torch.full((walk, a, b), crnd, **i32)
    vote_val = words(walk, a, b, v)
    runs = {  # name: (call, bytes, operations)
        "forwarding": (lambda k: forwarded.copy_(packed[k]), forwarding_bytes(b, v), 0),
        "coordinator_sequence": (
            lambda k: k_coordinator.coordinator_sequence_window(bases[k], crnd_t, active),
            k3_bytes(b), k3_operations(b)),
        "acceptor_phase2": (
            lambda k: k_acceptor.acceptor_phase2_window(
                *vars(file0).values(), 0, heads[k, 0], heads[k, 1], heads[k, 2], values[k]),
            k7_bytes(b, v), k7_operations(b)),
        "learner_quorum": (
            lambda k: k_learner.learner_quorum_window(q, vote_type[k], vote_vrnd[k], vote_val[k]),
            k8_bytes(a, b, v, b), k8_operations(a, b)),
    }  # fmt: skip
    out = dict(card=CARD, burst=b, value_words=v, ring=n, acceptors=a, quorum=q)
    for name, (call, nbytes, ops_) in runs.items():
        ms = time_walk(call, walk, True, restore)
        bms, by = bound_ms(nbytes, ops_)
        out[name] = dict(ms=ms, us_per_message=ms * 1e3 / b, bound_ms=bms, bound_by=by,
                         bytes_per_launch=nbytes)  # fmt: skip
    geo = k_wirepath.lane_geometry(v, b, 1, True)
    out["acceptor_phase2"].update(variant=geo.variant, team=geo.team, grid=list(geo.grid))
    out["learner_quorum"].update(variant=geo.variant, team=geo.team, grid=list(geo.grid))
    restore()
    return out


def walk_state(rng, g: int, a: int, n: int, v: int, crnd: int, dev):
    """``(G, ...)`` slabs in the multi-group path's steady state after a
    lap, as ``time_k1_cohort`` builds them: every promise at or below
    ``crnd`` and every learner slot holding the previous lap's instance, so
    a walk over the second lap accepts and delivers every lane.  Returns the
    initial tensors (to restore from) and live copies."""

    def words(*shape):
        return rng.integers(-(2**31), 2**31, shape, dtype=np.int32)

    inst = np.arange(n, 2 * n, dtype=np.int32)
    host = dict(
        rnd=rng.integers(0, crnd + 1, (g, a, n), dtype=np.int32),
        vrnd=rng.integers(-1, crnd + 1, (g, a, n), dtype=np.int32),
        val=words(g, a, n, v),
        ldel=np.ones((g, n), np.int32),
        linst=np.broadcast_to(inst - n, (g, n)).copy(),
        lval=words(g, n, v),
    )
    if not ((crnd >= host["rnd"]) & (inst < 2 * n)[None, None]).all():
        raise AssertionError("the timed walk must accept and deliver every lane")
    init = {k: torch.from_numpy(np.ascontiguousarray(x)).to(dev) for k, x in host.items()}
    return init, {k: x.clone() for k, x in init.items()}


def time_k1_cohort(dev) -> dict:
    """K1 in cohort form at the multi-group path's shape (G=8, A=3,
    N=65,536, V=16, B=128, reclamation on), over one walk of the ring as
    ``time_k1`` does: N/B consecutive windows of the second lap, the same
    for every group, each launch with its own burst, the state restored
    before each timed walk.  Two selections: every group in one folded block
    (GB=8, the uniform phase's dispatch) and one group (GB=1, gsel=[3], a
    hot group's dispatch).  Every lane is accepted and fresh, checked from
    the data, so each launch moves exactly ``k1_cohort_bytes``."""
    cfg = multigroup_config()
    g, a, n, v, b, q = 8, cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, cfg.quorum
    crnd, walk = 5, n // b
    rng = np.random.default_rng(SEED + 15)
    init, live = walk_state(rng, g, a, n, v, crnd, dev)
    stack = AcceptorState(live["rnd"], live["vrnd"], live["val"])
    lstate = batched.LearnerState(live["ldel"], live["linst"], live["lval"])
    bursts = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (walk, g, b, v), dtype=np.int32)
    ).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bases = torch.arange(n, 2 * n, b, **i32)[:, None].expand(walk, g).contiguous()
    crnd_t = torch.full((g,), crnd, **i32)
    limit = torch.full((g,), 2 * n, **i32)  # the reclaim mark one lap back
    alive = torch.ones((g, a), dtype=torch.bool, device=dev)
    enabled = torch.ones((g,), **i32)

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    out = {}
    for name, gsel, gb, rows in (("gb8", [0], 8, slice(0, 8)), ("gb1", [3], 1, slice(3, 4))):
        gsel_t = torch.tensor(gsel, **i32)
        c = len(gsel) * gb

        def kernel(k, gsel_t=gsel_t, gb=gb, rows=rows):
            k_wirepath._cohort_launch(gsel_t, gb, bases[k], crnd_t, q, alive,
                                      *vars(stack).values(), *vars(lstate).values(),
                                      bursts[k, rows], enabled, limit)  # fmt: skip

        def plain(k, gsel_t=gsel_t, gb=gb, rows=rows):
            batched.cohort_fused_round(stack, lstate, gsel_t, bases[k], crnd_t, alive, q,
                                       bursts[k, rows], enabled, limit, group_block=gb)  # fmt: skip

        nbytes = k1_cohort_bytes(a, b, v, c, len(gsel))
        bms, by = bound_ms(nbytes, k1_operations(a, b, v, c))
        out[name] = dict(
            ms=time_walk(kernel, walk, True, restore),
            plain_ms=time_walk(plain, walk, True, restore),
            eager_ms=time_walk(kernel, walk, False, restore),
            bound_ms=bms, bound_by=by, bytes_per_launch=nbytes, groups=c,
            **team_times(kernel, walk, restore, k_wirepath.lane_geometry(v, b, c, True), dev),
        )  # fmt: skip
    restore()
    return dict(out["gb8"], gb1=out["gb1"])


def time_k5(dev) -> dict:
    """K5 at the default multi-group path's shape (G=8, A=3, N=65,536, V=16,
    B=128, K=8, reclamation on), over one walk of the ring as
    ``time_k1_cohort`` does: N/(K*B) = 64 launches, each a wave of K
    consecutive windows of the second lap with its own bursts, the state
    restored before each timed walk.  Every group in one folded block (GB=8,
    the uniform phase's wave) and one group (GB=1, gsel=[3], a hot group's
    wave).  Every lane is accepted and fresh, checked from the data, so each
    launch moves exactly ``k5_bytes``."""
    cfg = default_multigroup_config()
    g, a, n, v, b, q = 8, cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, cfg.quorum
    k, crnd = cfg.persistent_rounds, 5
    walk = n // (k * b)
    rng = np.random.default_rng(SEED + 17)
    init, live = walk_state(rng, g, a, n, v, crnd, dev)
    stack = AcceptorState(live["rnd"], live["vrnd"], live["val"])
    lstate = batched.LearnerState(live["ldel"], live["linst"], live["lval"])
    bursts = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (walk, k, g, b, v), dtype=np.int32)
    ).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    wni = (torch.arange(n, 2 * n, b, **i32).reshape(walk, k, 1).expand(walk, k, g).contiguous())
    wen = torch.ones((k, g), **i32)
    crnd_t = torch.full((g,), crnd, **i32)
    limit = torch.full((g,), 2 * n, **i32)  # the reclaim mark one lap back
    alive = torch.ones((g, a), dtype=torch.bool, device=dev)

    def restore():
        for key, x in init.items():
            live[key].copy_(x)

    out = {}
    for name, gsel, gb, rows in (("gb8", [0], 8, slice(0, 8)), ("gb1", [3], 1, slice(3, 4))):
        gsel_t = torch.tensor(gsel, **i32)
        c = len(gsel) * gb
        vals = bursts[:, :, rows].contiguous()  # (walk, K, C, B, V)

        def kernel(w, gsel_t=gsel_t, gb=gb, vals=vals):
            k_wirepath._persistent_launch(gsel_t, gb, wni[w], wen, crnd_t, q, alive,
                                          *vars(stack).values(), *vars(lstate).values(),
                                          vals[w], limit)  # fmt: skip

        def plain(w, gsel_t=gsel_t, gb=gb, vals=vals):
            batched.persistent_cohort_rounds(stack, lstate, gsel_t, wni[w], wen, crnd_t, alive, q,
                                             vals[w], limit, group_block=gb)  # fmt: skip

        nbytes = k5_bytes(a, b, v, c, len(gsel), k, g)
        bms, by = bound_ms(nbytes, k5_operations(a, b, v, c, k))
        ms = time_walk(kernel, walk, True, restore)
        geo = k_wirepath.wave_geometry(v, b, c, k, n, True)
        out[name] = dict(
            ms=ms, per_round_ms=ms / k,
            plain_ms=time_walk(plain, walk, True, restore),
            eager_ms=time_walk(kernel, walk, False, restore),
            bound_ms=bms, bound_by=by, bytes_per_launch=nbytes, groups=c, rounds=k,
            **team_times(kernel, walk, restore, geo, dev),
        )  # fmt: skip
    restore()
    return dict(out["gb8"], gb1=out["gb1"])


def time_k6(dev) -> dict:
    """K6 at the sharded path's shape (A=3, N=65,536, V=16, B=128, one
    shard's slab of Gl=8, reclamation on), over one walk of the ring as
    ``time_k1_cohort`` does: N/B consecutive windows of the second lap, each
    launch with its own burst, the state restored before each timed walk.
    C=1 (lane on row 3, a hot group's dispatch) and C=4 (rows 0, 2, 5, 7).
    Every lane is accepted and fresh, so each launch moves ``k6_bytes``.
    No single PyTorch call computes K6: the library column is none."""
    cfg = default_multigroup_config()
    gl, a, n, v, b, q = 8, cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, 2
    crnd, walk = 5, n // b
    rng = np.random.default_rng(SEED + 23)
    init, live = walk_state(rng, gl, a, n, v, crnd, dev)
    stack = AcceptorState(live["rnd"], live["vrnd"], live["val"])
    lstate = batched.LearnerState(live["ldel"], live["linst"], live["lval"])
    i32 = dict(dtype=torch.int32, device=dev)

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    out = {}
    for name, rows in (("c1", [3]), ("c4", [0, 2, 5, 7])):
        c = len(rows)
        seg = torch.tensor(rows, **i32)
        bases = torch.arange(n, 2 * n, b, **i32)[:, None].expand(walk, c).contiguous()
        bursts = torch.from_numpy(
            rng.integers(-(2**31), 2**31, (walk, c, b, v), dtype=np.int32)
        ).to(dev)
        cr, en = torch.full((c,), crnd, **i32), torch.ones((c,), **i32)
        lim, al = torch.full((c,), 2 * n, **i32), torch.ones((c, a), **i32)

        def kernel(k, seg=seg, bases=bases, bursts=bursts, cr=cr, en=en, lim=lim, al=al):
            k_wirepath._packed_launch(seg, bases[k], cr, lim, al, en, q, *vars(stack).values(),
                                      *vars(lstate).values(), bursts[k])  # fmt: skip

        def plain(k, seg=seg, bases=bases, bursts=bursts, cr=cr, en=en, lim=lim, al=al):
            batched.packed_multigroup_round(stack, lstate, seg, bases[k], cr, al, q, bursts[k],
                                            en, lim)  # fmt: skip

        nbytes = k6_bytes(a, b, v, c)
        bms, by = bound_ms(nbytes, k1_operations(a, b, v, c))  # K1's body on each lane
        out[name] = dict(
            ms=time_walk(kernel, walk, True, restore),
            plain_ms=time_walk(plain, walk, True, restore),
            eager_ms=time_walk(kernel, walk, False, restore),
            bound_ms=bms, bound_by=by, bytes_per_launch=nbytes, lanes=c,
            **team_times(kernel, walk, restore, k_wirepath.lane_geometry(v, b, c, True), dev),
        )  # fmt: skip
    restore()
    return dict(out["c1"], c4=out["c4"])


def time_k1_shard(dev) -> dict:
    """K1's shard slice at the sharded path's full-width shape: G=8 over 2
    shards (Gl=4), one shard's slab at offset 4 in one folded block (GB=4),
    A=3, N=65,536, V=16, B=128, over one walk of the ring as
    ``time_k1_cohort`` does.  Each launch moves ``k1_cohort_bytes`` of 4
    groups in 1 block."""
    cfg = default_multigroup_config()
    g, gl, a, n, v, b, q = 8, 4, cfg.n_acceptors, cfg.n_instances, cfg.value_words, cfg.batch, 2
    crnd, walk, off = 5, n // b, 4
    rng = np.random.default_rng(SEED + 24)
    init, live = walk_state(rng, g, a, n, v, crnd, dev)
    rows = slice(off, off + gl)
    stack = AcceptorState(live["rnd"][rows], live["vrnd"][rows], live["val"][rows])
    lstate = batched.LearnerState(live["ldel"][rows], live["linst"][rows], live["lval"][rows])
    i32 = dict(dtype=torch.int32, device=dev)
    bases = torch.arange(n, 2 * n, b, **i32)[:, None].expand(walk, g).contiguous()
    bursts = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (walk, gl, b, v), dtype=np.int32)
    ).to(dev)
    cr, en = torch.full((g,), crnd, **i32), torch.ones((g,), **i32)
    lim = torch.full((g,), 2 * n, **i32)
    alive = torch.ones((g, a), dtype=torch.bool, device=dev)
    gsel = torch.tensor([0], **i32)

    def restore():
        for k, x in init.items():
            live[k].copy_(x)

    def kernel(k):
        k_wirepath._cohort_launch(gsel, gl, bases[k, rows], cr[rows], q, alive[rows],
                                  *vars(stack).values(), *vars(lstate).values(), bursts[k],
                                  en[rows], lim[rows])  # fmt: skip

    def plain(k):
        batched.shard_slab_round(off, bases[k], cr, alive, q, stack, lstate, bursts[k], en, lim)

    nbytes = k1_cohort_bytes(a, b, v, gl, 1)
    bms, by = bound_ms(nbytes, k1_operations(a, b, v, gl))
    out = dict(
        ms=time_walk(kernel, walk, True, restore),
        plain_ms=time_walk(plain, walk, True, restore),
        eager_ms=time_walk(kernel, walk, False, restore),
        bound_ms=bms, bound_by=by, bytes_per_launch=nbytes, groups=gl,
        **team_times(kernel, walk, restore, k_wirepath.lane_geometry(v, b, gl, True), dev),
    )  # fmt: skip
    restore()
    return out


def kernel_name(mangled: str) -> str:
    """``_Z21wirepath_round_kernelI4int4Ev...`` -> ``wirepath_round_kernel<int4>``."""
    digits = len(mangled[2:]) - len(mangled[2:].lstrip("0123456789"))
    size = int(mangled[2 : 2 + digits])
    name, rest = mangled[2 + digits : 2 + digits + size], mangled[2 + digits + size :]
    for code, word in (("I4int4E", "<int4>"), ("IiE", "<int>")):
        if rest.startswith(code):
            return name + word
    return name


TEAM_KERNELS = {  # source -> its team kernels, each built as <int4> and <int>
    "wirepath": ("wirepath_round_kernel", "cohort_wirepath_round_kernel",
                 "persistent_wirepath_round_kernel", "packed_shard_round_kernel"),
    "vote": ("acceptor_vote_all_kernel",),  # K2 and K7
    "learner": ("learner_quorum_kernel",),
}  # fmt: skip


def build_facts(src: str) -> dict:
    """Each kernel of ``csrc/<src>.cu``: its registers, spills and stack
    (``-Xptxas -v``) and its 128-bit global loads and stores in the SASS of
    the built library (``cuobjdump --dump-sass``)."""
    facts, name = {}, None
    for line in _build.build_log(src).splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
            facts[name] = {}
        elif name and "spill stores" in line:
            facts[name].update(stack_bytes=int(line.split()[0]),
                               spill_store_bytes=int(line.split(",")[1].split()[0]),
                               spill_load_bytes=int(line.split(",")[2].split()[0]))  # fmt: skip
        elif name and "Used" in line and "registers" in line:
            facts[name]["registers"] = int(line.split("Used")[1].split()[0])
    for chunk in _build.sass(src).split("Function : ")[1:]:
        fn = facts.setdefault(kernel_name(chunk.split()[0]), {})
        fn["ldg128"] = len(re.findall(r"\bLDG(?:\.\w+)*?\.128\b", chunk))
        fn["stg128"] = len(re.findall(r"\bSTG(?:\.\w+)*?\.128\b", chunk))
    return facts


def spills(fn: dict) -> bool:
    """Whether a kernel's build spilled (or the kernel was not built)."""
    return bool(fn.get("spill_store_bytes", 1) or fn.get("spill_load_bytes", 1))


def team_build_facts() -> dict:
    """``build_facts`` of ``csrc/wirepath.cu``, ``csrc/vote.cu`` and
    ``csrc/learner.cu``.  Fails if a team kernel (K1, K5, K6, K2 and K7,
    K8) spills, if a vector variant has no 128-bit store, or if G=1 at the
    paths' shape runs on one block."""
    facts = {}
    for src, entries in TEAM_KERNELS.items():
        facts.update(build_facts(src))
        for entry in entries:
            for word in ("<int4>", "<int>"):
                fn = facts.get(entry + word, {})
                if spills(fn):
                    raise AssertionError(f"{entry}{word} spills or was not built: {fn}")
            if not facts[entry + "<int4>"].get("stg128"):
                raise AssertionError(f"{entry}<int4> has no 128-bit global store: {facts}")
    geo = k_wirepath.lane_geometry(16, PaxosConfig().batch, 1, True)
    if geo.grid[0] < 2:
        raise AssertionError(f"K1 at G=1 runs on one block: {geo}")
    facts["G=1 geometry"] = dataclasses.asdict(geo)
    return facts


def k4_k3_build_facts() -> dict:
    """``build_facts`` of ``csrc/digest.cu`` and ``csrc/coordinator.cu``.
    Fails if K4's tree kernel or K3 spills, or if K4's has no 128-bit
    global load."""
    facts = {**build_facts("digest"), **build_facts("coordinator")}
    for name in ("tree_digest_kernel", "coordinator_sequence_kernel"):
        if spills(facts.get(name, {})):
            raise AssertionError(f"{name} spills or was not built: {facts.get(name)}")
    if not facts["tree_digest_kernel"].get("ldg128"):
        raise AssertionError(f"tree_digest_kernel has no 128-bit global load: {facts}")
    return facts


def k9_build_facts() -> dict:
    """The bf16 kernel's registers, spills and stack (``-Xptxas -v``) at each
    register tile DT, and the counts of HGMMA (wgmma) and UTMALDG (TMA load)
    instructions in ``cuobjdump --dump-sass`` of the built library."""
    facts, dt = {}, None
    for line in _build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            dt = line.split("ILi")[1].split("E")[0] if "flash_wgmma_kernel" in line else None
        elif dt and "spill stores" in line:
            facts[f"DT{dt}"] = {"stack_bytes": int(line.split()[0]),
                                "spill_store_bytes": int(line.split(",")[1].split()[0]),
                                "spill_load_bytes": int(line.split(",")[2].split()[0])}  # fmt: skip
        elif dt and "Used" in line and "registers" in line:
            facts[f"DT{dt}"]["registers"] = int(line.split("Used")[1].split()[0])
    sass = _build.sass("flash_attention")
    facts["sass"] = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG", "STL")}
    return facts


def time_k9(dev) -> dict:
    """K9 at the LM path's shapes (B=2, H=32, KVH=16, S=2048, D=128, bf16),
    causal, at window 0 (a global layer) and 1024 (a local one): the kernel,
    on contiguous (B, H, S, D) tensors (the yardstick of earlier runs) and on
    the views of (B, S, H, D) tensors that the path hands it, its plain
    version and ``scaled_dot_product_attention`` (GQA, causal or the
    window's boolean mask), each in a CUDA graph, with its bound
    (``k9_work``, on this run's mask).  Fails unless the bf16 kernel was
    built from wgmma and TMA loads."""
    facts = k9_build_facts()
    print(f"  K9 build: {json.dumps(facts)}")
    if not (facts["sass"]["HGMMA"] and facts["sass"]["UTMALDG"]):
        raise AssertionError(f"K9's library has no wgmma or no TMA load: {facts['sass']}")
    b, h, kvh, s, d = K9_PATH
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    q, k, v = k9_inputs(gen, b, h, kvh, s, s, d, torch.bfloat16, dev)
    qv, kv_, vv = k9_inputs(gen, b, h, kvh, s, s, d, torch.bfloat16, dev, views=True)
    out = {}
    for window in (0, 1024):
        mask = k9_mask(s, s, dev, window=window)

        def kernel(i, window=window):
            k_flash.flash_attention(q, k, v, window=window)

        def on_views(i, window=window):
            k_flash.flash_attention(qv, kv_, vv, window=window)

        def plain(i, window=window):
            k_flash.flash_attention_plain(q, k, v, window=window)

        def library(i, mask=mask, window=window):
            if window:
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        lib_err = (library(0).float() - k_flash.flash_attention(q, k, v, window=window).float())
        out[window] = dict(
            k9_work(q, k, v, mask, time_walk(kernel, 20, True), window=window),
            views_ms=time_walk(on_views, 20, True),
            plain_ms=time_walk(plain, 3, True),
            library_ms=time_walk(library, 20, True),
            window=window,
            library_max_abs_diff=lib_err.abs().max().item(),
        )  # fmt: skip
    return dict(out[0], window_1024=out[1024], build=facts, other_shapes=time_k9_shapes(dev))


def k9_mask(sq: int, sk: int, dev, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The (Sq, Sk) pairs K9 computes: every pair, or key j <= row i when
    ``causal``, and j > i - ``window`` when windowed."""
    qi, kj = torch.arange(sq, device=dev)[:, None], torch.arange(sk, device=dev)[None, :]
    mask = kj <= qi if causal else torch.ones((sq, sk), dtype=torch.bool, device=dev)
    return mask & (kj > qi - window) if window else mask


def k9_work(
    q, k, v, mask: torch.Tensor, ms: float, causal: bool = True, window: int = 0
) -> dict:
    """K9's time ``ms`` on bf16 q (B, H, Sq, D), k and v (B, KVH, Sk, D)
    beside its bound (``analysis.bounds``: ``k9_operations`` of the
    ``causal``, ``window`` pairs at the bf16 tensor-core rate, ``k9_bytes``).
    Fails unless ``k9_pairs`` counts the pairs of this run's ``mask``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    pairs, unmasked = k9_pairs(sq, sk, causal, window), int(mask.sum().item())
    if pairs != unmasked:
        raise AssertionError(f"k9_pairs counts {pairs} pairs, the mask {unmasked}")
    ops_ = k9_operations(b, h, sq, sk, d, causal, window)
    nbytes = k9_bytes(b, h, kvh, sq, sk, d, q.element_size())
    bms, by = bound_ms(nbytes, ops_, PEAK_FLOPS)
    return dict(ms=ms, tflop_per_s=ops_ / (ms * 1e-3) / 1e12, bound_ms=bms, bound_by=by,
                operations=ops_, bytes=nbytes)  # fmt: skip


def time_k9_shape(dev, gen, shape: tuple, causal: bool, window: int = 0) -> dict:
    """K9 (bf16, on views) at ``shape`` = (B, H, KVH, Sq, Sk, D) beside
    ``scaled_dot_product_attention`` (GQA; causal, or on the window's
    boolean mask), each in a CUDA graph, with K9's bound (``k9_work``)."""
    q, k, v = k9_inputs(gen, *shape, torch.bfloat16, dev, views=True)
    mask = k9_mask(shape[3], shape[4], dev, causal, window)

    def kernel(i):
        k_flash.flash_attention(q, k, v, causal=causal, window=window)

    def library(i):
        if window:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    return dict(k9_work(q, k, v, mask, time_walk(kernel, 20, True), causal, window),
                library_ms=time_walk(library, 20, True), window=window)  # fmt: skip


def time_k9_shapes(dev) -> dict:
    """K9 beside ``scaled_dot_product_attention`` (``time_k9_shape``) at
    shapes off the gemma3 path: the MoE path's (llama4-scout: B=2, H=40,
    KVH=8, S=2048, causal, G = 5); non-causal at the gemma3 path's width
    with 128 keys (one k tile an item: the fixed cost of an item) and with
    2048 (16 tiles an item); head dim 256 (B=1, H=16, KVH=8, S=4096,
    causal); griffin's prefill (recurrentgemma-2b: B=2, H=10, KVH=1,
    S=4096, D=256, causal, window 2048); whisper-base's encoder (B=4, H=8,
    KVH=8, 1500 frames, D=64, non-causal) and its cross-attention (448
    tokens over the 1500 frames)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    b, h, kvh, s, d = K9_PATH
    mb, mh, mkvh, ms_, md = MOE_K9
    shapes = {
        "llama4_scout": ((mb, mh, mkvh, ms_, ms_, md), True, 0),
        "noncausal_sk128": ((b, h, kvh, s, 128, d), False, 0),
        "noncausal_sk2048": ((b, h, kvh, s, s, d), False, 0),
        "d256_causal_s4096": ((1, 16, 8, 4096, 4096, 256), True, 0),
        "griffin": ((2, 10, 1, 4096, 4096, 256), True, 2048),
        "whisper_encoder": ((4, 8, 8, 1500, 1500, 64), False, 0),
        "whisper_cross": ((4, 8, 8, 448, 1500, 64), False, 0),
    }
    return {name: time_k9_shape(dev, gen, *args) for name, args in shapes.items()}


def percentiles(round_s: list[float]) -> tuple[float, float]:
    ms = np.asarray(round_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def run_replicated_kv(dev) -> dict:
    """The replicated KV phase: ``run_kv_path`` and ``run_kv_sharded`` on the
    card, each with its launches counted and against its plain engine's
    run; raises on the first difference."""
    print("replicated KV: ConsensusService and ReplicatedKV over PaxosContext(PaxosConfig("
          "n_groups=8, realign_after=4), use_kernels=True, snapshots=True), 1,024 sessions, "
          "eight single-group twins, run_kv_twins's chaos schedule, an adopted "
          "snapshot")  # fmt: skip
    reset_launches()
    with (
        PlainCalls() as plain_votes,
        PlainCalls("_rows_round") as plain_rounds,
        SealCalls() as seals,
    ):
        kvp = run_kv_path(True, dev)
    kv_launches = read_launches()
    print(f"  launches: {kv_launches}, plain Phase-2 votes: {plain_votes.calls}, plain rounds: "
          f"{plain_rounds.calls}, seals: {seals.calls}")  # fmt: skip
    require_launched("replicated KV", kv_launches, ["K5", "K1-cohort", "digest"])
    require_seals("replicated KV", kv_launches, seals)
    if plain_votes.calls or plain_rounds.calls:
        raise AssertionError(f"the replicated KV path ran the plain engine: {kv_launches}")
    require_variant("replicated KV", kv_launches,
                    ["wirepath_round", "K1-cohort", "K5", "acceptor_vote_all"])  # fmt: skip
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    kvp_plain = run_kv_path(False, dev)
    for key in ("logs", "archived", "signatures", "retire_sigs", "answers", "stats",
                "dispatch_count", "seals", "report", "epoch"):  # fmt: skip
        if kvp[key] != kvp_plain[key]:
            raise AssertionError(f"replicated KV kernel and plain runs differ in {key}")
    for key, arr in kvp["state"].items():
        if not np.array_equal(arr, kvp_plain["state"][key]):
            raise AssertionError(f"replicated KV kernel and plain runs differ in state {key}")
    print(f"  equal: {len(kvp['logs'])} group logs ({[len(x) for x in kvp['logs']]}), "
          f"{len(kvp['archived'])} archived segments, {len(kvp['signatures'])} replica "
          f"signatures, {len(kvp['answers'])} gets, stats {kvp['stats']}, dispatch_count "
          f"{kvp['dispatch_count']}, {len(kvp['seals'])} seals, planner report "
          f"{kvp['report']}; twins' replicas equal at the retirement and at the end; no "
          f"stale read; no leased get dispatched")  # fmt: skip

    mesh = group_mesh(dev)
    print("replicated KV, sharded: the same tier over group_mesh(dev), one plan_placement "
          "and a migrate_group")  # fmt: skip
    print(f"  {mesh_line(mesh)}")
    reset_launches()
    with SealCalls() as seals:
        kvs = run_kv_sharded(True, dev, mesh)
    kvs_launches = read_launches()
    print(f"  launches: {kvs_launches}, seals: {seals.calls}")
    require_launched("sharded replicated KV", kvs_launches, ["K6", "K1-shard", "digest"])
    require_seals("sharded replicated KV", kvs_launches, seals)
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    kvs_plain = run_kv_sharded(False, dev, mesh)
    for key in ("logs", "signatures", "answers", "stats", "dispatch_count", "seals",
                "placement", "plan", "moved", "report"):  # fmt: skip
        if kvs[key] != kvs_plain[key]:
            raise AssertionError(f"sharded replicated KV kernel and plain runs differ in {key}")
    for key, arr in kvs["state"].items():
        if not np.array_equal(arr, kvs_plain["state"][key]):
            raise AssertionError(f"sharded replicated KV kernel and plain runs differ in {key}")
    hot, gone, dst, movers = kvs["moved"]
    print(f"  equal: group logs, {len(kvs['signatures'])} replica signatures, "
          f"{len(kvs['answers'])} gets, stats {kvs['stats']}, placement {kvs['placement']} "
          f"(plan {kvs['plan']}); group {hot} moved to shard {dst} after group {gone} "
          f"retired, its {movers} sessions read the same values after the move, "
          f"leased")  # fmt: skip
    return dict(kvp=kvp, kvp_plain=kvp_plain, kv_launches=kv_launches, kvs=kvs,
                kvs_plain=kvs_plain, kvs_launches=kvs_launches)  # fmt: skip


def require_launched(path: str, launches: dict[str, int], names: list[str]) -> None:
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise AssertionError(f"the {path} did not run through {missing}: {launches}")


def require_variant(path: str, launches: dict[str, int], names: list[str]) -> None:
    """Every launch of a path's team kernels ``names`` (V = 16, tensors on
    16 bytes) took the vector variant."""
    vec, sca = launches["team vector"], launches["team scalar"]
    if vec != sum(launches[n] for n in names) or sca:
        raise AssertionError(f"the {path}'s team kernel launches did not all take the vector "
                             f"variant: {launches}")  # fmt: skip


def main() -> None:
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is false")
    if sys.argv[1:2] == ["--fabric-ranks"]:  # run_fabric's subprocess
        fabric_ranks(sys.argv[2])
        return
    CARD = card_line()
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--prefill-decode-gap"]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"prefill_decode_gap": prefill_decode_gap(torch.device("cuda"))}))
        return
    run(torch.device("cuda"))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


def run(dev: torch.device) -> None:
    """Every phase on ``dev``; raises on the first failure."""
    # float32 products in full float32: K9 never uses TF32, the plain versions must not
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    print(f"build: {build_s:.3f} s for {', '.join(_build.sources())}")
    for name in _build.sources():
        print(f"--- nvcc {name} ---\n{_build.build_log(name).strip()}")

    run_contracts(dev)
    reset_launches()

    print("kernel phase: each kernel against its plain version on the card")
    errs = {"wirepath_round": check_k1(dev), "digest": check_k4(dev)}
    errs["coordinator_sequence"] = check_k3(dev)
    errs["acceptor_vote_all"], errs["acceptor_phase2"], made = check_votes(dev)
    errs["learner_quorum"] = check_k8(dev, made)
    errs["K1-cohort"] = check_k1_cohort(dev)
    errs["K5"] = check_k5(dev)
    errs["K6"] = check_k6(dev)
    errs["K1-shard"] = check_k1_shard(dev)
    errs["K9"] = check_k9(dev)
    check_lm_small(dev)
    print(f"  team kernels' build: {json.dumps(team_build_facts())}")
    print(f"  K4's and K3's build: {json.dumps(k4_k3_build_facts())}")
    # timed here, before the paths, and printed after them
    times = {"wirepath_round": time_k1(dev), "digest": time_k4(dev, PaxosConfig().n_instances // 4)}
    times.update(time_staged(dev))
    times["Table 1"] = time_table1(dev)
    times["K1-cohort"] = time_k1_cohort(dev)
    times["K5"] = time_k5(dev)
    times["K6"] = time_k6(dev)
    times["K1-shard"] = time_k1_shard(dev)
    times["K9"] = time_k9(dev)

    print("main path: PaxosContext(PaxosConfig(), fused=True, use_kernels=True, snapshots=True)")
    reset_launches()
    with PlainCalls() as plain_votes, SealCalls() as seals:
        kern = run_main_path(True, dev)
    launches = read_launches()
    print(f"  launches on the main path: {launches}, fused rounds: {kern['rounds']}, "
          f"plain Phase-2 votes: {plain_votes.calls}, seals: {seals.calls}")  # fmt: skip
    require_launched("main path", launches, ["wirepath_round", "digest", "acceptor_vote_all"])
    require_seals("main path", launches, seals)
    if launches["wirepath_round"] != kern["rounds"] or plain_votes.calls:
        raise AssertionError(f"the main path did not vote through the kernels: {launches}")
    require_variant("main path", launches, ["wirepath_round", "acceptor_vote_all"])
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    plain = run_main_path(False, dev)
    for key in ("delivered_log", "full_log", "seals"):
        if kern[key] != plain[key]:
            raise AssertionError(f"kernel and plain runs differ in {key}")
    for key, arr in kern["state"].items():
        if not np.array_equal(arr, plain["state"][key]):
            raise AssertionError(f"kernel and plain runs differ in final state {key}")
    errs["digest"] = max(errs["digest"], check_seals(kern, dev))
    print(f"  equal: delivered logs ({len(kern['delivered_log'])}), full logs "
          f"({kern['delivered']}), seals {kern['seals']}, final state")  # fmt: skip
    print(f"  ring laps {kern['ring_laps']:.3f}, stats {kern['stats']}")

    print("staged path: PaxosContext(PaxosConfig(), n_learners=2), fused=False, use_kernels=True")
    reset_launches()
    staged = run_staged_path(True, dev)
    staged_launches = read_launches()
    calls = staged["calls"]
    print(f"  launches on the staged path: {staged_launches}, calls {calls}, "
          f"plain Phase-2 votes: {staged['plain_votes']}")  # fmt: skip
    require_launched("staged path", staged_launches, ["coordinator_sequence", "acceptor_vote_all"])
    if (
        staged_launches["coordinator_sequence"] != calls["sequence"]
        or staged_launches["acceptor_vote_all"] != calls["vote"]
        or staged["plain_votes"]
    ):
        raise AssertionError("the staged path did not sequence and vote through K3 and K2")
    require_variant("staged path", staged_launches, ["acceptor_vote_all"])
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    staged_plain = run_staged_path(False, dev)
    if not staged_plain["plain_votes"]:
        raise AssertionError("the plain staged run did not vote on the plain engine")
    for key in ("delivered_log", "learned"):
        if staged[key] != staged_plain[key]:
            raise AssertionError(f"staged kernel and plain runs differ in {key}")
    for key, arr in staged["state"].items():
        if not np.array_equal(arr, staged_plain["state"][key]):
            raise AssertionError(f"staged kernel and plain runs differ in final state {key}")
    print(f"  equal: delivered logs ({staged['delivered']}), both learners' tables "
          f"({[len(t) for t in staged['learned']]}), final state")  # fmt: skip
    print(f"  ring laps {staged['ring_laps']:.3f}, stats {staged['stats']}")

    print("per-role path: K3 -> K7 x A -> K8 over one ring walk at PaxosConfig()")
    reset_launches()
    roles = run_per_role_path(dev)
    role_launches = read_launches()
    print(f"  launches on the per-role path: {role_launches}")
    a = PaxosConfig().n_acceptors
    want = {"coordinator_sequence": roles["bursts"], "acceptor_phase2": a * roles["bursts"],
            "learner_quorum": roles["bursts"]}  # fmt: skip
    require_launched("per-role path", role_launches, list(want))
    if any(role_launches[k] != n for k, n in want.items()):
        raise AssertionError(f"the per-role path's launches are not {want}")
    require_variant("per-role path", role_launches,
                    ["acceptor_vote_all", "acceptor_phase2", "learner_quorum"])  # fmt: skip
    errs["learner_quorum"] = max(errs["learner_quorum"], roles["max_abs_err"])

    print(f"fabric consensus: make_fabric_consensus at the paper's deployment, one rank an "
          f"acceptor; a world of one on NCCL, then {FABRIC_RANKS} ranks on the card over "
          f"gloo")  # fmt: skip
    fabric = run_fabric(dev)

    print("multi-group path: PaxosContext(PaxosConfig(n_groups=8, persistent_rounds=1, "
          "realign_after=4), use_kernels=True, snapshots=True)")  # fmt: skip
    reset_launches()
    with (
        PlainCalls() as plain_votes,
        PlainCalls("_rows_round") as plain_rounds,
        SealCalls() as seals,
    ):
        mg = run_multigroup_path(True, dev)
    mg_launches = read_launches()
    dispatches = len(mg["dispatch_s"])
    print(f"  launches on the multi-group path: {mg_launches}, fused dispatches: {dispatches}, "
          f"plain Phase-2 votes: {plain_votes.calls}, plain rounds: {plain_rounds.calls}, "
          f"seals: {seals.calls}")  # fmt: skip
    require_launched("multi-group path", mg_launches, ["K1-cohort", "digest", "acceptor_vote_all"])
    require_seals("multi-group path", mg_launches, seals)
    if mg_launches["K1-cohort"] != dispatches or plain_votes.calls or plain_rounds.calls:
        raise AssertionError(f"the multi-group path did not run through the kernels: {mg_launches}")
    require_variant("multi-group path", mg_launches, ["K1-cohort", "acceptor_vote_all"])
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    with PlainCalls("_rows_round") as plain_rounds:
        mg_plain = run_multigroup_path(False, dev)
    if plain_rounds.calls != len(mg_plain["dispatch_s"]):
        raise AssertionError("the plain multi-group run did not run the plain engine")
    for key in ("logs", "retired", "seals", "order", "dispatch_count", "last_gb", "report"):
        if mg[key] != mg_plain[key]:
            raise AssertionError(f"multi-group kernel and plain runs differ in {key}")
    for key, arr in mg["state"].items():
        if not np.array_equal(arr, mg_plain["state"][key]):
            raise AssertionError(f"multi-group kernel and plain runs differ in final state {key}")
    errs["digest"] = max(errs["digest"], check_seals(mg, dev))
    print(f"  equal: {len(mg['logs'])} group logs ({[len(x) for x in mg['logs']]}), retired "
          f"logs, {len(mg['seals'])} seals, final state, dispatch_count {mg['dispatch_count']}, "
          f"last_gb {mg['last_gb']}, planner report {mg['report']}")  # fmt: skip
    print(f"  fold widths seen (width: dispatches): {dict(sorted(mg['folds'].items()))}, "
          f"group 0 ring laps {mg['ring_laps']:.3f}, stats {mg['stats']}")  # fmt: skip

    print("multi-group path at the defaults: PaxosContext(PaxosConfig(n_groups=8, "
          "realign_after=4), use_kernels=True, snapshots=True): persistent_rounds=8, "
          "async_pump=True")  # fmt: skip
    reset_launches()
    with (
        PlainCalls() as plain_votes,
        PlainCalls("_rows_round") as plain_rounds,
        SealCalls() as seals,
    ):
        dflt = run_multigroup_path(True, dev, default_multigroup_config())
    dflt_launches = read_launches()
    depths = dflt["depths"]
    waves = sum(c for k, c in depths.items() if k > 1)
    print(f"  launches: {dflt_launches}, waves {waves}, single rounds {depths.get(1, 0)}, "
          f"plain Phase-2 votes: {plain_votes.calls}, plain rounds: {plain_rounds.calls}, "
          f"seals: {seals.calls}")  # fmt: skip
    require_seals("default multi-group path", dflt_launches, seals)
    print(f"  wave depths (K: dispatches): {dict(sorted(depths.items()))}")
    require_launched("default multi-group path", dflt_launches,
                     ["K5", "K1-cohort", "digest", "acceptor_vote_all"])  # fmt: skip
    if (
        dflt_launches["K5"] != waves
        or dflt_launches["K1-cohort"] != depths.get(1, 0)
        or dflt["report"]["persistent_waves"] != waves
        or plain_votes.calls
        or plain_rounds.calls
    ):
        raise AssertionError(f"the default path did not run through K5 and K1: {dflt_launches}")
    if 8 not in depths or not any(1 < k < 8 for k in depths):
        raise AssertionError(f"the default path's waves lack K=8 or a 1 < K < 8: {depths}")
    require_variant("default multi-group path", dflt_launches,
                    ["K1-cohort", "K5", "acceptor_vote_all"])  # fmt: skip
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    with PlainCalls("_rows_round") as plain_rounds:
        dflt_plain = run_multigroup_path(False, dev, default_multigroup_config())
    if plain_rounds.calls != sum(k * c for k, c in dflt_plain["depths"].items()):
        raise AssertionError("the plain default run did not run the plain engine round by round")
    for key in ("logs", "retired", "seals", "order", "depths", "folds", "dispatch_count",
                "last_gb", "report"):  # fmt: skip
        if dflt[key] != dflt_plain[key]:
            raise AssertionError(f"default multi-group kernel and plain runs differ in {key}")
    for key, arr in dflt["state"].items():
        if not np.array_equal(arr, dflt_plain["state"][key]):
            raise AssertionError(f"default multi-group kernel and plain runs differ in state {key}")
    errs["digest"] = max(errs["digest"], check_seals(dflt, dev))
    print(f"  equal: {len(dflt['logs'])} group logs ({[len(x) for x in dflt['logs']]}), the "
          f"order of {len(dflt['order'])} deliver callbacks, retired logs, "
          f"{len(dflt['seals'])} seals, final state, dispatch_count {dflt['dispatch_count']}, "
          f"last_gb {dflt['last_gb']}, planner report {dflt['report']}")  # fmt: skip
    print(f"  fold widths seen (width: dispatches): {dict(sorted(dflt['folds'].items()))}, "
          f"group 0 ring laps {dflt['ring_laps']:.3f}, stats {dflt['stats']}")  # fmt: skip

    print("sharded multi-group path: PaxosContext(PaxosConfig(n_groups=8, realign_after=4), "
          "mesh=group_mesh(dev), use_kernels=True, snapshots=True) on the multi-group "
          "path's schedule, then a live migration")  # fmt: skip
    mesh = group_mesh(dev)
    print(f"  {mesh_line(mesh)}")
    reset_launches()
    with (
        PlainCalls() as plain_votes,
        PlainCalls("_rows_round") as plain_rounds,
        SealCalls() as seals,
    ):
        shd = run_multigroup_path(True, dev, default_multigroup_config(), mesh=mesh, deep=False)
    sh_launches = read_launches()
    rounds = sum(k * c for k, c in shd["depths"].items())
    print(f"  launches: {sh_launches}, dispatches {len(shd['dispatch_s'])} (single rounds "
          f"{rounds}), plain Phase-2 votes: {plain_votes.calls}, plain rounds: "
          f"{plain_rounds.calls}, seals: {seals.calls}")  # fmt: skip
    require_seals("sharded multi-group path", sh_launches, seals)
    print(f"  wave depths (K: dispatches): {dict(sorted(shd['depths'].items()))}")
    require_launched("sharded multi-group path", sh_launches,
                     ["K6", "K1-shard", "digest", "acceptor_vote_all"])  # fmt: skip
    if (
        sh_launches["K6"] + sh_launches["K1-shard"] != mesh.n_shards * rounds
        or sh_launches["K5"]
        or sh_launches["K1-cohort"]
        or plain_votes.calls
        or plain_rounds.calls
    ):
        raise AssertionError(f"the sharded path did not run through K6 and K1's shard slice: "
                             f"{sh_launches}")  # fmt: skip
    require_variant("sharded multi-group path", sh_launches,
                    ["K6", "K1-shard", "acceptor_vote_all"])  # fmt: skip
    if set(shd["depths"]) != {1} or shd["report"]["persistent_waves"]:
        raise AssertionError(f"the sharded context planned persistent waves: {shd['depths']}")
    # a sharded context plans no waves (the reference's clamp), so before
    # the move it must equal the unsharded service without waves on the
    # same schedule: the multi-group path
    for key in ("logs", "dispatch_count", "report"):
        if shd["before_move"][key] != mg[key]:
            raise AssertionError(f"the sharded path differs from the multi-group path in {key}")
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    with PlainCalls("_rows_round") as plain_rounds:
        shd_plain = run_multigroup_path(False, dev, default_multigroup_config(), mesh=mesh,
                                        deep=False)  # fmt: skip
    if not 0 < plain_rounds.calls <= mesh.n_shards * rounds:
        raise AssertionError("the plain sharded run did not run the plain engine")
    for key in ("logs", "retired", "seals", "order", "depths", "folds", "dispatch_count",
                "last_gb", "report", "placement"):  # fmt: skip
        if shd[key] != shd_plain[key]:
            raise AssertionError(f"sharded kernel and plain runs differ in {key}")
    for key, arr in shd["state"].items():
        if not np.array_equal(arr, shd_plain["state"][key]):
            raise AssertionError(f"sharded kernel and plain runs differ in state {key}")
    errs["digest"] = max(errs["digest"], check_seals(shd, dev))
    print(f"  equal: {len(shd['logs'])} group logs ({[len(x) for x in shd['logs']]}), the "
          f"order of {len(shd['order'])} deliver callbacks, retired logs, "
          f"{len(shd['seals'])} seals, final state, dispatch_count {shd['dispatch_count']}, "
          f"last_gb {shd['last_gb']}, placement {shd['placement']}, planner report "
          f"{shd['report']}; before the move, group logs, dispatch_count and planner "
          f"report equal the multi-group path's")  # fmt: skip
    print(f"  fold widths seen (width: dispatches): {dict(sorted(shd['folds'].items()))}, "
          f"stats {shd['stats']}")  # fmt: skip
    shd["parts"] = sharded_dispatch_parts(dev, mesh)
    print(f"  a dispatch's parts, p50 ms: {shd['parts']}")

    kvr = run_replicated_kv(dev)
    # each ReplicatedKV and its KVSessions refer to each other, so the KV phase's four
    # contexts (their (8, 3, 65,536, 16) slabs, 0.604 GB) wait for a collection
    gc.collect()

    print(f"LM weights: {LM_ARCH} at full width, {LM_LAYERS} of its 62 layers, random from a "
          f"seeded generator on the card, float32 and bfloat16")  # fmt: skip
    params32, params16 = lm_params(lm_config("float32"), dev)
    print("LM prefill path: make_prefill_step(gemma3-27b, 12 layers) on 2 prompts of 2048 tokens, "
          "bfloat16")  # fmt: skip
    lm = run_lm_prefill(dev, params16)
    lm_launches = lm.pop("launches")
    require_launched("LM prefill path", lm_launches, ["K9"])
    print(f"LM prefill against decode: float32, 1 prompt of {DECODE_LEN} tokens, TF32 off")
    lm_decode = run_prefill_against_decode(dev, params32, lm_config("float32"), DECODE_LEN,
                                           SEED + 5)  # fmt: skip
    print(f"LM ring cache: gemma3-27b, 12 layers, ring_local_cache=True, float32 decode of the "
          f"same {DECODE_LEN} tokens; then the cache and the bf16 decode step at B=4, S=8192 with "
          f"and without the rings")  # fmt: skip
    ring = run_ring_decode(dev, params32, params16, lm_decode)
    del params32
    print("LM serving: ServeLoop(gemma3-27b, 12 layers, batch_size=4), bfloat16")
    lm_serve = run_lm_serving(dev, params16, lm_config("bfloat16"))
    del params16
    torch.cuda.empty_cache()

    print(f"MoE weights: {MOE_ARCH} at full width, {MOE_LAYERS} of its 48 layers, random from a "
          f"seeded generator on the card, float32 and bfloat16")  # fmt: skip
    moe32, moe16 = lm_params(moe_config("float32"), dev)
    n_moe = sum(t.numel() for t in lm_layers.tree_leaves(moe16))
    print(f"  {n_moe} params: {4 * n_moe / 1e9:.2f} GB in float32, {2 * n_moe / 1e9:.2f} GB in "
          f"bf16")  # fmt: skip
    print(f"MoE prefill path: make_prefill_step({MOE_ARCH}, {MOE_LAYERS} layers) on 2 prompts of "
          f"2048 tokens, bfloat16")  # fmt: skip
    moe = run_moe_prefill(dev, moe16)
    moe_launches = moe.pop("launches")
    require_launched("MoE prefill path", moe_launches, ["K9"])
    moe_cf = moe_config("float32").n_experts / moe_config("float32").top_k
    print(f"MoE prefill against decode: float32, 1 prompt of {MOE_DECODE_LEN} tokens, capacity "
          f"factor {moe_cf} (no token dropped), TF32 off")  # fmt: skip
    moe_cfg32 = moe_config("float32", capacity_factor=moe_cf)
    moe_decode = run_prefill_against_decode(dev, moe32, moe_cfg32, MOE_DECODE_LEN, SEED + 9)
    del moe32
    print(f"MoE serving: ServeLoop({MOE_ARCH}, {MOE_LAYERS} layers, batch_size=4), bfloat16")
    moe_serve = run_lm_serving(dev, moe16, moe_config("bfloat16"))
    del moe16
    torch.cuda.empty_cache()
    trained = run_training(dev)
    print("mesh phase: make_host_mesh() over NCCL in a world of one, BASE_RULES, qwen3-4b "
          "train steps; then the dry run of qwen3-4b train_4k on a fake (16, 16) group")
    meshed = run_mesh(dev)
    memory_left(dev, "before the family phases")
    families = {arch: run_family(dev, arch, family_seed(arch)) for arch in FAMILY_ARCHS}

    print(f"times on {CARD}")
    path_metrics = {}
    for name, run, base in (("main path", kern, plain), ("staged path", staged, staged_plain)):
        p50, p99 = percentiles(run["round_s"])
        plain_p50, plain_p99 = percentiles(base["round_s"])
        path_metrics[name] = dict(
            card=CARD,
            decided_values_per_s=run["delivered"] / run["wall"],
            wall_s=run["wall"],
            rounds=len(run["round_s"]),
            round_ms_p50=p50,
            round_ms_p99=p99,
            plain_decided_values_per_s=base["delivered"] / base["wall"],
            plain_wall_s=base["wall"],
            plain_round_ms_p50=plain_p50,
            plain_round_ms_p99=plain_p99,
        )
    for name, run_, base, counts in (
        ("multi-group path", mg, mg_plain, mg_launches),
        ("multi-group path (defaults)", dflt, dflt_plain, dflt_launches),
        ("sharded multi-group path", shd, shd_plain, sh_launches),
    ):
        p50, p99 = percentiles(run_["dispatch_s"])
        plain_p50, plain_p99 = percentiles(base["dispatch_s"])
        path_metrics[name] = dict(
            card=CARD,
            decided_values_per_s=run_["delivered"] / run_["wall"],
            wall_s=run_["wall"],
            dispatches=len(run_["dispatch_s"]),
            dispatch_ms_p50=p50,
            dispatch_ms_p99=p99,
            launches={key: n for key, n in counts.items() if n},
            wave_depths=run_["depths"],
            fold_widths=run_["folds"],
            plain_decided_values_per_s=base["delivered"] / base["wall"],
            plain_wall_s=base["wall"],
            plain_dispatch_ms_p50=plain_p50,
            plain_dispatch_ms_p99=plain_p99,
        )
    path_metrics["sharded multi-group path"]["shard_devices"] = [str(d) for d in mesh.devices]
    path_metrics["sharded multi-group path"]["dispatch_parts_ms_p50"] = shd["parts"]
    for name, run_, base, counts in (
        ("replicated KV", kvr["kvp"], kvr["kvp_plain"], kvr["kv_launches"]),
        ("sharded replicated KV", kvr["kvs"], kvr["kvs_plain"], kvr["kvs_launches"]),
    ):
        plain_ = {f"plain_{k}": v for k, v in kv_metrics(base).items()}
        path_metrics[name] = dict(card=CARD, **kv_metrics(run_, counts), **plain_)
    lm.pop("call_s")
    path_metrics["LM prefill path"] = dict(card=CARD, batch=K9_PATH[0], prompt_tokens=K9_PATH[3],
                                           layers=LM_LAYERS, **lm)  # fmt: skip
    path_metrics["LM prefill against decode"] = dict(
        card=CARD, **{k: v for k, v in lm_decode.items() if k not in ("tokens", "last")}
    )
    path_metrics["LM ring cache"] = dict(card=CARD, **ring)
    path_metrics["LM serving"] = dict(card=CARD, **lm_serve)
    moe.pop("call_s")
    path_metrics["MoE prefill path"] = dict(card=CARD, arch=MOE_ARCH, layers=MOE_LAYERS,
                                            params=n_moe, batch=MOE_K9[0],
                                            prompt_tokens=MOE_K9[3], **moe)  # fmt: skip
    path_metrics["MoE prefill against decode"] = dict(
        card=CARD, capacity_factor=moe_cf,
        **{k: v for k, v in moe_decode.items() if k not in ("tokens", "last")},
    )  # fmt: skip
    path_metrics["MoE serving"] = dict(card=CARD, **moe_serve)
    path_metrics["training"] = dict(card=CARD, **trained["full"])
    path_metrics["training, card against CPU"] = dict(card=CARD, **trained["parity"])
    path_metrics["training example"] = dict(card=CARD, **trained["convergence"])
    path_metrics["training checkpoints"] = dict(card=CARD, **trained["checkpoints"])
    path_metrics["mesh"] = dict(card=CARD, **{k: v for k, v in meshed.items() if k != "dryrun"})
    path_metrics["fabric, world of one"] = dict(card=CARD, **fabric["solo"])
    path_metrics[f"fabric, {FABRIC_RANKS} ranks on one card"] = dict(card=CARD, **fabric["ranks"])
    family_k9 = 0
    for arch, fam in families.items():
        pre = {k: v for k, v in fam["prefill"].items() if k not in ("launches", "call_s")}
        family_k9 += fam["prefill"]["launches"]["K9"]
        path_metrics[f"{arch} prefill path"] = dict(card=CARD, params=fam["params"], **pre)
        path_metrics[f"{arch} prefill against decode"] = dict(card=CARD, **fam["decode"])
        path_metrics[f"{arch} serving"] = dict(card=CARD, **fam["serving"])
    for name, t in times.items():
        print(f"  {name} {json.dumps(t)}")
    row = times["Table 1"]
    print(f"  Table 1, microseconds a message at B = {row['burst']} on {CARD}: "
          + ", ".join(f"{name} {row[name]['us_per_message']}" for name in
                      ("forwarding", "coordinator_sequence", "acceptor_phase2", "learner_quorum")))
    for name, m in path_metrics.items():
        print(f"  {name} {json.dumps(m)}")
    serving = {LM_ARCH: lm_serve, MOE_ARCH: moe_serve,
               **{arch: fam["serving"] for arch, fam in families.items()}}  # fmt: skip
    for name, m in rooflines(lm, moe, families, trained["full"], serving, ring).items():
        print(f"  roofline {name} {json.dumps(m)}")

    rows = [  # name, source, TPU kernel replaced, the path whose launches count
        ("wirepath_round", "wirepath.cu", "src/repro/kernels/wirepath.py:228", launches),
        ("digest", "digest.cu", "src/repro/kernels/digest.py:45", launches),
        ("coordinator_sequence", "coordinator.cu", "src/repro/kernels/coordinator.py:46",
         {"coordinator_sequence": staged_launches["coordinator_sequence"]
          + fabric["launches"]["coordinator_sequence"]}),
        ("acceptor_vote_all", "vote.cu", "src/repro/kernels/wirepath.py:1034", staged_launches),
        ("acceptor_phase2", "vote.cu", "src/repro/kernels/acceptor.py:92",
         {"acceptor_phase2": role_launches["acceptor_phase2"]
          + fabric["launches"]["acceptor_phase2"]}),
        ("learner_quorum", "learner.cu", "src/repro/kernels/learner.py:56", role_launches),
        ("K1-cohort", "wirepath.cu", "src/repro/kernels/wirepath.py:228", mg_launches),
        ("K5", "wirepath.cu", "src/repro/kernels/wirepath.py:524", dflt_launches),
        ("K6", "wirepath.cu", "src/repro/kernels/wirepath.py:780", sh_launches),
        ("K1-shard", "wirepath.cu", "src/repro/kernels/wirepath.py:706", sh_launches),
        ("K9", "flash_attention.cu", "src/repro/kernels/flash_attention.py:96",
         {"K9": lm_launches["K9"] + moe_launches["K9"] + family_k9 + meshed["k9_launches"]}),
    ]  # fmt: skip
    kernels = [
        dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}", replaces=replaces,
             launches=counts[name], max_abs_err=errs[name], ms=times[name]["ms"],
             plain_ms=times[name]["plain_ms"], bound_ms=times[name]["bound_ms"],
             bound_by=times[name]["bound_by"], library_ms=times[name].get("library_ms"))
        for name, src, replaces, counts in rows
    ]  # fmt: skip
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    main()
