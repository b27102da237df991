"""Drive the port's single-group CAANS service on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The quickest proof that the PyTorch port starts and is right on the card.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and builds the
kernels from ``src/repro_torch/csrc`` on first use.  It prints, in order:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the kernels' build time;
3. the kernel phase: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at adversarial windows, bit for bit;
4. the main path: ``PaxosContext(PaxosConfig(), fused=True, use_kernels=True,
   snapshots=True)`` on the card under a seeded lossy ``SimNet``, with ring
   wrap under reclamation, snapshots, an acceptor kill and revive, a crash
   and restore, and a coordinator failover and restore; the same schedule on
   the plain engine must give the same logs, seals and final state, and
   every seal is folded again by K4's plain version and must agree;
5. times: each kernel by CUDA events at the main path's shapes beside its
   bound and its plain version, and the main path's decided values/s and
   per-round latency;
6. the ``kernels`` JSON line, then the ``ok`` JSON line last.

Any failure raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import FaultSpec, PaxosConfig, PaxosContext, SimNet  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.bridge import export_state  # noqa: E402
from repro_torch.core.types import AcceptorState, CoordinatorState  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import digest as k_digest  # noqa: E402
from repro_torch.kernels import wirepath as k_wirepath  # noqa: E402

SEED = 20160519
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # no int32 row in the data sheet: the f32 non-tensor rate

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
    ]
    rng = np.random.default_rng(SEED)
    worst = 0
    for case in cases:
        state, values, active, alive, limit = round_inputs(
            rng, case["a"], n, v, case["b"], case["base"], case["crnd"], case["alive"],
            case["limit"], dev,
        )  # fmt: skip
        twin = clone_state(state)
        ptrs = [t.data_ptr() for t in (*vars(state["stack"]).values(), *vars(state["lstate"]).values())]
        got = ops.fused_round(**state, values=values, active=active, alive=alive, quorum=case["a"] // 2 + 1, reclaim_limit=limit)  # fmt: skip
        want = batched.fused_round(**twin, values=values, active=active, alive=alive, quorum=case["a"] // 2 + 1, reclaim_limit=limit)  # fmt: skip
        torch.cuda.synchronize()
        st, ls = got[1], got[2]
        if [t.data_ptr() for t in (*vars(st).values(), *vars(ls).values())] != ptrs:
            raise AssertionError("K1 did not update the state in place")
        err = max_abs_err(round_outputs(got), round_outputs(want))
        print(f"  K1 {case}: max_abs_err={err}")
        if err:
            raise AssertionError(f"K1 disagrees with its plain version: {case}")
        worst = max(worst, err)
    return worst


def check_k4(dev, n: int = 1 << 16, v: int = 16) -> int:
    """K4 against ``digest_plain`` on odd lengths and on the leaf lengths of
    the main path's seals: after slice s the prefix holds about s*N/4
    instances and s*N/4*V value words."""
    rng = np.random.default_rng(SEED + 1)
    worst = 0
    seal_leaves = [s * n // 4 * w for s in range(1, 7) for w in (1, v)]
    for n in (524_287, 524_289, 16_384 * 17, 1, 0, *seal_leaves):
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                x = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int32))
            else:
                x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            x = x.to(dev)
            got, want = k_digest.digest(x), k_digest.digest_plain(x)
            err = abs(int(got) - int(want))
            print(f"  K4 n={n} {dtype}: {int(got)} vs {int(want)}")
            if err:
                raise AssertionError(f"K4 disagrees with its plain version at n={n} {dtype}")
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


def bound_ms(nbytes: float, ops_: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bytes(a: int, b: int, v: int) -> int:
    """The bytes one K1 launch reads and writes when every lane is accepted
    by all A acceptors and is fresh, as on the main path with every acceptor
    alive.  Reads: the promised rounds rnd (A*B*4), the learner's delivered
    flag and instance (2*B*4), the burst (B*V*4), alive (A) and the
    watermark and round (8).  Writes: rnd, vrnd and V value words of each
    acceptor (A*B*(2+V)*4), the learner's flag, instance and value words
    (B*(2+V)*4), and the outputs: the new watermark (4), inst and win
    (2*B*4), fresh (B) and value (B*V*4).  vrnd, the acceptors' values and
    the learner's values are written, never read, so they count once.  At
    A=3, B=128, V=16: 10,763 B read + 46,212 B written = 56,975 B."""
    read = a * b * 4 + 2 * b * 4 + b * v * 4 + a + 8
    written = a * b * (2 + v) * 4 + b * (2 + v) * 4 + 4 + 2 * b * 4 + b + b * v * 4
    return read + written


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
    # per lane: a compare, an and, a select and a max per acceptor; the
    # agree count; the slot, the permit and the dedup test; the V selects
    ops_ = b * (4 * a + 2 * a + 8 + v)
    bms, by = bound_ms(nbytes, ops_)
    out = dict(
        ms=time_walk(kernel, walk, True, restore),
        plain_ms=time_walk(plain, walk, True, restore),
        eager_ms=time_walk(kernel, walk, False, restore),
        plain_eager_ms=time_walk(plain, walk, False, restore),
        bound_ms=bms, bound_by=by, bytes_per_launch=nbytes,
    )  # fmt: skip
    restore()
    return out


def time_k4(dev, n_leaf: int) -> dict:
    """The seal of one N/4-instance snapshot: insts (K,) and values (K, V)."""
    rng = np.random.default_rng(SEED + 4)
    leaves = [
        torch.from_numpy(rng.integers(0, 1 << 20, n_leaf, dtype=np.int32)).to(dev),
        torch.from_numpy(rng.integers(-(2**31), 2**31, (n_leaf, 16), dtype=np.int32)).to(dev),
    ]
    big = leaves[1]
    nbytes = big.numel() * 4 + 4
    bms, by = bound_ms(nbytes, 2 * big.numel())
    return dict(
        ms=time_walk(lambda _: k_digest.digest(big), 50, True),
        plain_ms=time_walk(lambda _: k_digest.digest_plain(big), 50, True),
        bound_ms=bms,
        bound_by=by,
        eager_ms=time_walk(lambda _: k_digest.digest(big), 50, False),
        seal_ms=time_walk(lambda _: ops.tree_digest(leaves), 50, False),
        nbytes=nbytes,
    )


def main() -> None:
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    CARD = card_line()
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    build_s = _build.build_all()
    print(f"build: {build_s:.3f} s for {', '.join(_build.sources())}")
    for name in _build.sources():
        print(f"--- nvcc {name} ---\n{_build.build_log(name).strip()}")

    print("kernel phase: each kernel against its plain version on the card")
    k1_err = check_k1(dev)
    k4_err = check_k4(dev)
    # timed here, before the main path, and printed after it
    t1 = time_k1(dev)
    t4 = time_k4(dev, PaxosConfig().n_instances // 4)

    print("main path: PaxosContext(PaxosConfig(), fused=True, use_kernels=True, snapshots=True)")
    k_wirepath.launches = 0
    k_digest.launches = 0
    kern = run_main_path(True, dev)
    launches = {"wirepath_round": k_wirepath.launches, "digest": k_digest.launches}
    print(f"  launches on the main path: {launches}, fused rounds: {kern['rounds']}")
    if launches["wirepath_round"] != kern["rounds"] or launches["digest"] == 0:
        raise AssertionError(f"the main path did not run through every kernel: {launches}")
    print("  the same schedule on the plain engine (use_kernels=False) on the card")
    plain = run_main_path(False, dev)
    for key in ("delivered_log", "full_log", "seals"):
        if kern[key] != plain[key]:
            raise AssertionError(f"kernel and plain runs differ in {key}")
    for key, arr in kern["state"].items():
        if not np.array_equal(arr, plain["state"][key]):
            raise AssertionError(f"kernel and plain runs differ in final state {key}")
    k4_err = max(k4_err, check_seals(kern, dev))
    print(f"  equal: delivered logs ({len(kern['delivered_log'])}), full logs "
          f"({kern['delivered']}), seals {kern['seals']}, final state")  # fmt: skip
    print(f"  ring laps {kern['ring_laps']:.3f}, stats {kern['stats']}")

    print(f"times on {CARD}")
    rs = np.asarray(kern["round_s"]) * 1e3
    prs = np.asarray(plain["round_s"]) * 1e3
    main_metrics = dict(
        card=CARD,
        decided_values_per_s=kern["delivered"] / kern["wall"],
        wall_s=kern["wall"],
        rounds=kern["rounds"],
        round_ms_p50=float(np.percentile(rs, 50)),
        round_ms_p99=float(np.percentile(rs, 99)),
        plain_decided_values_per_s=plain["delivered"] / plain["wall"],
        plain_round_ms_p50=float(np.percentile(prs, 50)),
        plain_round_ms_p99=float(np.percentile(prs, 99)),
    )
    print(f"  K1 {json.dumps(t1)}")
    print(f"  K4 {json.dumps(t4)}")
    print(f"  main path {json.dumps(main_metrics)}")

    kernels = [
        dict(name="wirepath_round", route="cuda", source="src/repro_torch/csrc/wirepath.cu",
             replaces="src/repro/kernels/wirepath.py:228", launches=launches["wirepath_round"],
             max_abs_err=k1_err, ms=t1["ms"], plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
             bound_by=t1["bound_by"], library_ms=None),
        dict(name="digest", route="cuda", source="src/repro_torch/csrc/digest.cu",
             replaces="src/repro/kernels/digest.py:45", launches=launches["digest"],
             max_abs_err=k4_err, ms=t4["ms"], plain_ms=t4["plain_ms"], bound_ms=t4["bound_ms"],
             bound_by=t4["bound_by"], library_ms=None),
    ]  # fmt: skip
    print(json.dumps({"kernels": kernels}))
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


if __name__ == "__main__":
    main()
