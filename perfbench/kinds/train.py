"""Training cells: the port's ``run_loop`` with every step committed by a quorum.

One run is one process on one card.  Set-up makes the weights from the seed
(``harness.weights``), builds the program's train state, its train step
(``make_train_step``, wrapped to record its span and metrics) and the staged
``PaxosContext`` (wrapped to time each commit), warms the consensus kernels
on a context of their own, and drives that same state, step, feed and
context through the cell's first ``CHECK_STEPS`` steps, each one call of
``run_loop``: these steps are the ones the reference follows, and the first
builds cuBLAS's plans and loads the kernels.  The window then calls
``run_loop`` a step at a time until ``seconds`` have passed, and ends at
the end of the last step.

After the window, with the peak memory read and the program's state freed,
the reference trains the same first steps from the same weights and
batches, and ``correct`` compares the two (``harness.checks``) together with
the exact checks of the consensus layer: every step the quorum rule
committed was delivered once, in order, as its ``step:`` record with the
digest of that step's gradients, and nothing else was.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from types import SimpleNamespace

import torch

from perfbench import reference
from perfbench.harness import checks, flops
from perfbench.harness import trace as tracing
from perfbench.harness import traffic as feed
from perfbench.harness import weights as wt
from perfbench.harness.spans import Spans
from perfbench.reference.adamw import Hyper, leaves
from perfbench.reference.decoder import Dims
from perfbench.reference.digest import digest as reference_digest

CHECK_STEPS = 3


@dataclasses.dataclass
class Spec:
    """One run: the cell's files, the seed, the window and where it runs."""

    conf: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # time.perf_counter() at process start


def port_config(conf: dict):
    """The program's configuration of ``conf``: its own model of the same
    family, every size set from the file."""
    from repro_torch.configs import get_config

    base = get_config(conf["port"]["arch"])
    if base.family != "dense":
        raise ValueError(f"{base.name} is a {base.family} model; training cells take dense ones")
    dims = Dims.from_config(conf)
    return dataclasses.replace(
        base,
        n_layers=dims.layers,
        d_model=dims.d_model,
        n_heads=dims.heads,
        n_kv_heads=dims.kv_heads,
        head_dim=dims.head_dim,
        d_ff=dims.d_ff,
        vocab=dims.vocab,
        qk_norm=dims.qk_norm,
        tie_embeddings=dims.tied,
        norm_eps=dims.eps,
        rope_theta=dims.theta,
        local_window=0,
        dtype=conf["torch_dtype"],
        remat=True,
        remat_policy=conf["port"]["remat_policy"],
    )


def _dtype(conf: dict) -> torch.dtype:
    return getattr(torch, conf["torch_dtype"])


def _tree(conf: dict) -> dict:
    return wt.shapes(conf, Dims.from_config(conf).qk_norm)


def hyper(traffic: dict) -> Hyper:
    return Hyper(**traffic["optimizer"])


class Step:
    """The program's train step, its calls recorded as ``step`` spans."""

    def __init__(self, fn, spans: Spans):
        self.fn, self.spans, self.metrics = fn, spans, []

    def __call__(self, state, batch):
        with self.spans("step"):
            state, metrics = self.fn(state, batch)
        self.metrics.append(metrics)
        return state, metrics


class Commits:
    """The context ``run_loop`` commits through: the program's own, each
    ``submit`` and ``pump`` timed on the host (``commit`` spans)."""

    def __init__(self, ctx, spans: Spans):
        self.ctx, self.spans = ctx, spans
        self.seconds: list[float] = []  # submit + pump of each commit

    def submit(self, payload: bytes, group: int = 0) -> int:
        t = time.perf_counter()
        with self.spans("commit"):
            seq = self.ctx.submit(payload, group)
        self.seconds.append(time.perf_counter() - t)
        return seq

    def pump(self, rounds: int = 1) -> None:
        t = time.perf_counter()
        with self.spans("commit"):
            self.ctx.pump(rounds)
        self.seconds[-1] += time.perf_counter() - t


class DigestWitness:
    """While open, the reference's digest arithmetic is applied to the
    gradients each step hands its optimizer, before the update runs.

    The benchmark reads the program through two interfaces besides its
    public calls: a train step hands its gradients to
    ``repro_torch.train.optimizer.update(grads, ...)``, looked up on that
    module at every call, and the train state's ``opt.mu`` holds the first
    moment of every leaf.  A step that stops calling ``update`` so leaves
    its digests unwitnessed, which ``correct`` counts (``digests_unwitnessed``)."""

    def __init__(self):
        self.digests: list[int] = []

    def __enter__(self):
        from repro_torch.train import optimizer

        self.module, self.update = optimizer, optimizer.update

        def update(grads, *args, **kwargs):
            self.digests.append(reference_digest(grads))
            return self.update(grads, *args, **kwargs)

        optimizer.update = update
        return self

    def __exit__(self, *exc):
        self.module.update = self.update


def _launches() -> dict[str, int]:
    from repro_torch.kernels import coordinator, wirepath
    from repro_torch.kernels import flash_attention as k9

    return {"K9": k9.launches, "K3": coordinator.launches, "K2": wirepath.vote_all_launches}


def _norms(tree: dict, scale: float = 1.0) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(x.float())) * scale for k, x in leaves(tree)}


def _record(step: int, digest: int) -> bytes:
    """The log record of a committed step, as the training loop submits it."""
    return b"step:" + step.to_bytes(4, "little") + digest.to_bytes(4, "little", signed=True)


class Program:
    """The system under test, built for one run, and what it reported."""

    def __init__(self, spec: Spec):
        from repro_torch.core import PaxosConfig, PaxosContext
        from repro_torch.models import registry
        from repro_torch.train import optimizer, train_loop

        self.spec, self.spans = spec, Spans()
        self.phases: list[tuple[str, float]] = []  # set-up's parts, host seconds
        self._mark("start", spec.t0)
        conf, tr, dev = spec.conf, spec.traffic, spec.device
        self.cfg = port_config(conf)
        tree = _tree(conf)
        want = {k: tuple(t.shape) for k, t in leaves(registry.param_shapes(self.cfg))}
        got = {k: tuple(_shape_at(tree, k)) for k in wt.paths(tree)}
        if want != got:
            raise RuntimeError(f"the program's parameter tree {want} is not the benchmark's {got}")
        params = wt.make(conf, tree, spec.seed, _dtype(conf), dev)
        self._mark("weights")
        self.state = train_loop.TrainState(
            params=params, opt=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )  # fmt: skip
        self.hp = hyper(tr)
        self.step = Step(train_loop.make_train_step(self.cfg, optimizer.OptConfig(**tr["optimizer"])),
                         self.spans)  # fmt: skip
        self.feed = feed.Feed(spec.seed, tr["batch"], tr["seq_len"], conf["vocab_size"], self.spans)
        paxos = PaxosConfig(**tr["paxos"])
        warm = PaxosContext(paxos, device=dev)  # loads and launches the consensus kernels
        warm.submit(b"warm")
        warm.run_until_quiescent()
        self._mark("consensus_warmup")
        self.ctx = PaxosContext(paxos, device=dev)
        self.commits = Commits(self.ctx, self.spans)
        self.loop = train_loop
        self.loop_cfg = train_loop.LoopConfig(
            steps=1, commit_quorum=tr["commit_quorum"], replica_groups=tr["replica_groups"],
            straggler_prob=tr["straggler_prob"],
        )  # fmt: skip
        self.losses: list[float] = []
        self.committed: list[bool] = []
        self.straggled: list[int] = []
        self.chunks = 0

    def _mark(self, name: str, since: float | None = None) -> None:
        """Record a set-up part that ends now: ``since`` or the last part's end."""
        now = time.perf_counter()
        if since is None:
            since = self._last
        self._last = now
        self.phases.append((name, now - since))

    def one_step(self) -> None:
        self.state, hist = self.loop.run_loop(
            self.cfg, self.state, self.feed, loop=self.loop_cfg, train_step=self.step,
            paxos_ctx=self.commits, rng_seed=feed.chunk_seed(self.spec.seed, self.chunks),
        )  # fmt: skip
        self.chunks += 1
        self.losses += hist["loss"]
        self.committed += hist["committed"]
        self.straggled += hist["straggled"]

    def first_steps(self) -> tuple[reference.Readings, list[int]]:
        """The compared steps; returns the program's readings and the
        reference's digests of each step's gradients."""
        b1 = self.hp.b1
        with DigestWitness() as witness:
            grad1 = {}
            for i in range(CHECK_STEPS):
                self.one_step()
                self._mark(f"step{i + 1}")
                if i == 0:
                    grad1 = _norms(self.state.opt.mu, 1.0 / (1.0 - b1))
        conf, tree, dev = self.spec.conf, _tree(self.spec.conf), self.spec.device
        delta = {}
        for k, p in leaves(self.state.params):
            p0 = wt.leaf(conf, tree, k, self.spec.seed, _dtype(conf), dev)
            delta[k] = float(torch.linalg.vector_norm(p.float() - p0.float()))
            del p0
        self._mark("readings")
        return reference.Readings(self.losses[:CHECK_STEPS], grad1, delta), witness.digests

    def digests(self) -> list[int]:
        return [int(m["digest"]) for m in self.step.metrics]

    def consensus_faults(self) -> int:
        """Steps whose commit or record differs from the quorum rule's: the
        groups' abstentions drawn again from the seeds the loop was given,
        the commit decided by the quorum, and the delivered ``step:``
        records, in order, against the committed steps' records."""
        tr = self.spec.traffic
        faults = 0
        for c in range(self.chunks):
            drawn = feed.abstentions(feed.chunk_seed(self.spec.seed, c), tr["replica_groups"],
                                     tr["straggler_prob"])  # fmt: skip
            quorum = tr["replica_groups"] - drawn >= tr["commit_quorum"]
            faults += drawn != self.straggled[c] or quorum != self.committed[c]
        self.ctx.run_until_quiescent()  # a record delivered late is late, not wrong
        got = [p for _, p in self.ctx.delivered_log]
        want = [_record(i + 1, d)
                for i, (c, d) in enumerate(zip(self.committed, self.digests())) if c]  # fmt: skip
        faults += sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))
        return faults


def _shape_at(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def reference_batches(spec: Spec) -> list[tuple[torch.Tensor, torch.Tensor]]:
    tr = spec.traffic
    out = []
    for i in range(CHECK_STEPS):
        b = feed.batch_at(spec.seed, i, tr["batch"], tr["seq_len"], spec.conf["vocab_size"])
        out.append(tuple(torch.from_numpy(b[k]).to(spec.device) for k in ("tokens", "labels")))
    return out


def reference_readings(spec: Spec, prec=None, half_batch: bool = False) -> reference.Readings:
    """The reference's first steps from the run's weights and batches;
    ``prec`` the control's precision, ``half_batch`` a planted fault."""
    conf = spec.conf
    kw = {"prec": prec} if prec is not None else {}
    params = wt.make(conf, _tree(conf), spec.seed, _dtype(conf), spec.device)
    return reference.train(Dims.from_config(conf), hyper(spec.traffic), params,
                           reference_batches(spec), half_batch=half_batch, **kw)  # fmt: skip


def card_state() -> dict:
    """The card's power limit, and its SM clock, power draw, temperature and
    active throttle reasons as ``nvidia-smi`` reads them now (one sample)."""
    fields = ["power.limit", "clocks.sm", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active"]  # fmt: skip
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)  # fmt: skip
        values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return {}
    return dict(zip(fields, values, strict=False))


def run(spec: Spec, metric_readers: dict) -> dict:
    """One run of a training cell; returns the result line's fields, the
    numbers compared last (``checks``)."""
    dev, tr, conf = spec.device, spec.traffic, spec.conf
    on_card = dev.type == "cuda"
    prog = Program(spec)
    ours, witnessed = prog.first_steps()
    if on_card:
        torch.cuda.synchronize(dev)
    profiler = None
    if spec.trace:
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.start()
    before = _launches()
    commits_before = len(prog.commits.seconds)
    w0_ns, w0 = time.time_ns(), time.perf_counter()
    setup_s = w0 - spec.t0
    steps, step_s, last = 0, [], w0
    while True:
        prog.one_step()
        steps += 1
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        if now - w0 >= spec.seconds:
            break
    window_s = now - w0  # to the end of the last step
    w1_ns = time.time_ns()
    card = card_state() if on_card else {}
    launched = {k: v - before[k] for k, v in _launches().items()}
    trace = None
    if profiler is not None:
        torch.cuda.synchronize(dev)
        profiler.stop()
        trace = tracing.read(tracing.device_events(profiler), (w0_ns, w1_ns),
                             prog.spans.between(w0_ns, w1_ns))  # fmt: skip
        del profiler
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    window_commits = prog.commits.seconds[commits_before:]

    digests = prog.digests()
    numbers: dict[str, float] = {}
    numbers["nonfinite_losses"] = sum(not math.isfinite(x) for x in prog.losses)
    numbers["digests_unwitnessed"] = abs(CHECK_STEPS - len(witnessed))
    numbers["digest_mismatches"] = sum(a != b for a, b in zip(witnessed, digests[:CHECK_STEPS]))
    numbers["commit_faults"] = prog.consensus_faults()
    if on_card:
        layers = conf["num_hidden_layers"]
        # at least one K9 launch a layer a step: the attention runs on the kernel
        numbers["k9_launches_short"] = max(0, layers * steps - launched["K9"])
        numbers["consensus_kernels_missing"] = (
            (launched["K3"] == 0) + (launched["K2"] == 0) if window_commits else 0
        )
    setup_phases = {name: s for name, s in prog.phases}
    attempted = len(prog.losses)
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    theirs = reference_readings(spec)
    numbers |= checks.gaps(ours, theirs)
    limits = {k: 0 for k in numbers} | {k: v["limit"] for k, v in spec.limits.items()}
    correct, rows = checks.judge(numbers, limits)

    run_view = SimpleNamespace(
        steps=steps, tokens=steps * tr["batch"] * tr["seq_len"], window_s=window_s,
        setup_s=setup_s, peak_bytes=peak, commit_s=window_commits, trace=trace,
        dense=flops.Dense.from_config(conf), batch=tr["batch"], seq_len=tr["seq_len"],
    )  # fmt: skip
    metrics = {}
    for name, (unit, read) in metric_readers.items():
        value = read(run_view)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
        "power_limit_w": float(card["power.limit"]) if "power.limit" in card else None,
        "after_window": card,
    }
    result = {"correct": correct, "attempted": attempted,
              "failed": int(numbers["nonfinite_losses"] + numbers["commit_faults"]),
              "metrics": metrics, "device": device}  # fmt: skip
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.top_gaps()}
    result["setup_phases"] = setup_phases
    result["window_steps_s"] = step_s
    result["checks"] = rows
    return result
