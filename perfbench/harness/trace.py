"""What the profiler saw on the card over the window.

The traced run profiles the window with CUDA activity only (CUPTI's
kernels, copies and sets, and the runtime calls), which costs the host
about a microsecond a launch, and reads the events in memory: nothing is
written to disk.  ``Trace`` keeps what the per-layer readers and the
breakdown need: the device's busy intervals, each kernel's launches and
time, and the idle gaps named by the host span they fall in.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

COPIES = ("Memcpy", "Memset")  # the names CUPTI gives copies and sets
NAME_CHARS = 160  # a kernel's name in the breakdown: templated names run to thousands

# what the host was doing after each of the benchmark's own spans ended: the
# training loop uploads the batch after drawing it, reads the loss and the
# digest back after the step, and keeps its books after the commit
AFTER = {"data": "upload", "step": "readback", "commit": "loop"}


@dataclasses.dataclass
class Trace:
    window_ns: tuple[int, int]
    busy_ns: int
    kernels: dict[str, tuple[int, int]]  # name -> (launches, device ns)
    gaps_by_phase: dict[str, int]  # host phase -> idle device ns
    events: int

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:NAME_CHARS], ns / 1e9] for name, (_, ns) in rows]

    def top_gaps(self, n: int = 10) -> list[list]:
        rows = sorted(self.gaps_by_phase.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in rows]


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _phase(spans: list[tuple[str, int, int]], starts: list[int], t: int) -> str:
    """The host phase at ``t``: the span that holds it, or what follows the
    span before it (the spans do not overlap)."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0:
        return "harness"
    name, _, end = spans[i]
    return name if t < end else AFTER.get(name, "harness")


def device_events(profiler) -> list[tuple[str, int, int]]:
    """``(name, start_ns, duration_ns)`` of every kernel, copy and set that a
    stopped ``torch.profiler.profile`` saw on a CUDA device."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in profiler.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]  # fmt: skip


def read(events, window_ns: tuple[int, int], spans: list[tuple[str, int, int]]) -> Trace:
    """``events``: ``device_events``; ``window_ns``: the window on
    ``time.time_ns()``; ``spans``: the benchmark's host spans."""
    w0, w1 = window_ns
    intervals, kernels = [], collections.defaultdict(lambda: [0, 0])
    for name, start, dur in events:
        a, b = max(start, w0), min(start + dur, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        if not name.startswith(COPIES):
            k = kernels[name]
            k[0] += 1
            k[1] += b - a
    busy = _merge(intervals)
    gaps = collections.Counter()
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_phase(spans, starts, (a + b) // 2)] += b - a
    return Trace(
        window_ns=window_ns,
        busy_ns=sum(b - a for a, b in busy),
        kernels={name: (n, ns) for name, (n, ns) in kernels.items()},
        gaps_by_phase=dict(gaps),
        events=len(intervals),
    )
