"""Host spans of the benchmark's own calls into the program.

Each span is ``(name, start_ns, end_ns)`` on ``time.time_ns()``, the clock
the profiler stamps its events with, so a device idle gap can be named by
what the host was doing (``trace.idle_gaps``).  Kept in memory.
"""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def between(self, t0: int, t1: int) -> list[tuple[str, int, int]]:
        return [s for s in self.items if s[2] > t0 and s[1] < t1]
