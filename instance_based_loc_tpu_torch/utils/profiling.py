"""Per-stage wall-clock timing (counterpart of `StageTimer` in
`instance_based_loc_tpu/utils/profiling.py`)."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock time per named stage across frames.
    Thread-safe: the chunked memory build detects on a worker thread.

    with timer.stage("build.detect"):
        ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    # a lock neither pickles nor deep-copies; timers ride inside memories
    def __getstate__(self):
        return {"totals": dict(self.totals), "counts": dict(self.counts)}

    def __setstate__(self, state):
        self.totals = defaultdict(float, state["totals"])
        self.counts = defaultdict(int, state["counts"])
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            avg = self.totals[name] / max(self.counts[name], 1)
            lines.append(f"{name}: total {self.totals[name]:.3f}s, "
                         f"n={self.counts[name]}, avg {avg * 1000:.1f}ms")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name]}
                for name in self.totals}
