"""Wall-time accounting of host-side call sites.

Counterpart of ceres_tpu/utils/timing.py: ExecutionSummary and its
scoped timer (the reference's execution_summary.h:44-70, per call site
wall time and call count) and EventLogger (wall_time.h:76, phases within
one call). CUDA work runs asynchronously, so a timer that should cover
it is given a tensor (or tensors) to wait for: the timer synchronises
the CUDA device each lies on before it reads the clock (the JAX package
calls block_until_ready there). For device time by kernel use
torch.profiler or CUDA events (scripts/profile_torch_solve.py).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class CallStatistics:
    __slots__ = ("time", "calls")

    def __init__(self):
        self.time = 0.0
        self.calls = 0


def synchronize(tensors):
    """Wait for the CUDA devices of `tensors` (a tensor, or a list, tuple
    or dict of them; anything else is passed over)."""
    if torch.is_tensor(tensors):
        if tensors.is_cuda:
            torch.cuda.synchronize(tensors.device)
    elif isinstance(tensors, dict):
        synchronize(list(tensors.values()))
    elif isinstance(tensors, (list, tuple)):
        for t in tensors:
            synchronize(t)


class ExecutionSummary:
    """execution_summary.h:44: name -> (total seconds, call count)."""

    def __init__(self):
        self._stats: Dict[str, CallStatistics] = defaultdict(CallStatistics)

    def record(self, name: str, seconds: float):
        s = self._stats[name]
        s.time += seconds
        s.calls += 1

    def statistics(self) -> Dict[str, CallStatistics]:
        return dict(self._stats)

    @contextlib.contextmanager
    def scoped_timer(self, name: str, block_on=None):
        """ScopedExecutionTimer (execution_summary.h:64); block_on: the
        tensors whose CUDA device the timer waits for at the end."""
        t0 = time.time()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            self.record(name, time.time() - t0)

    def report(self) -> str:
        lines = [f"{'call site':<40}{'calls':>8}{'total s':>12}"
                 f"{'mean ms':>12}"]
        for name in sorted(self._stats):
            s = self._stats[name]
            mean_ms = 1e3 * s.time / max(s.calls, 1)
            lines.append(f"{name:<40}{s.calls:>8}{s.time:>12.4f}"
                         f"{mean_ms:>12.3f}")
        return "\n".join(lines)


class EventLogger:
    """wall_time.h:76: sequential phase timing inside one call."""

    def __init__(self, name: str, sink=None):
        self.name = name
        self.sink = sink            # callable(str) or None
        self.t_start = time.time()
        self.t_last = self.t_start
        self.events = []

    def add_event(self, event: str):
        now = time.time()
        self.events.append((event, now - self.t_last, now - self.t_start))
        self.t_last = now
        if self.sink:
            self.sink(f"{self.name}: {event} "
                      f"{self.events[-1][1] * 1e3:.2f}ms "
                      f"(cum {self.events[-1][2] * 1e3:.2f}ms)")

    def total(self) -> float:
        return time.time() - self.t_start
