"""Throughput instrumentation.

* :class:`StageTimes` aggregates per-stage host seconds and item counts
  (clips/s per stage); each stage is also a ``record_function`` span, so
  it names its part of a profiler trace;
* :func:`profile_to` captures a ``torch.profiler`` trace of a block and
  writes it to ``<logdir>/trace.json`` (chrome trace format: open it in
  Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

from torch.profiler import ProfilerActivity, profile, record_function


class StageTimes:
    def __init__(self):
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.counts[name] += items

    def throughput(self, name: str) -> float:
        sec = self.seconds.get(name, 0.0)
        return self.counts.get(name, 0) / sec if sec > 0 else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(self.seconds[name], 4),
                "items": self.counts[name],
                "items_per_sec": round(self.throughput(name), 4),
            }
            for name in self.seconds
        }


@contextlib.contextmanager
def profile_to(logdir: str, cuda: bool):
    """Trace the block (host activity, and the card's with ``cuda``) into
    ``logdir/trace.json``."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
