"""Tracing / profiling utilities (SURVEY.md §5 "Tracing").

The reference's only instrumentation is cv::getTickCount deltas and couts
(rotate_image_test.cpp:58-94). Here:

  - `annotate(name)`: jax.profiler trace annotation + named scope, so stages
    show up named in xprof traces;
  - `trace(dir)`: context manager around jax.profiler.start_trace for
    capturing a device trace (view with xprof/tensorboard);
  - `StageTimer`: wall-clock stage timing; block on a stage's result
    before it closes, or the time is only the dispatch.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import jax


def annotate(name: str):
    """Combined profiler/trace annotation context."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace into log_dir (xprof format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates wall-clock per stage; `block=True` forces completion of a
    representative output before stopping the clock."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
