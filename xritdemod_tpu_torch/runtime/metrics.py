"""Receive-pipeline metrics and profiling (first-class, unlike the
reference's cout prints — SURVEY.md §5 'Tracing/profiling: none').

`PipelineMetrics` tracks per-stage throughput (samples/symbols/frames per
second over a sliding window) and exposes a one-line summary; it is the JAX
package's, copied.  `trace` wraps a region in a `torch.profiler` trace
(host and, on a CUDA device, kernel time) written as a Chrome trace for
offline analysis (chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque

__all__ = ["PipelineMetrics", "trace"]


class _Rate:
    def __init__(self, window: float = 10.0):
        self.window = window
        self._events: deque[tuple[float, int]] = deque()
        self.total = 0

    def add(self, count: int) -> None:
        now = time.monotonic()
        self._events.append((now, count))
        self.total += count
        cutoff = now - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        if span <= 0:
            return 0.0
        return sum(c for _, c in list(self._events)[1:]) / span


class PipelineMetrics:
    """Counters for the receive chain: samples in, symbols out, frames."""

    def __init__(self, window: float = 10.0):
        self.samples = _Rate(window)
        self.symbols = _Rate(window)
        self.frames = _Rate(window)
        self.start = time.monotonic()

    def add_samples(self, n: int) -> None:
        self.samples.add(n)

    def add_symbols(self, n: int) -> None:
        self.symbols.add(n)

    def add_frames(self, n: int) -> None:
        self.frames.add(n)

    def summary(self) -> str:
        el = time.monotonic() - self.start
        return (
            f"[{el:7.1f}s] {self.samples.rate() / 1e6:8.2f} Msamp/s  "
            f"{self.symbols.rate() / 1e3:8.1f} ksym/s  "
            f"{self.frames.rate():6.1f} frames/s  "
            f"(totals: {self.samples.total} samp, {self.frames.total} frames)"
        )


TRACE_FILE = "xrit_trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """`torch.profiler` trace of the block, CPU activity and, when a CUDA
    device is present, its kernels; written as a Chrome trace,
    `xrit_trace.json`, inside the directory `log_dir` (default
    `xrit_trace` in the temporary directory; made if missing).  Yields the
    directory, as the reference's profiler context does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "xrit_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
