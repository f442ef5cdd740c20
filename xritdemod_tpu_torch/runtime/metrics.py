"""Receive-pipeline metrics and profiling (first-class, unlike the
reference's cout prints — SURVEY.md §5 'Tracing/profiling: none').

`PipelineMetrics` tracks per-stage throughput (samples/symbols/frames per
second over a sliding window) and exposes a one-line summary; it is the JAX
package's, copied.  `trace` wraps a region in a `torch.profiler` trace
(host and, on a CUDA device, kernel time) written as a Chrome trace for
offline analysis (chrome://tracing or Perfetto).

The program's own spans and counters (`span`, `add`, `count`, read out by
`recorded`, emptied by `clear`) are recorded only while a `torch.profiler`
session records: `trace` here, or any other profiler a caller opens.  The
receive path opens them at its layer boundaries (`rx.*` in the fused step,
`fold.*` in the fold path).  With no profiler recording, `span` returns one
shared null context: it allocates nothing, creates no CUDA event and
launches nothing, and `count` keeps nothing.

A span is not a `record_function` range: such a range also shows on the
card as an annotation, which a reader of the device's timeline would count
as busy time over the idle gaps inside it.  A span stamps its host start
and end on the clock the profiler stamps its host events with (Unix-epoch
ns, `time.time_ns`) and, once the process has initialised CUDA, records a
pair of timing events on the current stream, read only when the recorder
is read.  A counter keeps a reference to a tensor the boundary already
produced and reduces it only when read, so a step gets no extra kernel and
no host read.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

__all__ = ["PipelineMetrics", "trace", "SpanRecorder", "RECORDER", "span", "add", "count",
           "recorded", "clear", "clock"]


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


# -- the program's spans and counters -------------------------------------------

clock = time.time_ns        # the profiler's host clock (Unix-epoch ns)
_OFF = contextlib.nullcontext()


def _sum(t) -> int:
    return int(t.sum())


class _Span:
    __slots__ = ("id", "unit", "parent", "name", "attrs", "start_ns", "end_ns", "events")

    def __init__(self, sid, unit, parent, name, attrs, start_ns, end_ns=None, events=None):
        self.id, self.unit, self.parent, self.name, self.attrs = sid, unit, parent, name, attrs
        self.start_ns, self.end_ns, self.events = start_ns, end_ns, events

    def row(self) -> dict:
        device_ms = None
        if self.events is not None and self.end_ns is not None:
            try:
                device_ms = self.events[0].elapsed_time(self.events[1])
            except RuntimeError:        # its two events on two devices
                pass
        return dict(id=self.id, unit=self.unit.id, parent=self.parent, name=self.name,
                    attrs=self.attrs, start_ns=self.start_ns, end_ns=self.end_ns,
                    device_ms=device_ms)


class _Unit:
    """The spans (in the order they opened) and counters of one root span:
    a receiver step, or a fold path's `process` call."""
    __slots__ = ("id", "spans", "counters")

    def __init__(self, uid):
        self.id, self.spans, self.counters = uid, [], []


class _Open:
    """A span being recorded (the context `SpanRecorder.span` returns while
    a profiler records)."""
    __slots__ = ("rec", "span")

    def __init__(self, rec: "SpanRecorder", name: str, attrs):
        self.rec = rec
        self.span = rec._new(name, attrs)

    def __enter__(self):
        sp = self.span
        if torch.cuda.is_initialized():
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        self.rec._stack().append(sp)
        sp.start_ns = clock()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.end_ns = clock()
        if sp.events is not None:
            sp.events[1].record()
        self.rec._stack().pop()
        return False


class SpanRecorder:
    """Spans and counters in memory, the last `units` units (root spans)
    kept.  Span ids are unique in the recorder and increase: a root span's
    id is its unit's id (a step's, a call's).  Recording follows the
    profiler (see the module's docstring); spans nest by thread."""

    def __init__(self, units: int = 256):
        self._units: deque = deque(maxlen=units)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._last = 0

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new(self, name: str, attrs, start_ns=None, end_ns=None) -> _Span:
        stack = self._stack()
        sid = self._last = next(self._ids)
        if stack:
            parent = stack[-1]
            unit, pid = parent.unit, parent.id
        else:
            unit, pid = _Unit(sid), None
            with self._lock:
                self._units.append(unit)
        sp = _Span(sid, unit, pid, name, attrs, start_ns, end_ns)
        unit.spans.append(sp)
        return sp

    def span(self, name: str, attrs=None):
        """A context that records the span `name` (with `attrs`, any object,
        kept as it is) under the innermost open span, or the shared null
        context when no profiler records."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, attrs)

    def add(self, name: str, start_ns: int, end_ns: int, attrs=None) -> None:
        """Record a closed host-only span from stamps the caller took with
        `clock` (so that a total the caller keeps from the same stamps and
        the spans always agree)."""
        if _profiler._is_profiler_enabled:
            self._new(name, attrs, start_ns, end_ns)

    def count(self, name: str, value, reduce=_sum) -> None:
        """Add `reduce(value)` to the counter `name` of the innermost open
        span's unit, reduced when read: `value` is kept as it is (a tensor
        the caller already has; no kernel now)."""
        if not _profiler._is_profiler_enabled:
            return
        stack = self._stack()
        if stack:
            stack[-1].unit.counters.append((name, value, reduce))

    def recorded(self, since: int = 0) -> dict:
        """`{"spans": [row, ...], "counters": {name: total}, "units": n}`
        over the kept units whose id is above `since`.  A row holds `id`,
        `unit`, `parent`, `name`, `attrs`, `start_ns`, `end_ns` (None while
        open) and `device_ms` (CUDA events; None without them).  Waits for
        the device where a span has events."""
        with self._lock:
            units = [u for u in self._units if u.id > since]
        spans = [sp for u in units for sp in u.spans]
        if any(sp.events is not None for sp in spans):
            torch.cuda.synchronize()
        counters: dict = {}
        for u in units:
            for name, value, reduce in u.counters:
                counters[name] = counters.get(name, 0) + reduce(value)
        return {"spans": [sp.row() for sp in spans], "counters": counters,
                "units": len(units)}

    def last_id(self) -> int:
        """The last span id given (a mark for `recorded(since=)`)."""
        return self._last

    def clear(self) -> None:
        with self._lock:
            self._units.clear()


RECORDER = SpanRecorder()
span = RECORDER.span
add = RECORDER.add
count = RECORDER.count
recorded = RECORDER.recorded
clear = RECORDER.clear


TRACE_FILE = "xrit_trace.json"


# Thread id of the rows that hold the program's spans in a Chrome trace
# ("XRIT" in ASCII: apart from the profiler's own threads and streams).
SPAN_TID = 0x58524954


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """`torch.profiler` trace of the block, CPU activity and, when a CUDA
    device is present, its kernels; written as a Chrome trace,
    `xrit_trace.json`, inside the directory `log_dir` (default
    `xrit_trace` in the temporary directory; made if missing).  The
    program's spans recorded in the block (`span`) are rows of their own in
    the same file, on the trace's clock, each with its id, unit, parent and
    device ms, and the counters' totals a counter row at the block's end.
    Yields the directory, as the reference's profiler context does."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "xrit_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    mark = RECORDER.last_id()
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _append_spans(path, RECORDER.recorded(since=mark))


def _append_spans(path: str, rec: dict) -> None:
    """The recorder's rows appended to the Chrome trace at `path`: its
    timestamps are microseconds after `baseTimeNanoseconds` (Unix-epoch ns;
    0 where the file does not name it)."""
    spans = [r for r in rec["spans"] if r["end_ns"] is not None]
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    us = lambda ns: (ns - base) / 1e3
    rows = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
             "args": {"name": "xrit spans"}}]
    for r in spans:
        rows.append({"ph": "X", "cat": "xrit_span", "name": r["name"], "pid": pid,
                     "tid": SPAN_TID, "ts": us(r["start_ns"]),
                     "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                     "args": {k: r[k] for k in ("id", "unit", "parent", "device_ms", "attrs")}})
    if rec["counters"]:
        rows.append({"ph": "C", "name": "xrit counters", "pid": pid, "tid": SPAN_TID,
                     "ts": us(max(r["end_ns"] for r in spans)), "args": rec["counters"]})
    doc["traceEvents"] = doc.get("traceEvents", []) + rows
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
