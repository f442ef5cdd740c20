"""The traced run: the benchmark's own host spans and the card's timeline.

With `--trace 1` a `torch.profiler` window opens `START` hand-overs into
the timed window and closes `BLOCKS` hand-overs later (the window runs on
until it has).  The benchmark's spans around its calls into the program
(`source`, `issue`, `deliver`, `wait`, `gate`, `process`) are
`record_function` ranges.  On the card a unit of work (a site's block, an
archive's capture) ends with its group of copies to host memory; the traced
window is taken from the end of the first such group to the end of the
last, so it holds whole units only.  `Trace` is what the per-layer readers under
`benchmark/metrics/` read.
"""

from __future__ import annotations

import contextlib
import fnmatch
import json
from pathlib import Path

SPANS = ("source", "issue", "deliver", "wait", "gate", "process")
START = 16           # hand-overs before the profiler opens
BLOCKS = 32          # hand-overs it stays open
NAME = 160           # characters of an operation's name in the breakdown
LAYERS = Path(__file__).resolve().parent.parent / "layers.json"


class Spans:
    def __init__(self, on: bool, group: int, steps: int = 1, units: int = BLOCKS,
                 start: int = START):
        self.on = on
        self.group = group          # copies to host memory that end a unit
        self.steps = steps          # program steps a unit
        self.units = units          # hand-overs the profiler stays open
        self.start = start
        self.prof = None
        self.first = None
        self.last = None
        self.b0 = None

    @staticmethod
    def _profile():
        import inspect

        from torch.profiler import ProfilerActivity, profile
        kw = {"acc_events": True} if "acc_events" in inspect.signature(profile).parameters else {}
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)

    def prepare(self, dev) -> None:
        """Open and close one profiler session in set-up, so that the traced
        window does not pay for the tracer's start."""
        if not self.on:
            return
        import torch
        with self._profile():
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)

    @property
    def recording(self) -> bool:
        return self.prof is not None and self.last is None

    @property
    def done(self) -> bool:
        return not self.on or self.last is not None

    def block_start(self, b: int) -> None:
        if not self.on:
            return
        if self.b0 is None:
            self.b0 = b
        if self.prof is None and b - self.b0 >= self.start:
            self.prof = self._profile()
            self.prof.start()
            self.first = b
        elif self.prof is not None and self.last is None and b - self.first >= self.units:
            self.prof.stop()
            self.last = b

    def __call__(self, name: str, b: int):
        if self.prof is None or self.last is not None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def stop(self) -> None:
        if self.prof is not None and self.last is None:
            self.prof.stop()
            self.last = -1

    def result(self) -> "Trace | None":
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        dev_ops, host = [], []
        for e in self.prof.events():
            r = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.name in SPANS:
                # A span shows on the host and, as an annotation, on the card.
                if e.device_type != DeviceType.CUDA:
                    host.append(r)
            elif e.device_type == DeviceType.CUDA:
                dev_ops.append(r)
        return Trace(sorted(dev_ops, key=lambda r: r[1]), sorted(host, key=lambda r: r[1]),
                     self.group, self.steps)


def _is_d2h(name: str) -> bool:
    return name.startswith("Memcpy DtoH")


class Trace:
    """Device operations `(name, start_s, end_s)` and host spans of the
    traced window, cut to whole units: a site's block ends on the card with
    a run of at least `group` copies to the host; an archive's capture
    (`group` 0) ends with its `process` span, which waits for its results.
    A unit holds `steps` program steps."""

    def __init__(self, dev_ops: list, host: list, group: int, steps: int = 1):
        ends, run = [], 0
        if group == 0:
            # A unit waits for its own results: it ends with its host span.
            ends = [e for n, s, e in host if n == "process"]
        for i, (name, s, e) in enumerate(dev_ops if group else ()):
            run = run + 1 if _is_d2h(name) else 0
            nxt = dev_ops[i + 1][0] if i + 1 < len(dev_ops) else ""
            if run >= group and not _is_d2h(nxt):
                ends.append(e)                  # the end of a unit's copy group
        self.units = max(len(ends) - 1, 0)
        self.blocks = self.units * steps        # program steps in the window
        self.w0, self.w1 = (ends[0], ends[-1]) if self.blocks else (0.0, 0.0)
        self.ops = [r for r in dev_ops if r[1] >= self.w0 and r[2] <= self.w1 + 1e-9]
        self.host = host
        self.layers = json.loads(LAYERS.read_text())

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def matching(self, patterns) -> list:
        return [r for r in self.ops if any(fnmatch.fnmatchcase(r[0], p) for p in patterns)]

    def layer_s(self, layer: str) -> float:
        return sum(e - s for _, s, e in self.matching(self.layers[layer]))

    def per_block_ms(self, seconds: float) -> float | None:
        return seconds / self.blocks * 1e3 if self.blocks else None

    def kernel(self, patterns) -> tuple[int, float]:
        """(launches, mean seconds) of the kernels matching `patterns`."""
        rows = self.matching(patterns)
        return len(rows), (sum(e - s for _, s, e in rows) / len(rows) if rows else 0.0)

    def breakdown(self) -> dict:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        top = [(n[:NAME], v) for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
        gaps: dict = {}
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            what = "none"
            for n, hs, he in self.host:
                if hs <= e0 < he:
                    what = n
            gaps[what] = gaps.get(what, 0.0) + (s1 - e0)
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
