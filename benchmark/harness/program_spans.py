"""What the readers of the program's own spans and counters share.

The program records them (`xritdemod_tpu_torch/runtime/metrics.py`: `rx.*`
at the fused step's layer boundaries, `fold.*` in the fold path, counters
of decoded rows, delivered frames, RS codewords and acquisitions) while the
traced run's profiler records, and hands them out through `recorded()`.  A
program without them (an older commit) has no `recorded`, or records
nothing: every reader then returns None, and the metric is left out of the
line.
"""

from __future__ import annotations

import statistics

from benchmark.harness.readers import layer_ms

ALIGN_NS = 100_000      # the farthest the aligned `fold.process` may start before its call


def recorded() -> dict | None:
    """The program's recorder, read out; None where there is none or it is
    empty."""
    try:
        from xritdemod_tpu_torch.runtime import metrics
    except ImportError:
        return None
    read = getattr(metrics, "recorded", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] else None


def _steps(rec: dict) -> int:
    return sum(s["name"] == "rx.step" for s in rec["spans"])


def device_ms_a_step(names) -> float | None:
    """Device ms a step (`rx.step`) in the spans named `names`."""
    rec = recorded()
    if rec is None or not _steps(rec):
        return None
    rows = [s["device_ms"] for s in rec["spans"] if s["name"] in names]
    if not rows or None in rows:
        return None
    return sum(rows) / _steps(rec)


def glue_ms(res: dict) -> float | None:
    """Device ms a step in `rx.step` that no kernel of the `demod`,
    `ring_acq` and `decode` layers of `layers.json` takes."""
    step = device_ms_a_step(("rx.step",))
    if step is None or res["trace"] is None:
        return None
    return step - sum(layer_ms(res, layer) or 0.0 for layer in ("demod", "ring_acq", "decode"))


def counter_a_step(name: str) -> float | None:
    rec = recorded()
    if rec is None or not _steps(rec):
        return None
    return rec["counters"].get(name, 0) / _steps(rec)


def counter_pct(part: str, whole: str) -> float | None:
    rec = recorded()
    if rec is None or not rec["counters"].get(whole):
        return None
    return 100.0 * rec["counters"].get(part, 0) / rec["counters"][whole]


def align(res: dict, rec: dict) -> tuple[int, int] | None:
    """(offset, misfit) in ns that put the program's host spans on the
    trace's timeline.  Each benchmark `process` span of `Trace.host`
    encloses one `fold.process`, so each call bounds the offset: from
    below by its starts' difference, from above by its ends'.  The ends'
    differences hold the lag with which the `process` range closes after
    `fold.process` (its exit through the profiler, a collection of the
    garbage), which varies from call to call by more than the clocks
    differ: the offset is the least of them, the call that closed soonest.
    The misfit is how far the one offset leaves the starts of the calls'
    `fold.process` before their `process` spans' (negative where it nests
    every one).  None where the spans cannot be paired."""
    calls = [(s, e) for n, s, e in res["trace"].host if n == "process"]
    folds = sorted((s["start_ns"], s["end_ns"]) for s in rec["spans"]
                   if s["name"] == "fold.process" and s["end_ns"] is not None)
    if not calls or len(folds) < len(calls):
        return None
    pairs = list(zip(calls, folds[-len(calls):]))
    off = min(round(c[1] * 1e9) - f[1] for c, f in pairs)
    return off, max(round(c[0] * 1e9) - f[0] for c, f in pairs) - off


def idle_pct_under(res: dict, names) -> float | None:
    """Share of the traced window in which the card idled while the host's
    innermost program span was one of `names`: each gap between the card's
    busy intervals goes to the innermost span open at its start, as
    `Trace.breakdown` assigns gaps to the benchmark's spans.  None where
    no one offset places every `fold.process` inside its call to within
    ALIGN_NS: the two clocks do not agree."""
    tr, rec = res["trace"], recorded()
    if tr is None or rec is None or tr.window_s <= 0:
        return None
    found = align(res, rec)
    if found is None or found[1] > ALIGN_NS:
        return None
    off = found[0]
    spans = sorted(((s["start_ns"] + off) * 1e-9, (s["end_ns"] + off) * 1e-9, s["name"])
                   for s in rec["spans"] if s["end_ns"] is not None)
    busy = tr.busy_intervals()
    idle = 0.0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        inner = None
        for hs, he, name in spans:
            if hs > e0:
                break
            if e0 < he:
                inner = name
        if inner in names:
            idle += s1 - e0
    return 100.0 * idle / tr.window_s
