"""Entry `archive`: one recorded capture reprocessed again and again through
`FoldedCaptureReceiver(folds).process`, as `cli reprocess` runs it.

The capture is a host int8 array (`source/archive.py`); each call folds it
into `folds` overlapping segments on the host, steps the fused receiver
over them (host-to-device copies of each fold block included), flushes and
deduplicates, and returns the frames.  Set-up builds or loads the kernels,
makes the capture, and runs `warm_jit` and one whole call.  The window runs
whole calls back to back for `seconds`; every frame of every call is held
against the sent VCDUs.  The reference check reads the fused receiver's
state around its steps in the window's first call (a wrapper on the
receiver object's `step_int8`; the call's code path is unchanged).

An operation is a whole `process` call.  It fails when it delivers a frame
whose header names a sent VCDU and whose bytes differ.  Frames of the
capture not delivered bit-exact (a fold head's acquisition) are the check
`lost_share`, not failures.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.entries.site import SNAP_FIELDS, Faults, _rows, snap_state, to_host
from benchmark.harness import check, trace
from benchmark.harness.frames import header
from benchmark.source.archive import VCID, ArchiveCapture

KERNELS = ("frontend", "clock", "viterbi", "ring", "rs", "acquire")


class Snapper:
    """Snapshots of sampled `(fold, step)` pairs around the receiver's steps
    while `armed` (and, for the check's own tests, a planted fault)."""

    def __init__(self, rx, pick: dict, dev, fault: str | None = None):
        self.rx, self.pick, self.dev = rx, pick, dev
        self.inner = Faults(fault, rx.step_int8).step
        self.armed = False
        self.j = 0
        self.pairs: list = []

    def __call__(self, q, state):
        j = self.j
        self.j += 1
        if not self.armed or j not in self.pick:
            return self.inner(q, state)
        folds = [f for f, _ in self.pick[j]]
        idx = torch.tensor(folds, device=self.dev)
        pre = snap_state(state, idx)
        xrows = np.asarray(q)[folds].copy()
        batch, ok, ovf, state = self.inner(q, state)
        out = {f: _rows(getattr(batch, f), idx) for f in SNAP_FIELDS}
        out["ok"] = _rows(ok, idx)
        post = snap_state(state, idx)
        for n, (f, kind) in enumerate(self.pick[j]):
            self.pairs.append(dict(channel=f, block=j, kind=kind, j=n, pre=pre, post=post,
                                   out=out, x=xrows[n]))
        return batch, ok, ovf, state


def choose_pairs(inside: np.ndarray, before: np.ndarray, seed: int, n: int) -> dict:
    """{step: [(fold, kind)]}: a "start" pair at step 0 (every call starts
    every fold from the initial state), a "state" pair and its "carry", and
    `n - 3` more "state" pairs.  `inside[f, j]`: fold f's block j lies in
    the capture; `before[f]`: its block 0 lies wholly before it (zeros).
    A "state" pair lies in the capture on a fold whose block 0 does too: on
    the noise after the capture the loops of the two sides part, and a fold
    that starts on zeros starts cold a second time when the capture begins,
    with its AGC's gain run up on the zeros."""
    rng = np.random.default_rng([seed, 17])
    ok = inside & inside[:, :1]                  # folds that start on the capture
    ok[:, 0] = False
    pick: dict = {}
    add = lambda j, f, kind: pick.setdefault(j, []).append((int(f), kind))
    add(0, rng.choice(np.nonzero(inside[:, 0] | before)[0]), "start")
    f, j = [int(v) for v in rng.choice(np.argwhere(ok[:, :-1] & ok[:, 1:]))]
    add(j, f, "state")
    add(j + 1, f, "carry")
    for f, j in rng.choice(np.argwhere(ok), n - 3):
        if all(ff != f for ff, _ in pick.get(int(j), ())):
            add(int(j), f, "state")
    return pick


class Gate:
    """Every call's frames against the sent VCDUs.  Every fold head acquires
    from cold in every call, so a frame may be the complement of a sent one
    or a false lock (`benchmark/harness/frames.py`); one whose header names
    no sent VCDU is taken for a false lock, and both count as lost.  A
    frame whose header names a sent VCDU and whose bytes differ is wrong."""

    def __init__(self, cap: ArchiveCapture):
        self.cap = cap
        self.frames = self.lost = self.wrong = self.complemented = self.false_locks = 0

    def add(self, frames) -> None:
        cap = self.cap
        got = np.zeros(cap.nframes, bool)
        for _, vcid, ctr, vcdu in frames:
            v = np.frombuffer(vcdu, np.uint8)
            f = (ctr - cap.counter0) & 0xFFFFFF
            if vcid == VCID and f < cap.nframes and np.array_equal(v, cap.sent[f]):
                got[f] = True
                continue
            ivc, ictr = header(~v)
            fi = (int(ictr) - cap.counter0) & 0xFFFFFF
            if int(ivc) == VCID and fi < cap.nframes and np.array_equal(~v, cap.sent[fi]):
                self.complemented += 1
            elif vcid == VCID and f < cap.nframes:
                self.wrong += 1
            else:
                self.false_locks += 1
        self.frames += cap.nframes
        self.lost += int((~got).sum())


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    from xritdemod_tpu_torch import _build
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver

    marks = {"start": time.perf_counter()}
    if cuda:
        _build.build_all(KERNELS)
    marks["built"] = time.perf_counter()
    cap = ArchiveCapture(cfg["demod"], cfg["decoder"]["mode"], tr, ctx.seed, dev)
    marks["capture"] = time.perf_counter()
    frx = FoldedCaptureReceiver(DemodConfig(**cfg["demod"]), folds=tr["folds"],
                                block_len=tr["block_len"], mode=cfg["decoder"]["mode"],
                                use_fused=True, device=dev)
    frx.warm_jit("s8")
    rx = frx._get_rx()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    frx.process(cap.iq)                             # every shape of a call, once
    marks["warm"] = time.perf_counter()
    steps = frx.last_timings["blocks"] + 2
    # Where each fold's blocks lie: fold f starts `overlap` samples before
    # its share of the capture (`FoldedCaptureReceiver`'s layout).
    N, T, F = len(cap.iq) // 2, tr["block_len"], tr["folds"]
    first = np.arange(F) * -(-N // F) - frx.overlap
    lo = first[:, None] + T * np.arange(steps)[None, :]
    inside = (lo >= 0) & (lo + T <= N)
    inside[:, frx.last_timings["blocks"]:] = False        # the flush steps
    pick = choose_pairs(inside, lo[:, 0] + T <= 0, ctx.seed, tr["check_pairs"])
    snapper = Snapper(rx, pick, dev, ctx.fault)
    rx.step_int8 = snapper
    spans = trace.Spans(ctx.trace, group=0, steps=steps, units=tr["trace_calls"], start=1)
    spans.prepare(dev)
    gate = Gate(cap)
    assemble = []
    calls = failed = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while ((calls < ctx.blocks) if ctx.blocks else (time.perf_counter() < deadline)) \
            or not spans.done:
        spans.block_start(calls)
        snapper.armed, snapper.j = calls == 0, 0
        with spans("process", calls):
            frames = frx.process(cap.iq)
        assemble.append(frx.last_timings["assemble_s"] / steps)
        wrong = gate.wrong
        gate.add(frames)
        failed += int(gate.wrong > wrong)
        calls += 1
    t1 = time.perf_counter()
    spans.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del rx.step_int8
    pairs = [dict(p, pre=to_host(p["pre"]), post=to_host(p["post"]), out=to_host(p["out"]))
             for p in snapper.pairs]
    rows = {(p["channel"], p["block"]): p["x"] for p in pairs}
    traced = spans.result() if ctx.trace else None
    del frx, rx, snapper
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    tally = check.run_pairs(pairs, cfg, int(np.ceil(tr["block_len"] / cap.sps / 16384)),
                            tr["block_len"], lambda c, b: rows[(c, b)])
    ref_s = time.perf_counter() - t2
    lim = tr["limits"]
    checks = {
        "wrong_frames": (gate.wrong, lim["wrong_frames"]),
        "lost_share": (gate.lost / gate.frames if gate.frames else 1.0, lim["lost_share"]),
        "soft_gap": (tally.soft_gap(), lim["soft_gap"]),
        "mismatches": (tally.mismatches, lim["mismatches"]),
    }
    window_s = t1 - t0
    return dict(
        attempted=calls, failed=failed, checks=checks, t_window=t0,
        e2e={"archive_msamples_per_s": calls * cap.n / window_s / 1e6},
        memory_peak_bytes=peak, trace=traced,
        counters=dict(assemble_ms=[a * 1e3 for a in assemble], calls=calls),
        shape=dict(C=tr["folds"], T=tr["block_len"], sps=cap.sps,
                   rrc_taps=cfg["demod"]["rrc_taps"]),
        info=dict(setup_marks_s={k: v - marks["start"] for k, v in marks.items()},
                  calls=calls, steps_a_call=steps, window_s=window_s,
                  frames_a_call=cap.nframes, frames_lost=gate.lost,
                  complemented=gate.complemented,
                  false_locks=gate.false_locks,
                  reference_s=ref_s, pairs=len(pairs), frames_checked=tally.frames,
                  symbols_checked=tally.symbols, pair_gaps=tally.pairs, mismatch_detail=tally.detail,
                  assemble_ms_a_step_median=float(np.median(assemble)) * 1e3 if assemble else None))
