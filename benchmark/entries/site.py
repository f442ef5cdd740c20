"""Entry `site`: a multi-channel ground station on `FusedReceiver.step_int8`.

A closed loop with two blocks in flight, as a double-buffered receiver
runs: block b + 1 is handed over (its `(C, 2T)` int8 capture already in
the card's memory) while block b runs; block b's VCDUs and its frame_ok,
vcid, counter, rs_errors and vit_errors go to pinned host memory with
`non_blocking` copies, and are read after an event, one block behind.  The
loop adds no synchronising call of its own.

Set-up: the kernels built or loaded, the captures made on the card, the
receiver built, and `warmup_blocks` blocks stepped so that every channel
has locked.  The window then runs for `seconds`.  Timed per block on the
card's clock (CUDA events): from the block's hand-over in the card's queue
to its results in pinned memory.

An operation is a block handed over in the window.  It fails when its
results are not whole: a delivered frame whose header names a sent VCDU
and whose bytes differ, or a channel whose ring overflowed (the program
dropped symbols).  Frames sent whole and not delivered bit-exact (to noise,
a burst's re-acquisition) are the check `lost_share`, not failures.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check, trace
from benchmark.harness.frames import FrameGate
from benchmark.source.site import SiteCapture

OUT_FIELDS = ("frame_ok", "vcid", "counter", "rs_errors", "vit_errors", "vcdu")
SNAP_FIELDS = OUT_FIELDS + ("sync_ok", "corr", "word")
KERNELS = ("frontend", "clock", "viterbi", "ring", "rs", "acquire")


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx)


def snap_state(st, idx) -> dict:
    """The rows `idx` of the receiver's state, copied (on the device)."""
    d = st.demod
    k = d.clock
    r = lambda t: _rows(t, idx)
    return dict(
        demod=dict(agc_gain=r(d.agc_gain), rrc_re=r(d.rrc_hist.re), rrc_im=r(d.rrc_hist.im),
                   phase=r(d.costas.phase), freq=r(d.costas.freq), mu=r(k.mu), omega=r(k.omega),
                   ii=r(k.ii), p_re=r(k.p.re), p_im=r(k.p.im), c_re=r(k.c.re), c_im=r(k.c.im),
                   tail_re=r(k.tail.re), tail_im=r(k.tail.im)),
        ring=r(st.ring).float(), fill=r(st.fill), locked=r(st.locked), tails=r(st.tails))


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


class Faults:
    """Faults planted under the timed path, for the check's own tests: a
    step that returns its state unchanged, half of the channels' frames
    left out, one channel's frames altered where they are produced."""

    def __init__(self, name: str | None, step):
        self.name = name
        self.inner = step

    def step(self, x, state):
        if self.name == "stale_state":
            keep = check_clone(state)
            batch, ok, ovf, _ = self.inner(x, state)
            return batch, ok, ovf, keep
        batch, ok, ovf, state = self.inner(x, state)
        if self.name == "half_batch":
            half = batch.frame_ok.shape[0] // 2
            fok = batch.frame_ok.clone()
            fok[half:] = False
            batch = batch._replace(frame_ok=fok)
        elif self.name == "altered":
            vc = batch.vcdu.clone()
            vc[0, :, 100] ^= 0x5A
            batch = batch._replace(vcdu=vc)
        return batch, ok, ovf, state


def check_clone(st):
    if isinstance(st, torch.Tensor):
        return st.clone()
    return type(st)(*(check_clone(v) for v in st))


def choose_pairs(cap: SiteCapture, seed: int, n: int, first: int, span: int) -> dict:
    """Sampled pairs by block: {block: [(channel, kind)]}.  One "start" pair
    at block 0, one "state" pair followed by its "carry", and `n - 3` more
    "state" pairs in the window's first `span` blocks; with bursts, half of
    those on a block right after the channel's burst (it re-acquires), the
    others off the channel's bursts and the carry clear of them: on noise
    the two sides' loops part."""
    rng = np.random.default_rng([seed, 11])
    pick: dict = {}
    add = lambda b, c, kind: pick.setdefault(b, []).append((int(c), kind))
    add(0, rng.integers(cap.C), "start")
    while True:
        c, b = rng.integers(cap.C), first + int(rng.integers(span - 1))
        if not cap.period or all((b + d + int(cap.phase[c])) % cap.period
                                 for d in (-1, 0, 1)):
            break
    add(b, c, "state")
    add(b + 1, c, "carry")
    for i in range(n - 3):
        b = first + int(rng.integers(span))
        if cap.period and i % 2 == 0:
            c = int(rng.integers(cap.C))
            b = b - (b + int(cap.phase[c])) % cap.period + 1
            if b < first:
                b += cap.period
        else:
            c = rng.integers(cap.C)
            while cap.period and (b + int(cap.phase[c])) % cap.period == 0:
                c = rng.integers(cap.C)                 # not on its own burst
        if any(cc == c for cc, _ in pick.get(b, ())):
            continue
        add(b, c, "state")
    return pick


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    from xritdemod_tpu_torch import _build
    from xritdemod_tpu_torch.models.decoder import DecoderConfig
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.models.receiver import FusedReceiver

    marks = {"start": time.perf_counter()}
    if cuda:
        _build.build_all(KERNELS)
    marks["built"] = time.perf_counter()
    cap = SiteCapture(cfg["demod"], cfg["decoder"]["mode"], tr, ctx.seed, ctx.seconds, dev)
    if cuda:
        torch.cuda.synchronize()
    marks["captures"] = time.perf_counter()
    rx = FusedReceiver(DemodConfig(**cfg["demod"]), DecoderConfig(**cfg["decoder"]),
                       channels=cap.C, block_len=cap.T, device=dev, **cfg["receiver"])
    faults = Faults(ctx.fault, rx.step_int8)
    first = cap.warmup
    pick = choose_pairs(cap, ctx.seed, tr["check_pairs"], first, tr["check_span"])
    pairs: list = []
    spans = trace.Spans(ctx.trace, group=len(OUT_FIELDS) + 1)

    def snap_pre(b, state, x):
        if b not in pick:
            return None
        idx = torch.tensor([c for c, _ in pick[b]], device=dev)
        return idx, snap_state(state, idx), _rows(x, idx)

    def snap_post(b, taken, state, batch, ok):
        if taken is None:
            return
        idx, pre, xrows = taken
        out = {f: _rows(getattr(batch, f), idx) for f in SNAP_FIELDS}
        out["ok"] = _rows(ok, idx)
        post = snap_state(state, idx)
        for j, (c, kind) in enumerate(pick[b]):
            pairs.append(dict(channel=c, block=b, kind=kind, j=j, pre=pre, post=post, out=out,
                              x=xrows[j]))

    state = rx.init_state()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for b in range(first):
        x = cap.block(b)
        taken = snap_pre(b, state, x)
        batch, ok, ovf, state = faults.step(x, state)
        snap_post(b, taken, state, batch, ok)
    del x, batch, ok, ovf
    unlocked = int((~state.locked).sum())          # waits for the warm-up
    if cuda:
        torch.cuda.synchronize()
    spans.prepare(dev)
    marks["warm"] = time.perf_counter()

    # Two result slots in pinned memory, a block's results each.
    C, k = cap.C, rx.k
    def slot():
        shapes = {"frame_ok": ((C, k), torch.bool), "vcid": ((C, k), torch.int32),
                  "counter": ((C, k), torch.int32), "rs_errors": ((C, k, 4), torch.int32),
                  "vit_errors": ((C, k), torch.int32), "vcdu": ((C, k, 892), torch.uint8),
                  "overflow": ((C,), torch.bool)}
        return {f: torch.empty(s, dtype=t, pin_memory=cuda) for f, (s, t) in shapes.items()}
    slots = [slot(), slot()]
    ev = lambda: torch.cuda.Event(enable_timing=True) if cuda else None
    gate = FrameGate(cap, first)
    pending: list = []
    block_ms, deliver_ms, issue_ms = [], [], []
    overflow = failed = 0

    def collect(p):
        nonlocal overflow, failed
        b, s, e_in, e_step, e_out = p
        with spans("wait", b):
            if cuda:
                e_out.synchronize()
        with spans("gate", b):
            host = {f: t.numpy() for f, t in slots[s].items()}
            wrong = gate.wrong
            gate.add(b, host)
            spilled = int(host["overflow"].sum())
            overflow += spilled
            failed += int(gate.wrong > wrong or spilled > 0)
            if cuda:
                block_ms.append(e_in.elapsed_time(e_out))
                deliver_ms.append(e_step.elapsed_time(e_out))

    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    b = first
    while ((b - first < ctx.blocks) if ctx.blocks else (time.perf_counter() < deadline)) \
            or not spans.done:
        spans.block_start(b)
        with spans("source", b):
            x = cap.block(b)
        s = (b - first) % 2
        e_in, e_step, e_out = ev(), ev(), ev()
        with spans("issue", b):
            if cuda:
                e_in.record()
            taken = snap_pre(b, state, x)
            h0 = time.perf_counter()
            batch, ok, ovf, state = faults.step(x, state)
            if not spans.recording:
                issue_ms.append((time.perf_counter() - h0) * 1e3)
            if cuda:
                e_step.record()
        with spans("deliver", b):
            for f in OUT_FIELDS:
                slots[s][f].copy_(getattr(batch, f), non_blocking=cuda)
            slots[s]["overflow"].copy_(ovf, non_blocking=cuda)
            if cuda:
                e_out.record()
        snap_post(b, taken, state, batch, ok)
        del x, batch, ok, ovf
        pending.append((b, s, e_in, e_step, e_out))
        if len(pending) == 2:
            collect(pending.pop(0))
        b += 1
    while pending:
        collect(pending.pop(0))
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    spans.stop()
    n_blocks = b - first
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    frames, lost = gate.counts()

    # The program's state is freed before the reference runs.
    pairs = [dict(p, pre=to_host(p["pre"]), post=to_host(p["post"]), out=to_host(p["out"]),
                  x=p["x"].cpu().numpy()) for p in pairs]
    rows = {(p["channel"], p["block"]): p["x"] for p in pairs}
    traced = spans.result() if ctx.trace else None
    del state, rx, slots
    cap.streams = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    tally = check.run_pairs(pairs, cfg, k, cap.T, lambda c, b: rows[(c, b)])
    ref_s = time.perf_counter() - t2

    window_s = t1 - t0
    samples = n_blocks * cap.C * cap.T
    checks = {
        "wrong_frames": (gate.wrong, tr["limits"]["wrong_frames"]),
        "lost_share": (lost / frames if frames else 1.0, tr["limits"]["lost_share"]),
        "unlocked_at_window": (unlocked, tr["limits"]["unlocked_at_window"]),
        "soft_gap": (tally.soft_gap(), tr["limits"]["soft_gap"]),
        "mismatches": (tally.mismatches, tr["limits"]["mismatches"]),
    }
    return dict(
        attempted=n_blocks, failed=failed, checks=checks, t_window=t0,
        e2e={"msamples_per_s": samples / window_s / 1e6,
             "block_p95_ms": float(np.percentile(block_ms, 95)) if block_ms else None},
        memory_peak_bytes=peak, trace=traced,
        counters=dict(deliver_ms=deliver_ms, issue_ms=issue_ms, blocks=n_blocks),
        shape=dict(C=cap.C, T=cap.T, sps=cap.sps, k=k, rrc_taps=cfg["demod"]["rrc_taps"]),
        info=dict(setup_marks_s={k: v - marks["start"] for k, v in marks.items()},
                  blocks=n_blocks, window_s=window_s, k=k, esn0_db=cap.esn0_db,
                  frames_attempted=frames, frames_lost=lost,
                  reference_s=ref_s, pairs=len(pairs), frames_checked=tally.frames,
                  symbols_checked=tally.symbols, pair_gaps=tally.pairs, complemented=gate.complemented,
                  false_locks=gate.false_locks,
                  partial=gate.partial, overflow=overflow, wrong_detail=gate.wrong_detail,
                  mismatch_detail=tally.detail, laps=(b - 1) // cap.cap + 1,
                  block_ms_median=float(np.median(block_ms)) if block_ms else None))

