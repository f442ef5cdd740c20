"""The program's spans and counters (`runtime/metrics.py`): recorded only
while a `torch.profiler` session records, at the layer boundaries of the
fused step (`rx.*`) and of the fold path (`fold.*`), and nothing else.

The fused step runs on the CPU at C = 2, T = 4096, two extractions a step,
from a state whose rings already hold a frame and a half of each channel's
stream behind a lead of 100 symbols: the first extraction acquires and
delivers a frame, the second finds no whole frame.  The fold path runs its
own host code around a stand-in receiver (its steps cost nothing).  The one
CUDA test skips without a card (it runs on the chip:
`python -m pytest --noconftest tests/test_torch_spans.py -m chip`); this file
imports nothing of JAX.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from xritdemod_tpu_torch import constants, tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver
from xritdemod_tpu_torch.runtime import metrics
from xritdemod_tpu_torch.utils.cplx import map_tree

C, T, K, LEAD = 2, 4096, 2, 100
CODED = constants.CODED_FRAME_SIZE
DEMOD = ["rx.demod.layout", "rx.demod.frontend", "rx.demod.clock"]
DECODE = ["rx.decode.sync", "rx.decode.viterbi", "rx.decode.bytes", "rx.decode.rs"]
EXTRACTION = ["rx.acquire", "rx.ring.extract", "rx.decode", "rx.select"]
STEP = ["rx.ingest", "rx.demod", "rx.ring.append"] + EXTRACTION * K + ["rx.merge"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _primed(rx: FusedReceiver):
    """A state whose ring holds LEAD noise symbols, then a frame and a half
    of channel c's CADU stream (VCID c + 1), unlocked."""
    st = rx.init_state()
    rng = np.random.default_rng(7)
    n = LEAD + CODED + CODED // 2
    for c in range(C):
        soft = tx.TxChain(lrit=True).encode_frames(
            tx.make_vcdus(2, vcid=c + 1, counter0=10 * c, rng=rng))
        lead = rng.normal(0, 0.3, LEAD).astype(np.float32)
        st.ring[c, :n] = torch.from_numpy(np.concatenate([lead, soft])[:n])
    st.fill[:] = n
    return st


@pytest.fixture(scope="module")
def steps():
    """One step from the primed state with tracing off, and the same step
    from a copy of that state under the profiler."""
    rx = FusedReceiver(DemodConfig.lrit(sample_rate=1_250_000), DecoderConfig(mode="lrit"),
                       channels=C, block_len=T, extracts_per_step=K, device="cpu")
    st0 = _primed(rx)
    rng = np.random.default_rng(11)
    x = (0.1 * (rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T)))).astype(np.complex64)
    mark = metrics.RECORDER.last_id()
    # One thread: a multi-threaded float product may split its sums another
    # way from call to call on a loaded host, which would part the two
    # steps whatever the recorder does.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.inference_mode():
            off = rx.step(x, map_tree(torch.clone, st0))
            off_rec = metrics.recorded(since=mark)
            with _cpu_profile():
                on = rx.step(x, map_tree(torch.clone, st0))
    finally:
        torch.set_num_threads(threads)
    return dict(off=off, on=on, off_rec=off_rec, rec=metrics.recorded(since=mark))


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def test_tracing_off_records_nothing_and_outputs_are_bit_equal(steps):
    assert steps["off_rec"] == {"spans": [], "counters": {}, "units": 0}
    a, b = _leaves(steps["off"]), _leaves(steps["on"])
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)
    # The primed step does what the counters below are checked on.
    ok = steps["on"][1]
    assert ok[:, 0].all() and not ok[:, 1].any()
    assert steps["on"][0].frame_ok[:, 0].all()


def test_tracing_off_is_one_shared_null_context():
    assert metrics.span("rx.step") is metrics.span("rx.decode", {"i": 0})
    mark = metrics.RECORDER.last_id()
    metrics.count("decode.rows", torch.ones(3))
    metrics.add("fold.assemble", 0, 1)
    assert metrics.RECORDER.last_id() == mark


def test_a_step_gives_its_spans_in_order(steps):
    spans = steps["rec"]["spans"]
    assert steps["rec"]["units"] == 1
    root = spans[0]
    assert root["name"] == "rx.step" and root["parent"] is None
    assert root["attrs"] == {"C": C, "T": T, "k": K}
    assert all(s["unit"] == root["id"] for s in spans)
    children = lambda p: [s for s in spans if s["parent"] == p["id"]]
    kids = children(root)
    assert [s["name"] for s in kids] == STEP
    groups = [s["attrs"]["i"] for s in kids if s["name"] in EXTRACTION]
    assert groups == [i for i in range(K) for _ in EXTRACTION]
    demod = next(s for s in kids if s["name"] == "rx.demod")
    assert [s["name"] for s in children(demod)] == DEMOD
    for dec in (s for s in kids if s["name"] == "rx.decode"):
        assert [s["name"] for s in children(dec)] == DECODE
    assert len(spans) == 1 + len(STEP) + len(DEMOD) + K * len(DECODE)
    assert [s["id"] for s in spans] == sorted(s["id"] for s in spans)


def test_host_intervals_nest(steps):
    spans = steps["rec"]["spans"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    for p in spans:
        kids = [s for s in spans if s["parent"] == p["id"]]
        for a, b in zip(kids, kids[1:]):
            assert a["end_ns"] <= b["start_ns"]


def test_counters_are_the_step_outputs(steps):
    batch, ok, _, _ = steps["on"]
    unlocked_before = C                       # the primed state is unlocked
    locked_after_first = batch.sync_ok[:, 0]
    want = {
        "decode.rows": ok.numel(),
        "decode.delivered": int(batch.frame_ok.sum()),
        "rs.codewords": batch.rs_errors.numel(),
        "rs.errored": int((batch.rs_errors != 0).sum()),
        "acquire.channels": unlocked_before + int((~locked_after_first).sum()),
    }
    assert steps["rec"]["counters"] == want
    assert want["decode.delivered"] == C and want["decode.rows"] == C * K


class _StandInRx:
    """The fused receiver's surface for the fold path, at no cost: each step
    delivers one frame a fold, numbered by step and fold."""

    def __init__(self, folds: int):
        self.folds, self.n = folds, 0

    def init_state(self):
        return None

    def step_int8(self, q, st):
        assert q.shape[0] == self.folds
        f = torch.arange(self.folds, dtype=torch.int32)[:, None]
        batch = SimpleNamespace(frame_ok=torch.ones((self.folds, 1), dtype=torch.bool),
                                scid=torch.full((self.folds, 1), 13, dtype=torch.int32),
                                vcid=f + 1, counter=torch.full_like(f, self.n),
                                vcdu=torch.zeros((self.folds, 1, 892), dtype=torch.uint8))
        self.n += 1
        return batch, batch.frame_ok, torch.zeros(self.folds, dtype=torch.bool), st


def test_fold_path_spans_and_assemble_total():
    fold = FoldedCaptureReceiver(DemodConfig.lrit(sample_rate=1_250_000), folds=2,
                                 block_len=T, use_fused=True, device="cpu")
    fold._rx = _StandInRx(2)
    q = np.random.default_rng(5).integers(-60, 60, 2 * 30000).astype(np.int8)
    mark = metrics.RECORDER.last_id()
    with _cpu_profile():
        frames = fold.process(q)
    rec = metrics.recorded(since=mark)
    steps = fold.last_timings["blocks"] + 2
    assert len(frames) == 2 * steps
    assert set(fold.last_timings) == {"assemble_s", "stream_and_pull_s", "blocks", "wire"}
    root, *rest = rec["spans"]
    assert root["name"] == "fold.process" and root["parent"] is None
    assert rec["units"] == 1 and all(s["parent"] == root["id"] for s in rest)
    assert [s["name"] for s in rest] == (["fold.assemble", "fold.step"] * steps
                                         + ["fold.pull", "fold.dedup"])
    assemble_ns = sum(s["end_ns"] - s["start_ns"] for s in rest if s["name"] == "fold.assemble")
    assert fold.last_timings["assemble_s"] == assemble_ns * 1e-9


def test_exported_trace_rows_on_the_profiler_clock(tmp_path):
    """`metrics.trace` writes the spans and counter totals into its Chrome
    trace; a span's host stamps lie within 1 ms of a `record_function`
    range around the same region."""
    with metrics.trace(str(tmp_path)) as d:
        with record_function("xrit.warm"), metrics.span("warm"):
            pass                # a session's first range pays ~1 ms after its stamp
        with record_function("xrit.probe"):
            with metrics.span("probe.outer", {"n": 1}):
                with metrics.span("probe.inner"):
                    metrics.count("probe.count", torch.ones(5))
                    torch.ones(4096).cumsum(0)
    events = json.load(open(os.path.join(d, metrics.TRACE_FILE)))["traceEvents"]
    probe = next(e for e in events if e.get("name") == "xrit.probe" and e.get("ph") == "X")
    outer = next(e for e in events if e.get("name") == "probe.outer")
    inner = next(e for e in events if e.get("name") == "probe.inner")
    assert outer["cat"] == inner["cat"] == "xrit_span" and outer["tid"] == metrics.SPAN_TID
    assert inner["args"]["parent"] == outer["args"]["id"] and outer["args"]["parent"] is None
    assert outer["args"]["attrs"] == {"n": 1}
    assert abs(outer["ts"] - probe["ts"]) < 1000
    assert abs(outer["ts"] + outer["dur"] - probe["ts"] - probe["dur"]) < 1000
    counters = [e for e in events if e.get("ph") == "C" and e.get("name") == "xrit counters"]
    assert counters and counters[0]["args"] == {"probe.count": 5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.chip
def test_on_the_card_spans_stay_off_the_device_timeline(card, monkeypatch):
    """Tracing off creates no CUDA event; under the benchmark's own
    profiler no `rx.*` event reaches its device operations, and each
    parent's device ms is its children's within 2 %."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.harness.trace import Spans

    created = []
    real = torch.cuda.Event

    def counting(*a, **kw):
        created.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counting)
    from xritdemod_tpu_torch import _build
    _build.build_all()
    # The site's shape: the card runs behind the host all through the step,
    # as in the benchmark's cells, so no span's events hold an idle gap.
    rx = FusedReceiver(DemodConfig.lrit(sample_rate=1_250_000), DecoderConfig(mode="lrit"),
                       channels=2048, block_len=1 << 17, device=card)
    st = rx.init_state()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-40, 40, (2048, 2 << 17)).astype(np.int8)).to(card)
    for _ in range(2):
        _, _, _, st = rx.step_int8(q, st)
    torch.cuda.synchronize()
    assert created == []
    mark = metrics.RECORDER.last_id()
    spans = Spans(True, group=1, units=3, start=0)
    for b in range(4):
        spans.block_start(b)
        if b < 3:
            batch, _, _, st = rx.step_int8(q, st)
            batch.frame_ok.cpu()
    tr = spans.result()
    assert not [n for n, _, _ in tr.ops if n.startswith(("rx.", "fold."))]
    rec = metrics.recorded(since=mark)
    assert len(created) == 2 * len(rec["spans"]) and rec["units"] == 3
    for p in rec["spans"]:
        kids = [s for s in rec["spans"] if s["parent"] == p["id"]]
        if kids:
            # 2 %, and 10 us for the events' own resolution on short spans.
            total = sum(s["device_ms"] for s in kids)
            assert abs(total - p["device_ms"]) <= max(0.02 * p["device_ms"], 0.01), \
                (p["name"], total, p["device_ms"])
