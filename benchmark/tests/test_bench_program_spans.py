"""The readers of the program's own spans and counters, on synthetic
recorder contents and traces: each returns its number, and None where the
recorder is empty or the program has none (an older commit)."""

import importlib.util
from pathlib import Path

import pytest

from benchmark.harness.trace import Trace
from xritdemod_tpu_torch.runtime import metrics

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ["wire_ms.site", "wire_ms.archive", "decode_span_ms.site", "glue_ms.site",
           "glue_ms.archive", "decode_yield_pct.site", "rs_errored_pct.site",
           "acquired_per_block.site", "idle_assemble_pct.archive", "idle_pull_pct.archive"]
EPOCH = 1_790_000_000_000_000_000      # the program's host clock (ns) at the trace's 0


def reader(name):
    spec = importlib.util.spec_from_file_location("bench_" + name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def row(sid, name, parent, start_ms, end_ms, device_ms=None, unit=1):
    return dict(id=sid, unit=unit, parent=parent, name=name, attrs=None,
                start_ns=EPOCH + int(start_ms * 1e6), end_ns=EPOCH + int(end_ms * 1e6),
                device_ms=device_ms)


def site_record():
    """Two steps: 10 ms on the card each, ingest 2 + layout 1, two decodes
    of 0.5 ms; 4 rows a step, 3 delivered; 16 codewords, 4 errored; 3
    unlocked channels acquired in all."""
    spans = []
    for b in range(2):
        base = 10 * b + 1
        spans += [row(base, "rx.step", None, 0, 1, 10.0, unit=base),
                  row(base + 1, "rx.ingest", base, 0, 0.1, 2.0, unit=base),
                  row(base + 2, "rx.demod", base, 0.1, 0.5, 6.0, unit=base),
                  row(base + 3, "rx.demod.layout", base + 2, 0.1, 0.2, 1.0, unit=base),
                  row(base + 4, "rx.decode", base, 0.5, 0.7, 0.5, unit=base),
                  row(base + 5, "rx.decode", base, 0.7, 0.9, 0.5, unit=base)]
    counters = {"decode.rows": 8, "decode.delivered": 6, "rs.codewords": 32,
                "rs.errored": 8, "acquire.channels": 3}
    return {"spans": spans, "counters": counters, "units": 2}


def site_trace():
    """Two whole blocks: K1 4 ms, K2 2 ms, K3 0.5 ms each, a copy ending each."""
    ops = []
    for b in range(3):
        t = 0.010 * b
        ops += [("void frontend_kernel<false>(FrontArgs)", t, t + 0.004),
                ("void clock_kernel<0>(ClockArgs)", t + 0.004, t + 0.006),
                ("void viterbi_kernel<4>(float2 const*)", t + 0.006, t + 0.0065),
                ("Memcpy DtoH (Device -> Pinned)", t + 0.0065, t + 0.007)]
    return Trace(ops, [], group=1)


def archive_record_and_trace(shift_us=0.0):
    """Two `process` calls on the trace's clock (the program's clock 5 ms
    behind it), each opening 0.3 ms before its `fold.process` and closing
    2 us after it; in each, the card idles 10 ms under `fold.assemble` and
    20 ms under `fold.dedup`, and is busy otherwise.  `shift_us` moves the
    second call's `fold.process` later on the program's clock."""
    spans, host, ops = [], [], []
    for c in range(2):
        t = 200.0 * c                                      # ms on the trace's clock
        p = t - 5.0                                        # the program's clock
        sid = 100 * c + 1
        shift = shift_us / 1e3 if c else 0.0
        spans += [row(sid, "fold.process", None, p + shift, p + 100 + shift, unit=sid),
                  row(sid + 1, "fold.assemble", sid, p + 1, p + 11, unit=sid),
                  row(sid + 2, "fold.step", sid, p + 11, p + 60, unit=sid),
                  row(sid + 3, "rx.step", sid + 2, p + 12, p + 59, unit=sid),
                  row(sid + 4, "fold.pull", sid, p + 60, p + 70, unit=sid),
                  row(sid + 5, "fold.dedup", sid, p + 70, p + 95, unit=sid)]
        host.append(("process", (t - 0.3) * 1e-3, (t + 100.002) * 1e-3))
        ops += [("void frontend_kernel<false>(FrontArgs)", (t + 0.5) * 1e-3, (t + 1.5) * 1e-3),
                ("void frontend_kernel<false>(FrontArgs)", (t + 11.5) * 1e-3, (t + 71) * 1e-3),
                ("Memcpy DtoH (Device -> Pageable)", (t + 91) * 1e-3, (t + 99) * 1e-3)]
    rec = {"spans": spans, "counters": {}, "units": 2}
    return rec, Trace(ops, host, group=0)


@pytest.fixture
def record(monkeypatch):
    """Set what the program's recorder reads out."""
    def put(rec):
        monkeypatch.setattr(metrics, "recorded", lambda since=0: rec)
    return put


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_recorder_is_empty(name, record):
    record({"spans": [], "counters": {}, "units": 0})
    assert reader(name)({"trace": site_trace()}) is None
    assert reader(name)({"trace": None}) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_program_has_no_recorder(name, monkeypatch):
    monkeypatch.delattr(metrics, "recorded")
    assert reader(name)({"trace": site_trace()}) is None


@pytest.mark.parametrize("name, want", [
    ("wire_ms.site", 3.0), ("wire_ms.archive", 3.0), ("decode_span_ms.site", 1.0),
    ("decode_yield_pct.site", 75.0), ("rs_errored_pct.site", 25.0),
    ("acquired_per_block.site", 1.5),
    # 10 ms a step less K1 4, K2 2, K3 0.5 a block.
    ("glue_ms.site", 3.5), ("glue_ms.archive", 3.5),
])
def test_site_readers(name, want, record):
    record(site_record())
    assert reader(name)({"trace": site_trace()}) == pytest.approx(want)


def test_idle_readers_place_the_program_spans_on_the_trace(record):
    rec, tr = archive_record_and_trace()
    record(rec)
    # The window runs from the first call's end to the second's (200 ms) and
    # holds the second call's idle gaps: under fold.assemble 10 ms, under
    # fold.dedup 20.
    assert tr.window_s == pytest.approx(0.2)
    assert reader("idle_assemble_pct.archive")({"trace": tr}) == pytest.approx(100 * 10 / 200)
    assert reader("idle_pull_pct.archive")({"trace": tr}) == pytest.approx(100 * 20 / 200)


def test_idle_readers_refuse_clocks_that_disagree(record):
    # The offset is the second call's end difference, which leaves the
    # first call's fold.process starting `shift` - 0.3 ms before its call.
    rec, tr = archive_record_and_trace(shift_us=500)
    record(rec)
    assert reader("idle_assemble_pct.archive")({"trace": tr}) is None
    rec, tr = archive_record_and_trace(shift_us=300)
    record(rec)
    assert reader("idle_pull_pct.archive")({"trace": tr}) is not None


def test_idle_readers_take_the_call_that_closed_soonest(record):
    # A call whose `process` range closes 3 ms late (its exit held up)
    # moves neither the offset nor the readings.
    rec, tr = archive_record_and_trace()
    n, s, e = tr.host[1]
    tr.host[1] = (n, s, e + 0.003)
    record(rec)
    assert reader("idle_assemble_pct.archive")({"trace": tr}) == pytest.approx(100 * 10 / 200)
