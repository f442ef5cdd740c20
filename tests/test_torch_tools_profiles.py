"""The port's measuring tools on the CPU, and the public names the port keeps
beside the JAX package's.

Every profiler's `main` runs with `--device cpu` at a tiny size and prints
its documented keys on its last line (times taken here are the CPU's, which
the tools name as the device: they say nothing of the card).  Every tool
refuses a CUDA device where there is none.  `make_frozen_fixture` writes
into a temporary directory the streams whose SHA-256s `tests/fixtures/
meta.json` pins.  The satellite names are held against their JAX
counterparts on seeded inputs, exactly where both compute the same float32
operations in the same order, and otherwise with the tolerance each test
states.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xritdemod_tpu_torch
from xritdemod_tpu import constants as jconst
from xritdemod_tpu.ops import agc as jagc
from xritdemod_tpu.ops import clock_recovery as jcr
from xritdemod_tpu.ops import correlator as jcorr
from xritdemod_tpu.ops import derandomizer as jder
from xritdemod_tpu.ops import nrzm as jnrzm
from xritdemod_tpu.utils import cplx as jcplx
from xritdemod_tpu_torch.ops import agc as tagc
from xritdemod_tpu_torch.ops import clock_recovery as tcr
from xritdemod_tpu_torch.ops import correlator as tcorr
from xritdemod_tpu_torch.ops import derandomizer as tder
from xritdemod_tpu_torch.ops import nrzm as tnrzm
from xritdemod_tpu_torch.tools import (
    chain_bench, clock_bench, decode_bench, decode_profile, drive_demod, frontend_bench,
    host_budget_profile, make_frozen_fixture, rx_profile, scaling_sweep, seeconstellation,
    stage_profile, timing,
)
from xritdemod_tpu_torch.utils import cplx as tcplx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _last_json(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1] if out[-1].startswith("{") else out[-2])


# The keys every timing report carries beside its stages' times.
_STAGED = {"card", "device", "ms", "launches", "whole", "whole_ms", "stage_sum_ms",
           "all_finite"}


@pytest.mark.parametrize("tool, argv, env, keys, stages", [
    (decode_profile, ["1", "1"], {}, _STAGED | {"B", "stages_of_whole"},
     {"full decode_frames", "full decode_frames (clean frames)", "viterbi plain (S=1)",
      "viterbi segmented S=2",
      "viterbi segmented S=4", "viterbi segmented S=8", "viterbi segmented S=16",
      "viterbi segmented S=4 overlap=64", "viterbi segmented S=4 overlap=96", "pack_bits",
      "nrzm_decode_bytes", "derandomize", "rs_decode_frame (errored path)",
      "rs_decode_frame (clean fast path)", "sync_and_fix"}),
    (chain_bench, ["2", "1024", "--iters", "1", "--decimation", "2"], {},
     _STAGED | {"msamples_per_s", "stages_of_whole"},
     {"decimating_fir", "agc", "rrc_fir", "costas", "clock", "block_batch"}),
    (stage_profile, ["2", "1024", "1"], {"BENCH_CLOCK_INTERP": "mmse"},
     _STAGED | {"clock_interp", "stages_of_whole"},
     {"frontend (transpose+fused kernel)", "clock (channels-last kernel)",
      "full chain (block_batch)"}),
    (rx_profile, ["2", "4096", "1"], {}, _STAGED | {"k", "ring_len", "device_busy_ms_per_call"},
     {"full rx step (unlocked: acq on)", "demod block_batch", "ring_append", "ring_extract",
      "acquisition correlate", "decode_frames (x1; step does k)"}),
])
def test_staged_profilers_print_their_keys(capsys, monkeypatch, tool, argv, env, keys, stages):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with torch.inference_mode():
        assert tool.main(argv + CPU) == 0
    res = _last_json(capsys)
    assert keys <= set(res), keys - set(res)
    assert set(res["ms"]) == stages
    assert res["card"] == "cpu" and res["all_finite"]
    assert res["whole_ms"] == res["ms"][res["whole"]] > 0
    # No kernel launches on the CPU: every wrapper took its plain version.
    assert not any(res["launches"].values())


def test_stage_profile_defaults_to_the_sinc_clock(capsys, monkeypatch):
    monkeypatch.delenv("BENCH_CLOCK_INTERP", raising=False)
    with torch.inference_mode():
        assert stage_profile.main(["2", "1024", "1"] + CPU) == 0
    assert _last_json(capsys)["clock_interp"] == "sinc"


def test_decode_bench_prints_its_stages(capsys):
    assert decode_bench.main(["1", "--iters", "2"] + CPU) == 0
    res = _last_json(capsys)
    assert set(res["stages"]) == {"full decode_block", "viterbi B=1", "rs frame B=1",
                                  "correlate_at"}
    for s in res["stages"].values():
        assert len(s["times_ms"]) == 2 and s["best_ms"] == min(s["times_ms"])
    assert res["all_finite"]


def test_clock_bench_names_what_has_no_counterpart(capsys):
    argv = ["exact", "sinc", "k4x32", "k16-sinc", "gather", "p16x32c128",
            "--iters", "1", "--channels", "2", "--block", "1024"]
    with torch.inference_mode():
        assert clock_bench.main(argv + CPU) == 0
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])
    rows = {r["spec"]: r for r in res["rows"]}
    assert set(rows) == {"exact", "sinc", "k4x32", "k16-sinc"}
    assert (rows["k4x32"]["clock_block_update"], rows["k4x32"]["interp"]) == (4, "mmse")
    assert "superchunks=32 has no counterpart" in rows["k4x32"]["note"]
    assert (rows["k16-sinc"]["clock_block_update"], rows["k16-sinc"]["interp"]) == (16, "sinc")
    assert set(res["no_counterpart"]) == {"gather", "p16x32c128"}
    assert "gather: no counterpart on the card" in out
    with pytest.raises(SystemExit):
        clock_bench.main(["k16y"] + CPU)


def test_frontend_bench_times_every_form_and_the_split_stages(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_CHANNELS", "2")
    monkeypatch.setenv("BENCH_BLOCK", "1024")
    monkeypatch.setenv("BENCH_ITERS", "1")
    with torch.inference_mode():
        assert frontend_bench.main(["both"] + CPU) == 0
        assert set(_last_json(capsys)["rows"]) == {
            "frontend", "frontend_bk8", "frontend_bf16", "frontend_bk8_bf16", "clock_cl",
            "frontend_bk8_agc", "frontend_bk8_costas", "frontend_bk8_agc_bf16",
            "frontend_bk8_costas_bf16"}
        assert frontend_bench.main(["split"] + CPU) == 0
        assert set(_last_json(capsys)["rows"]) == {"agc", "rrc_fir", "costas", "transpose"}
    monkeypatch.setenv("BENCH_FRONTEND_ROWS", "256")
    with pytest.raises(SystemExit, match="no counterpart"):
        frontend_bench.main(CPU)


def test_scaling_sweep_both_modes(capsys):
    with torch.inference_mode():
        assert scaling_sweep.main(["channels", "--list", "1,2", "--block", "1024"] + CPU) == 0
        res = _last_json(capsys)
        assert [r["channels"] for r in res["rows"]] == [1, 2]
        assert all(r["soft_finite"] and r["msamples_per_s"] >= 0 for r in res["rows"])
        assert scaling_sweep.main(["mesh", "--devices", "1,2", "--block", "512"] + CPU) == 0
    res = _last_json(capsys)
    assert [r["devices"] for r in res["rows"]] == [1, 2]
    assert res["rows"][0]["scaling_efficiency"] == 1.0
    assert {"sharding_efficiency", "s_sharded", "s_unsharded_1dev"} <= set(res["rows"][1])
    assert "only the overhead" in res["note"]


def test_host_budget_profile_reads_every_candidate(capsys):
    assert host_budget_profile.main(["--folds", "16", "--block", "1024"] + CPU) == 0
    res = _last_json(capsys)
    assert set(res["readings"]) == {
        "tx_synth", "fold_assembly", "h2d_f32_pageable", "h2d_int8_pageable", "d2h_field",
        "d2h_one", "d2h_small", "d2h_bulk", "device_demod"}
    assert res["readings"]["d2h_small"]["copies"] == 32 and res["all_finite"]


def test_drive_demod_passes_its_checks(capsys):
    with torch.inference_mode():
        assert drive_demod.main(["2", "3", "--block", "8192"] + CPU) == 0
    out = capsys.readouterr().out
    assert "DRIVE OK" in out
    res = json.loads(out.strip().splitlines()[-2])
    assert res["ok"] and len(res["channels"]) == 3


def test_make_lrit_signal_is_the_reference_tests():
    """The port's copy of `tests/test_demod_chain.py::make_lrit_signal`
    (convolution through the FFT) against the original (np.convolve)."""
    from test_demod_chain import make_lrit_signal as ref
    from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
    from xritdemod_tpu_torch.models.demodulator import DemodConfig

    a, ab = drive_demod.make_lrit_signal(np.random.default_rng(3), 3000, DemodConfig.lrit())
    b, bb = ref(np.random.default_rng(3), 3000, JDemodConfig.lrit())
    np.testing.assert_array_equal(ab, bb)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_seeconstellation_reads_a_file_and_plots(tmp_path, capsys):
    sym = (np.sign(np.random.default_rng(0).normal(size=400)) * 0.5).astype(np.complex64)
    path = tmp_path / "c.c64"
    sym.tofile(path)
    x, y = seeconstellation.from_file(str(path))
    np.testing.assert_array_equal(x, sym.real)
    grid = seeconstellation.ascii_plot(x, y)
    assert grid.count("*") == 2
    assert seeconstellation.main(["file", str(path), "--out", str(tmp_path / "c.png")]
                                 + CPU) == 0


def test_make_frozen_fixture_reproduces_the_pinned_hashes(tmp_path, capsys):
    """The port's synthesiser writes, into the directory it is given, the
    four streams whose SHA-256s the committed meta pins, and they decode."""
    assert make_frozen_fixture.main([str(tmp_path)] + CPU) == 0
    pinned = json.load(open(os.path.join(ROOT, "tests", "fixtures", "meta.json")))
    got = json.loads((tmp_path / "meta.json").read_text())
    assert got == pinned
    for name in ("lrit", "hrit"):
        for kind, key in (("soft_int8", "soft_sha256"), ("vcdus", "vcdu_sha256")):
            data = (tmp_path / f"{name}_{kind}.bin").read_bytes()
            assert hashlib.sha256(data).hexdigest() == pinned[name][key]
    decoded = _last_json(capsys)["decoded"]
    assert decoded == {"lrit": dict(frames=12, equal=12, sent=12),
                       "hrit": dict(frames=8, equal=8, sent=8)}


_NO_CARD_ARGV = {
    "ber_sweep": [], "viterbi_margin_sweep": [], "interp_margin": [],
    "scaling_sweep": ["channels"], "decode_profile": [], "decode_bench": [],
    "chain_bench": [], "stage_profile": [], "rx_profile": [], "clock_bench": [],
    "frontend_bench": [], "host_budget_profile": [], "drive_demod": [],
    "seeconstellation": ["file", "x.c64"], "make_frozen_fixture": ["out"],
}


@pytest.mark.parametrize("name", sorted(_NO_CARD_ARGV))
def test_tools_refuse_the_card_where_there_is_none(monkeypatch, name):
    """Each tool defaults to the card and exits with an error when there is
    no CUDA device, before it does any work (no fall-back to the CPU)."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"xritdemod_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(_NO_CARD_ARGV[name])


def test_launches_counts_the_wrappers_inside_its_block():
    from xritdemod_tpu_torch.ops import viterbi_cuda

    with timing.Launches() as n:
        viterbi_cuda.launches += 2
    assert n.counts == {"viterbi": 2}
    launches = {}
    ms, out = timing.timed(lambda c: c + 1, 0, 3, "cpu", launches)
    assert out == 4 and ms >= 0 and launches == {}


# -- the public names the port keeps beside the JAX package's -----------------

def test_correlate_at_and_phase_fix_equal_jax():
    rng = np.random.default_rng(5)
    soft = rng.normal(0, 1, 4000).astype(np.float32)
    uws = [jconst.LRIT_UW0, jconst.LRIT_UW2]
    pos = rng.integers(0, 4000 - 64, 37).astype(np.int32)
    pos[:3] = [0, 100, 4000 - 64]
    # Plant each word at a position so that some counts reach 64.
    for k, w in enumerate(uws):
        bits = np.array([(w >> (63 - i)) & 1 for i in range(64)])
        soft[100 + 1000 * k:164 + 1000 * k] = 1.0 - 2.0 * bits
    pos[3:5] = [100, 1100]
    jc, jw = jcorr.correlate_at(jnp.asarray(soft), jcorr.make_templates(uws), jnp.asarray(pos))
    tc, tw = tcorr.correlate_at(torch.from_numpy(soft), tcorr.make_templates(uws),
                                torch.from_numpy(pos))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tc[3] == tc[4] == 64 and list(tw[3:5]) == [0, 1]
    frames = rng.normal(0, 1, (6, 50)).astype(np.float32)
    word = np.array([0, 1, 2, 3, 1, 0], np.int32)
    np.testing.assert_array_equal(
        tcorr.phase_fix(torch.from_numpy(frames), torch.from_numpy(word)[:, None]).numpy(),
        np.asarray(jcorr.phase_fix(jnp.asarray(frames), jnp.asarray(word)[:, None])))
    np.testing.assert_array_equal(tcorr.phase_fix(torch.from_numpy(frames), 1).numpy(), -frames)


def test_randomize_and_nrzm_encode_equal_jax():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (3, 1020), dtype=np.int32).astype(np.uint8)
    np.testing.assert_array_equal(tder.randomize(torch.from_numpy(data)).numpy(),
                                  np.asarray(jder.randomize(jnp.asarray(data))))
    assert tder.randomize is tder.derandomize
    for prev in (0, 1):
        got = tnrzm.nrzm_encode_bytes(data[:, :40], prev)
        np.testing.assert_array_equal(got, jnrzm.nrzm_encode_bytes(data[:, :40], prev))
        back = tnrzm.nrzm_decode_bytes(torch.from_numpy(got), prev).numpy()
        np.testing.assert_array_equal(back, data[:, :40])


def test_cf32_arithmetic_equals_jax():
    rng = np.random.default_rng(7)
    a, b, c, d = (rng.normal(size=(3, 17)).astype(np.float32) for _ in range(4))
    J = lambda r, i: jcplx.CF32(jnp.asarray(r), jnp.asarray(i))
    T = lambda r, i: tcplx.CF32(torch.from_numpy(r), torch.from_numpy(i))
    ja, jb, ta, tb = J(a, b), J(c, d), T(a, b), T(c, d)
    same = lambda t, j: (np.testing.assert_array_equal(t.re.numpy(), np.asarray(j.re)),
                         np.testing.assert_array_equal(t.im.numpy(), np.asarray(j.im)))
    same(ta + tb, ja + jb)
    same(ta - tb, ja - jb)
    same(ta * tb, ja * jb)
    same(ta * 0.25, ja * 0.25)
    same(ta.conj(), ja.conj())
    np.testing.assert_array_equal(ta.abs2().numpy(), np.asarray(ja.abs2()))
    z = tcplx.zeros((2, 5))
    assert z.re.shape == (2, 5) and z.re.dtype == torch.float32 and not z.im.any()
    f = tcplx.full_like_shape(ta, (4,))
    jf = jcplx.full_like_shape(ja, (4,))
    same(f, jf)


def test_agc_block_exact_is_the_jax_exact_recursion():
    """The name of the port's exact AGC; on magnitudes `(m, 0)` cut to 12
    significant bits (so both sides' |x| is m) the two recursions agree at
    rtol 1e-6 (XLA may fuse the multiply-adds of its compiled scan; see
    `test_torch_demod.py::test_agc_is_the_exact_recursion`)."""
    assert tagc.agc_block_exact is tagc.agc_block
    m = np.random.default_rng(8).uniform(0.05, 2.0, (3, 500))
    scale = 2.0 ** (11 - np.floor(np.log2(m)))
    m = (np.round(m * scale) / scale).astype(np.float32)
    zero = np.zeros_like(m)
    g0 = np.ones(3, np.float32)
    p = dict(rate=0.01, reference=0.5, gain=1.0, max_gain=4000.0)
    jy, jg = jagc.agc_block_exact(jcplx.CF32(jnp.asarray(m), jnp.asarray(zero)), jnp.asarray(g0),
                                  jagc.AgcParams(**p))
    ty, tg = tagc.agc_block_exact(tcplx.CF32(torch.from_numpy(m), torch.from_numpy(zero)),
                                  torch.from_numpy(g0), tagc.AgcParams(**p))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("interp", ["sinc", "mmse"])
def test_clock_recovery_block_equals_jax(interp):
    """The unbatched form (default "sinc", as the JAX package's) over two
    chained blocks of a noisy BPSK stream: the valid masks equal, symbols,
    mu and the histories at atol 1e-4, omega at 1e-5 (the tolerances of
    `test_torch_sinc.py`: the two sinc forms evaluate their taps differently,
    and the mmse sums run in another order)."""
    rng = np.random.default_rng(9)
    sps = 4.2534
    n = np.arange(4000)
    bits = rng.integers(0, 2, 1000) * 2 - 1
    sig = np.repeat(bits, 5)[:4000] * 0.5 * np.exp(1j * 0.001 * n)
    sig = (sig + 0.05 * (rng.normal(size=4000) + 1j * rng.normal(size=4000))).astype(np.complex64)
    jp = jcr.ClockRecoveryParams(sps, 0.0037 ** 2 / 4, 0.0037, 0.005)
    tp = tcr.ClockRecoveryParams(sps, 0.0037 ** 2 / 4, 0.0037, 0.005)
    ns = tcr.max_symbols(2000, tp)
    js = jcr.clock_recovery_init(jp, 0.5)
    ts = tcr.clock_recovery_init(tp, 0.5)
    ts = tcplx.map_tree(lambda a: a[0], ts)
    kw = {} if interp == "sinc" else {"interp": "mmse"}
    for h in (slice(0, 2000), slice(2000, 4000)):
        x = sig[h]
        jy, jv, js = jcr.clock_recovery_block(jcplx.from_complex(x), js, jp, ns, **kw)
        ty, tv, ts = tcr.clock_recovery_block(tcplx.from_complex(x), ts, tp, ns, **kw)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tv.sum() > 400
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-4)
        np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-4)
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), atol=1e-4)
        np.testing.assert_allclose(ts.omega.numpy(), np.asarray(js.omega), atol=1e-5)
        np.testing.assert_array_equal(ts.ii.numpy(), np.asarray(js.ii))
        np.testing.assert_allclose(ts.p.re.numpy(), np.asarray(js.p.re), atol=1e-4)
        np.testing.assert_allclose(ts.tail.re.numpy(), np.asarray(js.tail.re), atol=0)


def test_version_info_names_the_package_and_torch():
    info = xritdemod_tpu_torch.version_info()
    assert info.startswith(f"xritdemod_tpu_torch {xritdemod_tpu_torch.__version__} (")
    assert f"torch {torch.__version__}" in info
