"""The reference's independent checks, run on the port (its plain forms, on
the CPU).

The known-answer tests of the JAX package (`test_demod_kat.py`,
`test_rs_kat.py`, `test_viterbi_kat.py`) and its SHA-pinned decode fixture
(`test_frozen_fixture.py`) hold it against code and literals that share
nothing with either package: textbook encoders, scalar transcriptions of the
GNU Radio blocks, frozen parity and soft-symbol literals, frozen streams.
This file imports those modules by name and feeds the port what they feed
the JAX package, with the same tolerances:

  (i)   both frozen soft-symbol streams through `StreamDecoder`: VCDUs
        byte-equal to the frozen `*_vcdus.bin`;
  (ii)  Reed-Solomon: frozen parity, decode of independent codewords,
        failure beyond t;
  (iii) Viterbi: frozen encoder answers, the exhaustive maximum-likelihood
        check, clean recovery;
  (iv)  the scalar AGC, Costas and M&M transcriptions (M&M with both
        interpolators) against the port's stages;
  (v)   the raw-IQ fixture through the serial `Demodulator.process` in two
        32768-sample blocks against the scalar chain, both interpolators;
  (vi)  the fixture over 4 channels through `block_batch`, fused and split,
        both interpolators, against the scalar chain on every channel.

The scalar chain is computed once per interpolator and shared
(`test_demod_kat.chain_cached`).
"""

import inspect
import json

import numpy as np
import pytest
import torch

import test_demod_kat as kat
import test_frozen_fixture as frozen
import test_rs_kat as rskat
import test_viterbi_kat as vkat
from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import agc as agc_op
from xritdemod_tpu_torch.ops import clock_recovery as cr
from xritdemod_tpu_torch.ops import conv_code, viterbi
from xritdemod_tpu_torch.ops import costas as costas_op
from xritdemod_tpu_torch.ops import reed_solomon as rs
from xritdemod_tpu_torch.utils.cplx import CF32

BLOCK = 32768


@pytest.fixture(autouse=True)
def _inference_mode():
    """The plain forms loop per sample in Python: inference mode takes a
    part of each torch call's overhead (the arithmetic is the same, bit for
    bit)."""
    with torch.inference_mode():
        yield


def _cf(x) -> CF32:
    """complex ndarray `(..., n)` -> CF32 on the CPU."""
    return CF32(torch.from_numpy(np.ascontiguousarray(x.real, np.float32)),
                torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)))


# -- (i) the frozen decode fixture ------------------------------------------

@pytest.mark.parametrize("mode", ["lrit", "hrit"])
def test_frozen_stream_decodes_bit_exact(mode):
    """The SHA-pinned int8 stream, fed in 16384-symbol chunks as the wire
    ingest does, through the port's `StreamDecoder`: every delivered VCDU
    byte-equal to the frozen payloads, in order, with their counters, SCID
    and VCID."""
    meta = json.loads((frozen.FIXDIR / "meta.json").read_text())[mode]
    wire = np.frombuffer(frozen._load(f"{mode}_soft_int8.bin"), np.int8)
    expected = np.frombuffer(frozen._load(f"{mode}_vcdus.bin"), np.uint8).reshape(
        meta["n_vcdus"], 892)
    dec = StreamDecoder(DecoderConfig(mode=mode, frames_per_block=4), device="cpu")
    batches = []
    for i in range(0, wire.size, 16384):
        batches += dec.push(wire[i : i + 16384].astype(np.float32))
    batches += dec.flush()
    cat = lambda f: np.concatenate([getattr(b, f).numpy() for b in batches])
    ok = cat("frame_ok")
    np.testing.assert_array_equal(cat("vcdu")[ok], expected)
    assert cat("counter")[ok].tolist() == list(
        range(meta["counter0"], meta["counter0"] + meta["n_vcdus"]))
    assert set(cat("scid")[ok].tolist()) == {meta["scid"]}
    assert set(cat("vcid")[ok].tolist()) == {meta["vcid"]}


# -- (ii) Reed-Solomon -------------------------------------------------------

@pytest.mark.parametrize("data,parity", [
    (bytes(223), bytes(32)),
    (rskat._RAMP_DATA, rskat._RAMP_PARITY),
    (rskat._RAND_DATA, rskat._RAND_PARITY),
], ids=["zeros", "ramp", "random"])
def test_rs_frozen_parity(data, parity):
    """The port's encoder gives the frozen parity, as the textbook encoder
    does."""
    assert bytes(rskat._indep_encode(list(data))[rskat._K:]) == parity
    cw = rs.rs_encode_np(np.frombuffer(data, np.uint8))
    assert bytes(cw[rskat._K:].tolist()) == parity


def test_rs_decode_of_independent_codewords():
    """Textbook codewords with 0, 1, 8 and 16 symbol errors: the port's
    decoder returns the codeword (independent syndromes zero, distance equal
    to the count it reports)."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (4, rskat._K)).astype(np.uint8)
    cws = np.array([rskat._indep_encode(d.tolist()) for d in data], np.uint8)
    bad = cws.copy()
    for r, ne in enumerate([0, 1, 8, 16]):
        for p in rng.choice(rskat._N, size=ne, replace=False):
            bad[r, p] ^= rng.integers(1, 256)
    corr, nerr = rs.rs_decode(torch.from_numpy(bad))
    corr, nerr = corr.numpy(), nerr.numpy()
    for r, ne in enumerate([0, 1, 8, 16]):
        assert rskat._indep_syndromes(corr[r].tolist()) == [0] * 32
        assert int(nerr[r]) == ne == int(np.sum(bad[r] != corr[r]))
        assert corr[r].tolist() == cws[r].tolist()


def test_rs_decode_failure_beyond_t():
    """24 random symbol errors in a textbook codeword: reported as -1."""
    rng = np.random.default_rng(13)
    cw = np.array(rskat._indep_encode(rng.integers(0, 256, rskat._K).tolist()), np.uint8)
    bad = cw.copy()
    for p in rng.choice(rskat._N, size=24, replace=False):
        bad[p] ^= rng.integers(1, 256)
    _, nerr = rs.rs_decode(torch.from_numpy(bad[None]))
    assert int(nerr[0]) == -1


# -- (iii) Viterbi -----------------------------------------------------------

# The frozen answers of test_viterbi_kat.py's test_frozen_known_answers, a
# local list there; the test below checks that its source still holds them.
VITERBI_FROZEN = [
    (bytes(8), "ffffffffffffffffffffffffffffffff"),
    (bytes(range(16)), "fffffffc43810e32b27438c784bac909"
                       "75a0e3135f6e12ddae9b24289855d5e6"),
    (b"\xa5" * 8, "1e2aa55aa55aa55aa55aa55aa55aa55a"),
]


def test_viterbi_frozen_known_answers():
    """The port's convolutional encoder gives the frozen parity, as the
    independent encoder does."""
    src = inspect.getsource(vkat.TestIndependentEncoder.test_frozen_known_answers)
    for data, hexparity in VITERBI_FROZEN:
        for part in (hexparity[:32], hexparity[32:]):
            assert part in src
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        indep = np.array(vkat._indep_encode(bits), np.uint8)
        assert np.packbits(indep).tobytes().hex() == hexparity
        ours, _ = conv_code.conv_encode_bits(bits)
        assert np.packbits(ours).tobytes().hex() == hexparity


def test_viterbi_is_maximum_likelihood():
    """The port's decoder attains the global maximum of sum(soft * (1-2c))
    over all 2^16 (initial state, 10-bit message) pairs, for 8 random
    soft inputs."""
    T, B = 10, 8
    coded = vkat._all_coded(T)
    signs = (1.0 - 2.0 * coded).astype(np.float64)
    msg = np.arange(1 << (6 + T)) & ((1 << T) - 1)
    soft = np.random.default_rng(0xC0DE).normal(0.0, 1.0, (B, 2 * T)).astype(np.float32)
    bits, _ = viterbi.viterbi_decode(torch.from_numpy(soft))
    metrics = signs @ soft.astype(np.float64).T
    for j in range(B):
        got = int("".join(map(str, bits[j].tolist())), 2)
        assert metrics[msg == got, j].max() == metrics[:, j].max(), j


def test_viterbi_recovers_clean_message():
    rng = np.random.default_rng(0xC0DF)
    tx_bits = rng.integers(0, 2, 12).astype(np.uint8)
    soft = (1.0 - 2.0 * np.array(vkat._indep_encode(tx_bits), np.float32))[None, :]
    bits, errors = viterbi.viterbi_decode(torch.from_numpy(soft))
    assert bits[0].tolist() == tx_bits.tolist() and int(errors[0]) == 0


# -- (iv) the scalar GR transcriptions against the port's stages ---------------

def _agc64(x, gr_magnitude):
    """The AGC recursion of the fixture's parameters in float64: gains applied
    at each sample and the gain carried out.  `gr_magnitude` measures the
    output as GR's `agc_cc` does, `|x g|`; otherwise as the port does,
    `|x| g` (the same value in exact arithmetic)."""
    xr, xi = x.real.astype(np.float64), x.imag.astype(np.float64)
    mag = np.hypot(xr, xi)
    g, gains = float(kat.AGC_GAIN), np.empty(x.shape[0])
    for n in range(x.shape[0]):
        gains[n] = g
        m = np.sqrt((xr[n] * g) ** 2 + (xi[n] * g) ** 2) if gr_magnitude else mag[n] * g
        g = min(g + kat.AGC_RATE * (kat.AGC_REF - m), kat.AGC_MAX)
    return gains, g


def _agc32_bound(x, gains, final):
    """How far a float32 run of the recursion may drift from the float64 one,
    per output sample and for the carried gain, on any host: each step adds
    at most 4 ulp of every term of the update (the magnitude's own rounding
    of up to 2 ulp, the product, the difference, the step), and an error of
    the gain is carried on multiplied by `|1 - rate |x||` (the clamp only
    shrinks it).  An output adds 2 ulp of its own."""
    u = 2.0 ** -24
    mag = np.abs(x.astype(np.complex128))
    nxt = np.append(gains[1:], final)
    d, drift = 0.0, np.empty(x.shape[0])
    for n in range(x.shape[0]):
        drift[n] = d
        step = 4 * u * (abs(nxt[n]) + kat.AGC_RATE * (mag[n] * gains[n] + kat.AGC_REF))
        d = abs(1.0 - kat.AGC_RATE * mag[n]) * d + step
    return mag * drift + 2 * u * mag * gains, d


def test_agc_scalar_vs_port():
    """Scalar `agc_cc` vs the port's exact AGC on the fixture, each held to a
    float64 recursion of its own formula (GR measures `|x g|`, the port
    `|x| g`) within the float32 drift bound of `_agc32_bound`, outputs and
    carried gain; and the two float64 recursions agree at rtol 1e-12.  One
    ulp a step of a host's `sqrt` or fused multiply-add can move a float32
    run by more than a fixed tolerance over 65536 steps, never past the
    bound.  The port's run is also the float32 recursion written out in
    numpy, one rounding per operation, on its own magnitudes, bit for bit
    (whatever the host's `sqrt` gave them)."""
    x = kat.load_fixture()
    ref, ref_gain = kat.stages_cached()[:2]
    p = agc_op.AgcParams(kat.AGC_RATE, kat.AGC_REF, kat.AGC_GAIN, kat.AGC_MAX)
    y, g = agc_op.agc_block(_cf(x), agc_op.agc_init(p), p)
    port = y.re.numpy() + 1j * y.im.numpy()

    gr_gains, gr_final = _agc64(x, gr_magnitude=True)
    port_gains, port_final = _agc64(x, gr_magnitude=False)
    np.testing.assert_allclose(port_gains, gr_gains, rtol=1e-12)
    assert abs(port_final - gr_final) <= 1e-12 * gr_final

    f32 = np.float32
    mag = _cf(x).abs().numpy()
    gain, gains32 = f32(kat.AGC_GAIN), np.empty(x.shape[0], f32)
    for n in range(x.shape[0]):
        gains32[n] = gain
        gain = min(gain + f32(kat.AGC_RATE) * (f32(kat.AGC_REF) - mag[n] * gain), f32(kat.AGC_MAX))
    np.testing.assert_array_equal(y.re.numpy(), x.real.astype(f32) * gains32)
    np.testing.assert_array_equal(y.im.numpy(), x.imag.astype(f32) * gains32)
    assert float(g) == float(gain)

    for out, final, (gains, final64) in (
        (ref, float(ref_gain), (gr_gains, gr_final)),
        (port, float(g), (port_gains, port_final)),
    ):
        bound, gain_bound = _agc32_bound(x, gains, final64)
        err = np.abs(out.astype(np.complex128) - x.astype(np.complex128) * gains)
        assert (err <= bound).all(), float((err / bound).max())
        assert abs(final - final64) <= gain_bound


def test_costas_scalar_vs_port():
    """Scalar `costas_loop_cc` vs the port's Costas loop on the same post-RRC
    stream: gains equal to the control-loop formula, output atol 5e-5, freq
    within 1e-6, phase within 1e-3."""
    _, _, y, ref, (ref_phase, ref_freq) = kat.stages_cached()
    params = costas_op.costas_gains(kat.LOOP_BW)
    a, b = kat.costas_loop_gains(kat.LOOP_BW)
    assert np.isclose(params.alpha, a, rtol=1e-12) and np.isclose(params.beta, b, rtol=1e-12)
    out, st = costas_op.costas_block(_cf(y), costas_op.costas_init(), params)
    np.testing.assert_allclose(out.re.numpy() + 1j * out.im.numpy(), ref, atol=5e-5)
    assert abs(float(st.freq) - float(ref_freq)) < 1e-6
    assert abs(float(st.phase) - float(ref_phase)) < 1e-3


@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_mm_clock_scalar_vs_port(interp):
    """Scalar `clock_recovery_mm_cc` vs the port's clock on the same
    carrier-corrected stream (one channel): the same symbol count, symbols
    atol 2e-4, hard decisions equal away from the threshold, the final
    stream position within 1, omega within 1e-5, mu within 2e-3."""
    y = kat.stages_cached()[3]
    ref, (ref_mu, ref_om, ref_ii) = kat.chain_cached(interp)[0], kat.chain_cached(interp)[1][2]
    params = cr.ClockRecoveryParams(omega=kat.SPS, gain_omega=kat.CLOCK_ALPHA ** 2 / 4.0,
                                    gain_mu=kat.CLOCK_ALPHA)
    st = cr.clock_recovery_init(params, mu=0.5, channels=1)
    syms, valid, st = cr.clock_recovery_block_batch(
        _cf(y[None, :]), st, params, cr.max_symbols(y.shape[0], params), interp)
    v = valid[0].numpy()
    got = (syms.re[0].numpy() + 1j * syms.im[0].numpy())[v]
    assert got.shape[0] == ref.shape[0]
    np.testing.assert_allclose(got, ref, atol=2e-4)
    strong = np.abs(ref.real) > 1e-2
    assert np.array_equal(np.sign(got.real[strong]), np.sign(ref.real[strong]))
    assert abs(int(st.ii[0]) + y.shape[0] - cr.NTAIL - ref_ii) <= 1
    assert abs(float(st.omega[0]) - float(ref_om)) < 1e-5
    assert abs(float(st.mu[0]) - float(ref_mu)) < 2e-3


# -- (v) the serial anchor, (vi) the batch contract -----------------------------

def _against_chain(got, interp, strong_at=2e-2):
    ref = kat.chain_cached(interp)[0]
    assert got.shape[0] == ref.shape[0]
    np.testing.assert_allclose(got, ref.real, atol=2e-3)
    strong = np.abs(ref.real) > strong_at
    assert np.array_equal(np.sign(got[strong]), np.sign(ref.real[strong]))


_BATCH: dict = {}


def _batch_chain(interp, frontend):
    """The fixture copied over 4 channels through `block_batch` in two
    32768-sample blocks, once per interpolator and front end for the whole
    module: `(per-channel symbols, final state)`."""
    key = (interp, frontend)
    if key not in _BATCH:
        cfg = DemodConfig.lrit(sample_rate=int(kat.FS), clock_interp=interp,
                               frontend_kernel=frontend)
        demod = Demodulator(cfg, block_len=BLOCK, device="cpu")
        state = demod.init_state_batch(4)
        x = kat.load_fixture()
        outs = []
        for i in range(0, x.shape[0], BLOCK):
            soft, valid, state = demod.block_batch(np.tile(x[i : i + BLOCK], (4, 1)), state)
            outs.append((soft.numpy(), valid.numpy()))
        _BATCH[key] = [np.concatenate([s[c][v[c]] for s, v in outs]) for c in range(4)], state
    return _BATCH[key]


@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_full_chain_fixture_vs_serial_demodulator(interp):
    """The end-to-end anchor: the raw-IQ fixture through `process` in two
    32768-sample blocks against the scalar chain: the same symbol count,
    symbols atol 2e-3, hard decisions equal away from the threshold, omega
    within 1e-5.  On the CPU `process` is the split chain on one channel, so
    its symbols and clock state also equal channel 0 of the split
    `block_batch` run of (vi), bit for bit."""
    cfg = DemodConfig.lrit(sample_rate=int(kat.FS), clock_interp=interp)
    demod = Demodulator(cfg, block_len=BLOCK, device="cpu")
    state = demod.init_state()
    x = kat.load_fixture()
    outs = []
    for i in range(0, x.shape[0], BLOCK):
        soft, valid, state = demod.process(x[i : i + BLOCK], state)
        outs.append(soft[valid].numpy())
    got = np.concatenate(outs)
    _against_chain(got, interp)
    ref_om = kat.chain_cached(interp)[1][2][1]
    assert abs(float(state.clock.omega) - float(ref_om)) < 1e-5
    split, split_state = _batch_chain(interp, "split")
    np.testing.assert_array_equal(got, split[0])
    sc = split_state.clock
    for name in ("mu", "omega", "ii"):
        assert torch.equal(getattr(state.clock, name), getattr(sc, name)[0])
    for name in ("p", "c", "tail"):
        a, b = getattr(state.clock, name), getattr(sc, name)
        assert torch.equal(a.re, b.re[0]) and torch.equal(a.im, b.im[0])


@pytest.mark.parametrize("frontend", ["fused", "split"])
@pytest.mark.parametrize("interp", ["mmse", "sinc"])
def test_full_chain_fixture_vs_batch_demodulator(interp, frontend):
    """The fixture copied over 4 channels through `block_batch` (two
    32768-sample blocks): every channel agrees with the scalar chain (same
    count, atol 2e-3, hard decisions away from the threshold) and the four
    channels are identical."""
    per_channel, _ = _batch_chain(interp, frontend)
    for got in per_channel:
        np.testing.assert_array_equal(got, per_channel[0])
    _against_chain(per_channel[0], interp)
