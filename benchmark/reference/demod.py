"""The BPSK demodulator of one channel, plain float32, one block at a time.

The chain of the reference receiver (opensatelliteproject/xritdemod,
demodulator.cpp) with GNU Radio's block semantics:

  AGC (`agc_cc`):        y[n] = x[n] g;  g += rate (reference - |x[n]| g);  g <= max_gain
  RRC matched filter:    z[n] = sum_k h[k] w[n + k] over w = [history | y]
  Costas loop (`costas_loop_cc`, order 2, damping sqrt(2)/2):
                         v = z exp(-i phase);  e = clip(Re v Im v, +-1)
                         freq = clip(freq + beta e, +-1);  phase += freq + alpha e
                         (one +-2 pi wrap step)
  M&M clock (`clock_recovery_mm_cc`, MMSE interpolator): per symbol
                         p0 = interp(u[ii .. ii+7], mu);  c0 = (Re p0 > 0, Im p0 > 0)
                         e = clip(Re((p0 - p2) conj(c1) - (c0 - c2) conj(p1)), +-1)
                         omega = mid + clip(omega + g_omega e - mid, +-lim)
                         mu += omega + g_mu e;  ii += floor(mu);  mu -= floor(mu)
                         soft symbol = Re p0

The clock reads `u = [tail | block]` with a 32-sample tail carried from the
previous block, emits symbols while `ii < len(u) - 8`, and re-bases `ii`
onto the next block.

The clock runs in float32, the precision the configuration states (the
reference receiver's C++ loops run in `float`): each of its steps in numpy
float32 scalars, in the order of the formulas above.  There float32 steers
the loop: the omega update (a few 1e-6 against an omega of ~4) moves in
steps of omega's last bits, so a float64 clock follows another path, and
the reference keeps the stated precision.  The AGC and the Costas loop,
whose float32 rounding stays below 1e-6 of their state, run in float64, and
the filter's sums are taken in float64; the state they carry is stored in
float32 between blocks, as the program's is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from benchmark.reference.filters import NSTEPS, mmse_table, rrc_taps

NTAIL = 32
INTERP = 8


F32 = np.float32


@dataclass
class DemodParams:
    sps: float
    rrc: np.ndarray            # float32 taps
    agc_rate: np.float32
    agc_reference: np.float32
    agc_max_gain: np.float32
    costas_alpha: np.float32
    costas_beta: np.float32
    omega_mid: np.float32
    omega_lim: np.float32
    gain_omega: np.float32
    gain_mu: np.float32
    table: np.ndarray          # (129, 8) float32

    @classmethod
    def from_config(cls, demod: dict) -> "DemodParams":
        rate = demod["sample_rate"] / demod["decimation"]
        sps = rate / demod["symbol_rate"]
        bw = demod["pll_alpha"]
        damping = math.sqrt(2.0) / 2.0
        denom = 1.0 + 2.0 * damping * bw + bw * bw
        ca = demod["clock_alpha"]
        return cls(
            sps=sps,
            rrc=rrc_taps(1.0, rate, demod["symbol_rate"], demod["rrc_alpha"],
                         demod["rrc_taps"]).astype(F32),
            agc_rate=F32(demod["agc_rate"]), agc_reference=F32(demod["agc_reference"]),
            agc_max_gain=F32(demod["agc_max_gain"]),
            costas_alpha=F32(4.0 * damping * bw / denom), costas_beta=F32(4.0 * bw * bw / denom),
            omega_mid=F32(sps), omega_lim=F32(sps * demod["clock_omega_limit"]),
            gain_omega=F32(ca * ca / 4.0), gain_mu=F32(ca), table=mmse_table().astype(F32),
        )


@dataclass
class DemodState:
    gain: np.float32
    rrc_hist: np.ndarray       # (ntaps - 1,) complex64
    phase: np.float32
    freq: np.float32
    mu: np.float32
    omega: np.float32
    ii: int
    p: list                    # [p1, p2, p3] (re, im) float32 pairs, lag 1..3
    c: list                    # [c1, c2, c3] slicer history
    tail: np.ndarray           # (NTAIL,) complex64

    @classmethod
    def initial(cls, params: DemodParams, demod: dict) -> "DemodState":
        z = (F32(0), F32(0))
        return cls(gain=F32(demod["agc_gain"]), rrc_hist=np.zeros(len(params.rrc) - 1, np.complex64),
                   phase=F32(0), freq=F32(0), mu=F32(demod["clock_mu"]), omega=params.omega_mid,
                   ii=NTAIL, p=[z, z, z], c=[z, z, z], tail=np.zeros(NTAIL, np.complex64))


def _clip(v, lo, hi):
    return hi if v > hi else (lo if v < lo else v)


def agc(x: np.ndarray, gain, p: DemodParams):
    mags = np.abs(x).tolist()
    gains = [0.0] * len(mags)
    g, rate, ref, mx = float(gain), float(p.agc_rate), float(p.agc_reference), float(p.agc_max_gain)
    for n, m in enumerate(mags):
        gains[n] = g
        g = g + rate * (ref - m * g)
        if mx > 0 and g > mx:
            g = mx
    return x * np.asarray(gains), g


def costas(z: np.ndarray, phase, freq, p: DemodParams):
    re, im = z.real.tolist(), z.imag.tolist()
    out_r, out_i = [0.0] * len(re), [0.0] * len(re)
    alpha, beta, two_pi = float(p.costas_alpha), float(p.costas_beta), float(F32(2.0 * math.pi))
    cos, sin = math.cos, math.sin
    phase, freq = float(phase), float(freq)
    for n in range(len(re)):
        c, s = cos(phase), sin(phase)
        yr = re[n] * c + im[n] * s
        yi = im[n] * c - re[n] * s
        out_r[n], out_i[n] = yr, yi
        e = yr * yi
        e = 1.0 if e > 1.0 else (-1.0 if e < -1.0 else e)
        freq = freq + beta * e
        freq = 1.0 if freq > 1.0 else (-1.0 if freq < -1.0 else freq)
        phase = phase + freq + alpha * e
        if phase > two_pi:
            phase -= two_pi
        if phase < -two_pi:
            phase += two_pi
    return np.asarray(out_r) + 1j * np.asarray(out_i), phase, freq


def clock(u: np.ndarray, st: DemodState, p: DemodParams):
    """Symbols of one block from `u = [tail | block]`; updates `st`."""
    ur, ui = u.real.astype(F32), u.imag.astype(F32)
    table = p.table
    limit = len(ur) - INTERP
    mu, omega, ii = F32(st.mu), F32(st.omega), int(st.ii)
    (p1r, p1i), (p2r, p2i), (p3r, p3i) = st.p
    (c1r, c1i), (c2r, c2i), (c3r, c3i) = st.c
    mid, lim, g_om, g_mu = p.omega_mid, p.omega_lim, p.gain_omega, p.gain_mu
    steps, half, one, zero = F32(NSTEPS), F32(0.5), F32(1), F32(0)
    out = []
    while ii < limit:
        imu = int(np.floor(mu * steps + half))
        row = table[0 if imu < 0 else (NSTEPS if imu > NSTEPS else imu)]
        wr = ur[ii:ii + INTERP] * row
        wi = ui[ii:ii + INTERP] * row
        pr, pi = wr[0], wi[0]
        for k in range(1, INTERP):
            pr = pr + wr[k]
            pi = pi + wi[k]
        c0r = one if pr > 0 else zero
        c0i = one if pi > 0 else zero
        e = ((pr - p2r) * c1r + (pi - p2i) * c1i) - ((c0r - c2r) * p1r + (c0i - c2i) * p1i)
        e = _clip(e, -one, one)
        omega = mid + _clip((omega + g_om * e) - mid, -lim, lim)
        mu = mu + omega + g_mu * e
        adv = np.floor(mu)
        ii = max(ii + int(adv), 0)
        mu = mu - adv
        p3r, p3i, p2r, p2i, p1r, p1i = p2r, p2i, p1r, p1i, pr, pi
        c3r, c3i, c2r, c2i, c1r, c1i = c2r, c2i, c1r, c1i, c0r, c0i
        out.append(pr)
    st.mu, st.omega, st.ii = mu, omega, ii - (len(ur) - NTAIL)
    st.p = [(p1r, p1i), (p2r, p2i), (p3r, p3i)]
    st.c = [(c1r, c1i), (c2r, c2i), (c3r, c3i)]
    st.tail = u[-NTAIL:].astype(np.complex64)
    return np.asarray(out, F32)


def demod_block(x: np.ndarray, st: DemodState, p: DemodParams) -> np.ndarray:
    """One `(T,)` complex block through the chain; `st` advances.  Returns
    the block's soft symbols (float32)."""
    y, gain = agc(x, st.gain, p)
    st.gain = F32(gain)
    w = np.concatenate([st.rrc_hist, y.astype(np.complex64)])
    z = np.correlate(w.astype(np.complex128), p.rrc.astype(np.float64), mode="valid")
    st.rrc_hist = w[-(len(p.rrc) - 1):].copy()
    v, phase, freq = costas(z, st.phase, st.freq, p)
    st.phase, st.freq = F32(phase), F32(freq)
    return clock(np.concatenate([st.tail, v.astype(np.complex64)]), st, p)
