"""Tabulated 8-tap MMSE fractional interpolator (GR-parity clock mode).

GNU Radio's `clock_recovery_mm_cc` — the golden model of the reference's
ClockRecovery (demodulator/demod_tcp_qt.py:266, SatHelper
construction at demodulator.cpp:449) — interpolates with
`mmse_fir_interpolator_cc`: an 8-tap FIR whose taps come from a
precomputed table of NSTEPS+1 = 129 rows, selected by quantizing the
fractional delay to imu = round(mu * 128).  The default clock mode here
("sinc") evaluates windowed-sinc taps at the *exact* mu instead; this
module provides the GR-structure tabulated mode ("mmse", opt-in via
DemodConfig.clock_interp) for golden-model fidelity.

The table is REGENERATED from the published design criterion, not copied:
taps minimize the mean-squared interpolation error for a signal occupying
a fraction B of the Nyquist band,

    minimize  integral_{-B}^{B} | H(f) - e^{-j 2 pi f (3 + mu)} |^2 df,
    H(f) = sum_k h_k e^{-j 2 pi f k},

whose normal equations are the Toeplitz system

    sum_l h_l * 2B sinc(2B (k - l)) = 2B sinc(2B (k - 3 - mu)).

B = 0.25 (signal band-limited to a quarter of the sample rate — the
operating point of this chain: >= 2 samples/symbol after the RRC).
Solved densely with numpy; float32 rows are used as-is at runtime with
no per-symbol normalization, matching GR's use of its table.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["NSTEPS", "NTAPS", "mmse_taps_table"]

NSTEPS = 128
NTAPS = 8
_BW = 0.25


@functools.lru_cache(maxsize=None)
def mmse_taps_table() -> np.ndarray:
    """`(NSTEPS + 1, NTAPS)` float32 tap rows; row i resolves mu = i/128.

    Plain numpy; callers move it to their device.
    """
    k = np.arange(NTAPS, dtype=np.float64)
    # R[k, l] = 2B sinc(2B (k - l)); p_k(mu) = 2B sinc(2B (k - 3 - mu))
    R = 2 * _BW * np.sinc(2 * _BW * (k[:, None] - k[None, :]))
    rows = []
    for i in range(NSTEPS + 1):
        mu = i / NSTEPS
        p = 2 * _BW * np.sinc(2 * _BW * (k - 3.0 - mu))
        rows.append(np.linalg.solve(R, p))
    return np.asarray(rows, np.float32)
