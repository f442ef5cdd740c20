"""Filter designs of the GOES xRIT receive chain, in float64 numpy.

Written from the published definitions, not from the program under test:

- `rrc_taps`: GNU Radio's `firdes::root_raised_cosine` (the reference
  demodulator builds its matched filter with it, demodulator.cpp:443-444),
  normalised to unit DC gain.
- `mmse_table`: the 8-tap MMSE fractional interpolator of GNU Radio's
  `clock_recovery_mm_cc`, as the rows that minimise the mean-squared
  interpolation error of a signal in a quarter of the sample rate,
  `sum_l h_l 2B sinc(2B (k - l)) = 2B sinc(2B (k - 3 - mu))`, B = 0.25, for
  mu = i / 128, i = 0 .. 128.
"""

from __future__ import annotations

import math

import numpy as np

NSTEPS = 128
NTAPS = 8
_BAND = 0.25


def rrc_taps(gain: float, sampling_freq: float, symbol_rate: float, alpha: float,
             ntaps: int) -> np.ndarray:
    """Root-raised-cosine taps (odd length), float64."""
    ntaps |= 1
    spb = sampling_freq / symbol_rate
    taps = np.zeros(ntaps)
    for i in range(ntaps):
        xi = i - ntaps // 2
        x1 = math.pi * xi / spb
        x2 = 4.0 * alpha * xi / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if xi != 0:
                num = math.cos((1 + alpha) * x1) + math.sin((1 - alpha) * x1) / (4 * alpha * xi / spb)
            else:
                num = math.cos((1 + alpha) * x1) + (1 - alpha) * math.pi / (4 * alpha)
            den = x3 * math.pi
        else:
            if alpha == 1.0:
                taps[i] = -1.0
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (math.sin(x2) * (1 + alpha) * math.pi
                   - math.cos(x3) * ((1 - alpha) * math.pi * spb) / (4 * alpha * xi)
                   + math.sin(x3) * spb * spb / (4 * alpha * xi * xi))
            den = -32.0 * math.pi * alpha * alpha * xi / spb
        taps[i] = 4.0 * alpha * num / den
    return taps * gain / taps.sum()


def mmse_table() -> np.ndarray:
    """`(129, 8)` float64 interpolator rows; row i is for mu = i / 128."""
    k = np.arange(NTAPS, dtype=np.float64)
    gram = 2 * _BAND * np.sinc(2 * _BAND * (k[:, None] - k[None, :]))
    rows = [np.linalg.solve(gram, 2 * _BAND * np.sinc(2 * _BAND * (k - 3.0 - i / NSTEPS)))
            for i in range(NSTEPS + 1)]
    return np.asarray(rows)
