"""FIR tap design matching GNU Radio `firdes` semantics.

The reference designs its taps with SatHelper's `Filters::RRC` and
`Filters::lowPass` (used at demodulator/src/demodulator.cpp:443-444),
which follow GNU Radio's `firdes.root_raised_cosine` / `firdes.low_pass`
(the golden-model flowgraph demodulator/demod_tcp_qt.py:95-96,
261-262 uses firdes directly).  Tap design is host-side, tiny, and done once;
plain NumPy in float64 then cast.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "rrc_taps",
    "lowpass_taps",
    "highpass_taps",
    "hamming",
    "blackman",
    "compute_ntaps",
]


def rrc_taps(
    gain: float,
    sampling_freq: float,
    symbol_rate: float,
    alpha: float,
    ntaps: int,
) -> np.ndarray:
    """Root-raised-cosine taps, GR `firdes::root_raised_cosine` semantics."""
    ntaps |= 1  # odd
    spb = sampling_freq / symbol_rate
    taps = np.zeros(ntaps, dtype=np.float64)
    scale = 0.0
    for i in range(ntaps):
        xindx = i - ntaps // 2
        x1 = math.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if i != ntaps // 2:
                num = math.cos((1 + alpha) * x1) + math.sin((1 - alpha) * x1) / (
                    4 * alpha * xindx / spb
                )
            else:
                num = math.cos((1 + alpha) * x1) + (1 - alpha) * math.pi / (4 * alpha)
            den = x3 * math.pi
        else:
            if alpha == 1.0:
                taps[i] = -1.0
                scale += -1.0
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (
                math.sin(x2) * (1 + alpha) * math.pi
                - math.cos(x3) * ((1 - alpha) * math.pi * spb) / (4 * alpha * xindx)
                + math.sin(x3) * spb * spb / (4 * alpha * xindx * xindx)
            )
            den = -32.0 * math.pi * alpha * alpha * xindx / spb
        taps[i] = 4.0 * alpha * num / den
        scale += taps[i]
    return (taps * gain / scale).astype(np.float32)


def hamming(ntaps: int) -> np.ndarray:
    """GR window::hamming: 0.54 - 0.46 cos(2 pi n / (N-1))."""
    n = np.arange(ntaps, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * math.pi * n / (ntaps - 1))


def compute_ntaps(
    sampling_freq: float, transition_width: float, attenuation_db: float = 53.0
) -> int:
    """GR firdes::compute_ntaps (Hamming window attenuation 53 dB)."""
    ntaps = int(attenuation_db * sampling_freq / (22.0 * transition_width))
    if (ntaps & 1) == 0:
        ntaps += 1
    return ntaps


def blackman(ntaps: int) -> np.ndarray:
    """GR window::blackman: 0.42 - 0.5 cos(2 pi n/(N-1)) + 0.08 cos(4 pi n/(N-1))."""
    n = np.arange(ntaps, dtype=np.float64)
    x = 2.0 * math.pi * n / (ntaps - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)


def highpass_taps(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    attenuation_db: float = 74.0,
) -> np.ndarray:
    """Windowed-sinc high pass, GR `firdes::high_pass` with Blackman window
    (the golden-model SNR estimator's noise tap, demod_tcp_qt.py:263-264;
    GR WIN_BLACKMAN max attenuation 74 dB); unity gain at Nyquist."""
    ntaps = compute_ntaps(sampling_freq, transition_width, attenuation_db)
    w = blackman(ntaps)
    m = (ntaps - 1) // 2
    fw_t0 = 2.0 * math.pi * cutoff_freq / sampling_freq
    taps = np.zeros(ntaps, dtype=np.float64)
    for n in range(-m, m + 1):
        if n == 0:
            taps[n + m] = (1.0 - fw_t0 / math.pi) * w[n + m]
        else:
            taps[n + m] = -math.sin(n * fw_t0) / (n * math.pi) * w[n + m]
    # normalize to unity gain at the Nyquist frequency (GR semantics)
    fmax = sum(taps[m + n] * math.cos(math.pi * n) for n in range(-m, m + 1))
    return (taps * (gain / fmax)).astype(np.float32)


def lowpass_taps(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    attenuation_db: float = 53.0,
) -> np.ndarray:
    """Windowed-sinc low pass, GR `firdes::low_pass` with Hamming window."""
    ntaps = compute_ntaps(sampling_freq, transition_width, attenuation_db)
    w = hamming(ntaps)
    m = (ntaps - 1) // 2
    fw_t0 = 2.0 * math.pi * cutoff_freq / sampling_freq
    taps = np.zeros(ntaps, dtype=np.float64)
    for n in range(-m, m + 1):
        if n == 0:
            taps[n + m] = fw_t0 / math.pi * w[n + m]
        else:
            taps[n + m] = math.sin(n * fw_t0) / (n * math.pi) * w[n + m]
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1 :])
    return (taps * (gain / fmax)).astype(np.float32)
