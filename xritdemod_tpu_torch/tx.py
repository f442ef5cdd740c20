"""Host-side xRIT transmit chain — test fixture and impairment injector.

The port's own copy of `xritdemod_tpu/tx.py`, numpy (and scipy for the pulse
shaping) only, so captures can be synthesised without JAX.  This module is
the *satellite side* — it builds bit-exact CADU coded symbol
streams (VCDU -> RS(255,223) 4-way interleave -> CCSDS randomizer -> sync
marker -> [NRZ-M for HRIT] -> rate-1/2 K=7 convolutional encode -> BPSK
soft symbols), the exact inverse of the decoder pipeline
(decoder/src/newdecoder.cpp:196-406 of the reference, run backwards).

Everything is numpy; fixtures are small.  The convolutional shift register
and NRZ-M phase carry across frames like the real continuous downlink.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.ops import conv_code
from xritdemod_tpu_torch.ops.derandomizer import _pn_np
from xritdemod_tpu_torch.ops.reed_solomon import rs_encode_np

__all__ = ["make_vcdus", "TxChain", "encode_stream", "soft_to_int8", "modulate"]


def make_vcdus(
    n: int,
    scid: int = 13,
    vcid: int = 63,
    counter0: int = 0,
    version: int = 1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Build `(n, 892)` VCDU payloads with the header fields the reference
    parses (newdecoder.cpp:342-349): SCID/VCID in bytes 0-1, 24-bit
    big-endian counter in bytes 2-4."""
    rng = rng or np.random.default_rng(0)
    v = rng.integers(0, 256, (n, C.VCDU_SIZE)).astype(np.uint8)
    ctr = (counter0 + np.arange(n)) & 0xFFFFFF
    v[:, 0] = ((version & 0x3) << 6) | ((scid >> 2) & 0x3F)
    v[:, 1] = ((scid & 0x3) << 6) | (vcid & 0x3F)
    v[:, 2] = (ctr >> 16) & 0xFF
    v[:, 3] = (ctr >> 8) & 0xFF
    v[:, 4] = ctr & 0xFF
    return v


def _frame_from_vcdu(vcdu: np.ndarray) -> np.ndarray:
    """892 payload bytes -> 1024-byte CADU (sync + randomized data+parity)."""
    blocks = vcdu.reshape(C.RS_K, C.RS_BLOCKS).T        # (4, 223), block i = i::4
    cw = rs_encode_np(blocks)                            # (4, 255)
    interleaved = cw.T.reshape(C.RS_BLOCKS * C.RS_N)     # byte j*4+i = cw[i, j]
    rand = interleaved ^ _pn_np(C.RS_BLOCKS * C.RS_N)
    sync = np.array(
        [(C.SYNC_MARKER >> s) & 0xFF for s in (24, 16, 8, 0)], np.uint8
    )
    return np.concatenate([sync, rand])


@dataclasses.dataclass
class TxChain:
    """Stateful continuous-downlink encoder (conv sr / NRZ-M phase carry)."""

    lrit: bool = True
    sr: int = 0
    nrzm_prev: int = 0

    def encode_frames(self, vcdus: np.ndarray) -> np.ndarray:
        """`(n, 892)` payloads -> `(n*16384,)` float soft symbols in +-1."""
        out = []
        for vcdu in vcdus:
            cadu = _frame_from_vcdu(np.asarray(vcdu, np.uint8))
            bits = np.unpackbits(cadu)
            if not self.lrit:
                bits, self.nrzm_prev = conv_code.nrzm_encode_bits(
                    bits, self.nrzm_prev
                )
            coded, self.sr = conv_code.conv_encode_bits(bits, self.sr)
            out.append(1.0 - 2.0 * coded.astype(np.float32))
        return np.concatenate(out)


def encode_stream(
    vcdus: np.ndarray,
    lrit: bool = True,
    amp: float = 1.0,
    noise: float = 0.0,
    phase180: bool = False,
    lead: int = 0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """VCDUs -> impaired float soft-symbol stream.

    `lead` prepends noise symbols (tests mid-stream sync acquisition);
    `phase180` flips polarity (tests the BPSK ambiguity fix).
    """
    rng = rng or np.random.default_rng(0)
    soft = TxChain(lrit=lrit).encode_frames(vcdus) * amp
    if phase180:
        soft = -soft
    if lead:
        soft = np.concatenate(
            [rng.normal(0, max(noise, 0.3 * amp), lead).astype(np.float32), soft]
        )
    if noise:
        soft = soft + rng.normal(0, noise, soft.shape).astype(np.float32)
    return soft.astype(np.float32)


def soft_to_int8(soft: np.ndarray) -> np.ndarray:
    """Wire quantization (SymbolManager.cpp:43-46): x*127 clamped int8."""
    return np.clip(soft * C.SYMBOL_SCALE, -128, 127).astype(np.int8)


def modulate(
    symbols: np.ndarray,
    cfg,
    rng: np.random.Generator | None = None,
    freq_offset: float = 1e-4,
    phase: float = 0.4,
    amp: float = 0.3,
    noise: float = 0.01,
    clock_ppm: float = 0.0,
    freq_drift: float = 0.0,
) -> np.ndarray:
    """BPSK-modulate soft symbols at `cfg.sps` with RRC pulse shaping plus
    carrier offset/phase/noise impairments -> complex64 IQ capture (the
    deterministic stand-in for the reference's recorded GQRX captures,
    CFileFrontend.cpp:33-62).

    Long-capture impairments for soak runs:
      clock_ppm: sinusoidal symbol-clock drift amplitude in ppm (the M&M
        loop's omega must track it; period ~1/4 of the capture).
      freq_drift: sinusoidal carrier drift amplitude as a fraction of the
        sample rate, on top of `freq_offset` (Costas must track it).
    """
    from scipy.signal import fftconvolve

    from xritdemod_tpu_torch.ops import filters

    rng = rng or np.random.default_rng(0)
    sps = cfg.sps
    os_factor = 4
    ntaps = 127
    nsym = len(symbols)
    if clock_ppm:
        # Per-symbol period modulated at ~4 cycles over the capture.
        t = np.arange(nsym) / nsym
        per = sps * (1.0 + clock_ppm * 1e-6 * np.sin(2 * np.pi * 4 * t))
        centers = np.concatenate([[0.0], np.cumsum(per[:-1])])
        pos = (centers * os_factor).astype(np.int64)
    else:
        pos = (np.arange(nsym) * sps * os_factor).astype(np.int64)
    fine_len = int(pos[-1]) + ntaps * os_factor + 1
    impulses = np.zeros(fine_len, np.float32)
    impulses[pos] = symbols
    fine_rate = cfg.circuit_sample_rate * os_factor
    rc = filters.rrc_taps(
        1.0, fine_rate, cfg.symbol_rate, cfg.rrc_alpha, ntaps * os_factor
    )
    # float32 shaping: the f32 rounding floor (~1e-7) sits ~5 orders below
    # the smallest soak noise level; f64 doubled the synth memory traffic
    # and dominated long-soak wall time.
    shaped = fftconvolve(
        impulses, rc.astype(np.float32) * np.float32(os_factor),
        mode="same",
    )
    sig = shaped[::os_factor]
    # Phase accumulates in f64 (f*n reaches thousands of cycles), then
    # reduces mod 2pi before single-precision trig.
    n = np.arange(len(sig), dtype=np.float64)
    f = freq_offset
    ph = 2 * np.pi * f * n + phase
    if freq_drift:
        # integral of freq_offset + freq_drift*sin(2pi*2*n/N)
        N = len(sig)
        ph = ph + freq_drift * N / 2.0 * (
            1.0 - np.cos(2 * np.pi * 2 * n / N)
        )
    ph = np.remainder(ph, 2 * np.pi).astype(np.float32)
    a32 = np.float32(amp)
    re = sig * np.cos(ph) * a32
    im = sig * np.sin(ph) * a32
    if noise:
        n32 = np.float32(noise)
        re = re + rng.standard_normal(len(sig), dtype=np.float32) * n32
        im = im + rng.standard_normal(len(sig), dtype=np.float32) * n32
    out = np.empty(len(sig), np.complex64)
    out.real = re
    out.imag = im
    return out
