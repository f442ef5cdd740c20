"""CCSDS rate-1/2 K=7 convolutional code: encoder + trellis tables.

The reference decodes this code with SatHelper `Viterbi27` (over libcorrect),
constructed at decoder/src/newdecoder.cpp:80-83.  The code
convention was locked numerically against the published coded-domain unique
words (newdecoder.cpp:21-24): with shift register `sr = (sr << 1) | bit`
(MSB-first input bits, zero initial state),

    c1 = parity(sr & 0x4F) ^ 1      (first transmitted coded bit)
    c2 = parity(sr & 0x6D) ^ 1      (second coded bit)

`conv_encode(0x1ACFFC1D) == LRIT_UW0` exactly, and equals `HRIT_UW0` with
NRZ-M precoding (previous encoded bit 0).  Coded bit 1 maps to a *negative*
BPSK soft symbol (see constants.py:94-106).

Host-side (numpy) encoding is provided for golden tests and fixtures; the
trellis tables here feed the Viterbi decoder (ops/viterbi.py, ops/viterbi_cuda.py).
"""

from __future__ import annotations

import numpy as np

from xritdemod_tpu_torch import constants as C

__all__ = [
    "conv_encode_bits",
    "nrzm_encode_bits",
    "branch_signs",
    "NUM_STATES",
]

NUM_STATES = 1 << (C.CONV_K - 1)  # 64


def _parity(x: int) -> int:
    p = 0
    while x:
        p ^= x & 1
        x >>= 1
    return p


# Precomputed parity of 7-bit values for vectorized encoding.
_PARITY7 = np.array([_parity(i) for i in range(128)], dtype=np.uint8)


def conv_encode_bits(bits: np.ndarray, sr: int = 0) -> tuple[np.ndarray, int]:
    """Encode MSB-first bits -> coded bits (2 per input), returning final sr.

    `sr` is the 7-bit shift register (low K bits used); pass the returned
    value to chain blocks (the satellite encoder never resets mid-stream).

    Vectorized: the register after bit i is exactly the 7-bit window
    [history | bits][i : i+7] MSB-first, so all states come from one
    sliding-window dot (bit-identical to the per-bit recurrence; pinned
    by tests/test_decode_ops.py).
    """
    bits = np.asarray(bits, np.uint8)
    n = bits.size
    if n == 0:
        return np.empty(0, np.uint8), sr
    hist = np.array([(sr >> k) & 1 for k in range(5, -1, -1)], np.uint8)
    ext = np.concatenate([hist, bits])
    win = np.lib.stride_tricks.sliding_window_view(ext, 7)      # (n, 7)
    weights = np.array([64, 32, 16, 8, 4, 2, 1], np.int32)
    srs = win.astype(np.int32) @ weights                        # (n,)
    out = np.empty(2 * n, np.uint8)
    out[0::2] = _PARITY7[srs & C.CONV_POLY_A] ^ 1
    out[1::2] = _PARITY7[srs & C.CONV_POLY_B] ^ 1
    return out, int(srs[-1])


def nrzm_encode_bits(bits: np.ndarray, prev: int = 0) -> tuple[np.ndarray, int]:
    """NRZ-M precode: enc[i] = enc[i-1] XOR bit[i] (HRIT precoding)."""
    bits = np.asarray(bits, np.uint8)
    if bits.size == 0:
        return np.empty_like(bits), prev
    out = np.bitwise_xor.accumulate(bits) ^ np.uint8(prev)
    return out, int(out[-1])


def branch_signs() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-next-state branch metric signs for the two predecessors.

    For next state n (0..63), input bit is b = n & 1 and the two candidate
    predecessors are s0 = n >> 1 and s1 = (n >> 1) + 32.  Returns float32
    arrays (g1_0, g2_0, g1_1, g2_1), each (64,), holding +1 for expected
    coded bit 0 (positive soft symbol) and -1 for coded bit 1, for the first
    (g1) and second (g2) coded bit of the pair, for predecessor s0 / s1.
    """
    n = np.arange(NUM_STATES)
    b = n & 1
    s0 = n >> 1
    s1 = (n >> 1) + (NUM_STATES >> 1)

    def signs(s):
        sr = ((s << 1) | b) & 0x7F
        c1 = _PARITY7[sr & C.CONV_POLY_A] ^ 1
        c2 = _PARITY7[sr & C.CONV_POLY_B] ^ 1
        return (1.0 - 2.0 * c1).astype(np.float32), (1.0 - 2.0 * c2).astype(
            np.float32
        )

    g1_0, g2_0 = signs(s0)
    g1_1, g2_1 = signs(s1)
    return g1_0, g2_0, g1_1, g2_1
