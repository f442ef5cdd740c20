"""NRZ-M differential decoding over packed bytes (HRIT post-Viterbi step).

Counterpart of `xritdemod_tpu/ops/nrzm.py`.  NRZ-M encodes a 1 as a level
change, so decode is `bit[i] = enc[i] XOR enc[i-1]` — on packed MSB-first
bytes one XOR of the stream with itself shifted right by one bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nrzm_decode_bytes", "nrzm_encode_bytes"]


def nrzm_decode_bytes(data: torch.Tensor, prev_bit: int = 0) -> torch.Tensor:
    """Differential-decode `(..., N)` uint8 packed bits.

    `prev_bit` is the last encoded bit before the block (0 for the frame
    pipeline, where the first bytes are warm-up history anyway).
    """
    data = data.to(torch.uint8)
    prev_lsb = torch.roll(data, 1, dims=-1) & 1
    prev_lsb[..., 0] = prev_bit
    shifted = (data >> 1) | (prev_lsb << 7)
    return data ^ shifted


def nrzm_encode_bytes(data, prev_bit: int = 0) -> np.ndarray:
    """Host-side inverse for fixtures: enc[i] = enc[i-1] XOR bit[i] over
    `(..., N)` uint8 packed bits (numpy in, numpy out)."""
    bits = np.unpackbits(np.asarray(data, np.uint8), axis=-1)
    enc = np.bitwise_xor.accumulate(bits, axis=-1) ^ np.uint8(prev_bit & 1)
    return np.packbits(enc, axis=-1)
