"""CCSDS additive pseudo-noise (de)randomizer.

Counterpart of `xritdemod_tpu/ops/derandomizer.py`.  The PN sequence (CCSDS
131.0-B, polynomial x^8 + x^7 + x^5 + x^3 + 1, all-ones seed, restarted each
frame) is a fixed byte vector, so derandomization is one XOR.  LFSR
convention locked against the canonical prefix FF 48 0E C0 9A 0D 70 BC.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["pn_sequence", "derandomize", "randomize"]

_TAPS = (7, 4, 2, 0)


@functools.lru_cache(maxsize=None)
def _pn_np(nbytes: int) -> np.ndarray:
    state = 0xFF
    out = np.empty(nbytes, np.uint8)
    for i in range(nbytes):
        v = 0
        for _ in range(8):
            v = (v << 1) | ((state >> 7) & 1)
            fb = 0
            for t in _TAPS:
                fb ^= (state >> t) & 1
            state = ((state << 1) | fb) & 0xFF
        out[i] = v
    return out


def pn_sequence(nbytes: int, device="cpu") -> torch.Tensor:
    """First `nbytes` of the CCSDS PN sequence as uint8."""
    return torch.from_numpy(_pn_np(nbytes).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _pn_on(nbytes: int, device: torch.device) -> torch.Tensor:
    """The sequence on `device`, copied there once: a copy from the host at
    every call would make the caller wait for it."""
    return pn_sequence(nbytes, device)


def derandomize(data: torch.Tensor) -> torch.Tensor:
    """XOR `(..., N)` uint8 frames with the PN sequence (restart per frame)."""
    return data ^ _pn_on(data.shape[-1], data.device)



randomize = derandomize  # XOR involution
