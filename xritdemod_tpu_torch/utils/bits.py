"""Bit/byte packing helpers (MSB-first, CCSDS convention)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "bits_of_u64", "np_unpack_bits", "np_pack_bits"]


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """`(..., N)` uint8 -> `(..., 8N)` uint8 bits, MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """`(..., 8N)` {0,1} -> `(..., N)` uint8, MSB first."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def bits_of_u64(word: int, nbits: int = 64) -> np.ndarray:
    """Python int -> MSB-first bit vector (host side)."""
    return np.array([(word >> (nbits - 1 - i)) & 1 for i in range(nbits)], np.uint8)


def np_unpack_bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8), axis=-1)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8), axis=-1)
