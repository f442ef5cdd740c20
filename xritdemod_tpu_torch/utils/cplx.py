"""Complex-as-real-pair representation.

Complex streams travel as a pair of float32 tensors of identical shape, as in
the JAX package (`xritdemod_tpu/utils/cplx.py`), so every op keeps the
reference's arithmetic order and the CUDA kernels read two dense planes.
Host edges (file IO, sockets) convert with `from_complex` / `to_complex`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CF32",
    "from_complex",
    "to_complex",
    "zeros",
    "full_like_shape",
    "map_tree",
    "dequantize_iq_s8",
    "quantize_iq_s8",
]


class CF32(NamedTuple):
    """A complex array as (real, imag) float32 parts of identical shape."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx) -> "CF32":  # type: ignore[override]
        return CF32(self.re[idx], self.im[idx])

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "CF32") -> "CF32":
        return CF32(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "CF32") -> "CF32":
        return CF32(self.re - o.re, self.im - o.im)

    def __mul__(self, o):
        if isinstance(o, CF32):
            return CF32(
                self.re * o.re - self.im * o.im,
                self.re * o.im + self.im * o.re,
            )
        return CF32(self.re * o, self.im * o)

    def conj(self) -> "CF32":
        return CF32(self.re, -self.im)

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.re * self.re + self.im * self.im)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im


def zeros(shape, dtype=torch.float32, device="cpu") -> CF32:
    return CF32(torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


def full_like_shape(x: CF32, shape) -> CF32:
    """Zeros of `shape` with `x`'s dtype and device."""
    return zeros(shape, x.re.dtype, x.re.device)


def map_tree(fn, tree):
    """`fn` applied to every tensor of a nested NamedTuple of tensors (a
    state, a CF32)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(map_tree(fn, t) for t in tree))


def from_complex(x, device="cpu") -> CF32:
    """numpy complex array -> CF32 on `device`."""
    xn = np.asarray(x)
    return CF32(
        torch.from_numpy(np.ascontiguousarray(xn.real, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(xn.imag, np.float32)).to(device),
    )


def to_complex(x: CF32) -> np.ndarray:
    """CF32 -> numpy complex64."""
    return x.re.cpu().numpy().astype(np.complex64) + 1j * x.im.cpu().numpy().astype(
        np.complex64
    )


# -- int8 IQ wire format ------------------------------------------------------
# The quantized stream crosses the host->device boundary (a quarter of the
# float32 pair's bytes) and is dequantized on the device.

IQ_S8_SCALE = 127.0


def dequantize_iq_s8(q: torch.Tensor) -> CF32:
    """`(..., 2T)` interleaved int8 I/Q -> `(..., T)` CF32.

    Inverse of `quantize_iq_s8` up to the 8-bit LSB.
    """
    f = q.to(torch.float32) * np.float32(1.0 / IQ_S8_SCALE)
    return CF32(f[..., 0::2].contiguous(), f[..., 1::2].contiguous())


def quantize_iq_s8(x: np.ndarray) -> np.ndarray:
    """Host-side: complex array -> `(..., 2T)` interleaved int8 I/Q."""
    xn = np.asarray(x)
    out = np.empty(xn.shape[:-1] + (2 * xn.shape[-1],), np.int8)
    out[..., 0::2] = np.clip(
        np.rint(xn.real * IQ_S8_SCALE), -127, 127
    ).astype(np.int8)
    out[..., 1::2] = np.clip(
        np.rint(xn.imag * IQ_S8_SCALE), -127, 127
    ).astype(np.int8)
    return out
