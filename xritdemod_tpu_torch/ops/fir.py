"""Stateful block FIR filtering (decimating) for complex streams.

Counterpart of `xritdemod_tpu/ops/fir.py`: a fixed-size block plus an
explicit `(..., ntaps-1)` history carry makes the op pure (overlap-save
halo = the history).  Taps are real, so the filter is two real
convolutions, or (`method="matmul"`, `fir_block_real_matmul`) two products
of overlapping windows with a banded tap matrix.  This is the decimating
front filter of the chain and the matched (RRC) filter of the split front
end; the matched filter of the fused receive runs inside the CUDA front end
(`ops/frontend_cuda.py`).

On a CUDA device `F.conv1d` goes through cuDNN, whose default lets a float32
convolution run in TF32 (about three decimal digits), and `torch.matmul`
through cuBLAS, which does so at float32 matmul precision "high".  The
filter asks for full float32 itself, whatever the global flags say, so its
results do not depend on them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["fir_init", "fir_block", "fir_block_real", "fir_block_real_matmul"]

METHODS = ("conv", "matmul")


def fir_init(ntaps: int, leading_shape: tuple = (), device="cpu") -> CF32:
    """Zero history carry for a FIR with `ntaps` taps."""
    shape = tuple(leading_shape) + (max(ntaps - 1, 0),)
    return CF32(
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _float32_conv():
    """Context in which cuDNN convolutions keep full float32 (no TF32); the
    other cuDNN settings stay as the caller has them."""
    b = torch.backends.cudnn
    return b.flags(
        enabled=b.enabled, benchmark=b.benchmark, benchmark_limit=b.benchmark_limit,
        deterministic=b.deterministic, allow_tf32=False,
    )


@contextlib.contextmanager
def _float32_matmul():
    """Context in which float32 matrix products keep full float32 (no TF32);
    the caller's setting comes back after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def fir_block_real(x, taps, history, decimation: int = 1):
    """Real-valued variant: `(..., T)` float32 in, carried `(..., N-1)` tail.

    `y[..., n] = sum_k taps[k] * xe[..., n*D + k]` for `xe = [history, x]`.
    """
    ntaps = taps.shape[0]
    xe = torch.cat([history, x], dim=-1)
    lead, w = xe.shape[:-1], xe.shape[-1]
    with _float32_conv():
        out = F.conv1d(
            xe.reshape(-1, 1, w), taps.to(torch.float32)[None, None, :],
            stride=decimation,
        )[:, 0, :]
    y = out.reshape(lead + (out.shape[-1],))
    # A copy, not a view: the carried history must not keep the whole
    # `[history | block]` buffer alive between blocks.
    new_history = xe[..., -(ntaps - 1):].clone() if ntaps > 1 else history
    return y, new_history


def fir_block_real_matmul(x, taps, history, block: int = 256):
    """Banded-matrix form of `fir_block_real` (decimation 1): the block cut
    into `T / block` windows of `block` samples plus the N-1 that follow,
    times the `(block + N - 1, block)` matrix `M[j, n] = taps[j - n]`
    (0 <= j - n < N), as one float32 matrix product.

    The same function as the convolution up to the order of each output's
    float32 sums.  `T % block == 0`.
    """
    ntaps = int(taps.shape[0])
    T = x.shape[-1]
    if T % block:
        raise ValueError(f"T={T} not a multiple of block={block}")
    xe = torch.cat([history, x], dim=-1)                  # (..., T+N-1)
    X = xe.unfold(-1, block + ntaps - 1, block)           # (..., T/block, block+N-1)
    d = (torch.arange(block + ntaps - 1, device=x.device)[:, None]
         - torch.arange(block, device=x.device)[None, :])
    M = torch.where((d >= 0) & (d < ntaps), taps.to(torch.float32)[d.clamp(0, ntaps - 1)],
                    torch.zeros((), dtype=torch.float32, device=x.device))
    with _float32_matmul():
        y = torch.matmul(X, M)
    y = y.reshape(xe.shape[:-1] + (T,))
    new_history = xe[..., -(ntaps - 1):].clone() if ntaps > 1 else history
    return y, new_history


def fir_block(x: CF32, taps, history: CF32, decimation: int = 1, method: str = "conv"):
    """Filter one complex block with carried tap history.

    Args:
      x: `(..., T)` CF32 input block; `T % decimation == 0`.
      taps: `(N,)` float32 taps.
      history: `(..., N-1)` CF32 previous block tail.
      decimation: keep every `decimation`-th output.
      method: "conv" (the convolution) or "matmul" (`fir_block_real_matmul`:
        decimation 1 and T a multiple of 256 only).

    Returns `(y, new_history)` (causal, group delay (N-1)/2 samples).
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "matmul":
        if decimation != 1:
            raise ValueError("matmul FIR path requires decimation == 1")
        yr, hr = fir_block_real_matmul(x.re, taps, history.re)
        yi, hi = fir_block_real_matmul(x.im, taps, history.im)
    else:
        yr, hr = fir_block_real(x.re, taps, history.re, decimation)
        yi, hi = fir_block_real(x.im, taps, history.im, decimation)
    return CF32(yr, yi), CF32(hr, hi)
