"""Stateful block FIR filtering (decimating) for complex streams.

Counterpart of `xritdemod_tpu/ops/fir.py` (conv form): a fixed-size block
plus an explicit `(..., ntaps-1)` history carry makes the op pure
(overlap-save halo = the history).  Taps are real, so the filter is two
real convolutions.  This is the decimating front filter of the chain and the
matched (RRC) filter of the split front end; the matched filter of the fused
receive runs inside the CUDA front end (`ops/frontend_cuda.py`).

On a CUDA device `F.conv1d` goes through cuDNN, whose default lets a float32
convolution run in TF32 (about three decimal digits).  The filter asks for
full float32 itself, whatever `torch.backends.cudnn.allow_tf32` says, so its
results do not depend on a global flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["fir_init", "fir_block", "fir_block_real"]


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


def fir_block(x: CF32, taps, history: CF32, decimation: int = 1):
    """Filter one complex block with carried tap history.

    Args:
      x: `(..., T)` CF32 input block; `T % decimation == 0`.
      taps: `(N,)` float32 taps.
      history: `(..., N-1)` CF32 previous block tail.
      decimation: keep every `decimation`-th output.

    Returns `(y, new_history)` (causal, group delay (N-1)/2 samples).
    """
    yr, hr = fir_block_real(x.re, taps, history.re, decimation)
    yi, hi = fir_block_real(x.im, taps, history.im, decimation)
    return CF32(yr, yi), CF32(hr, hi)
