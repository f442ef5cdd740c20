"""Automatic gain control: the exact per-sample recursion.

Counterpart of `xritdemod_tpu/ops/agc.py::agc_block_exact` (GNU Radio
`agc_cc` semantics):

    out[n]  = x[n] * g[n]
    g[n+1]  = g[n] + rate * (reference - |x[n]| * g[n])
    g clamped to max_gain (if > 0)

The JAX package's default form is an associative scan that only approximates
the clamp; the port keeps the exact recursion everywhere.  This plain form
loops over time in Python (vectorised over the leading axes; `ops/scan.py`)
and serves the
CPU and the tests; on the GPU the recursion runs inside the fused front end
(`ops/frontend_cuda.py`) or, on the split path, as the standalone kernel
`ops/stream_cuda.agc_block_kernel`, whose plain version `agc_block` is.

`agc_slab_gains` is the fused front end's K-row slab form (the Pallas
kernel's `block_k`): the gains of a slab from an affine prefix over its
input magnitudes, the clamp kept exact by a running minimum.  Only the fused
front end has it; the JAX package's full-length associative-scan AGC is not
ported (the split path keeps the exact recursion).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xritdemod_tpu_torch.ops.scan import scan
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["AgcParams", "agc_init", "agc_block", "agc_block_exact", "agc_gains",
           "agc_slab_gains"]


class AgcParams(NamedTuple):
    rate: float = 0.01
    reference: float = 0.5
    gain: float = 1.0
    max_gain: float = 4000.0


def agc_init(params: AgcParams, leading_shape: tuple = (), device="cpu") -> torch.Tensor:
    return torch.full(tuple(leading_shape), params.gain, dtype=torch.float32, device=device)


def agc_gains(mag_t: torch.Tensor, gain: torch.Tensor, params: AgcParams):
    """Gains applied at each sample of a time-major `(T, ...)` magnitude
    block, and the gain carried out."""
    def step(carry, x):
        (g,), (m,) = carry, x
        ng = g + params.rate * (params.reference - m * g)
        if params.max_gain > 0:
            ng = torch.clamp(ng, max=params.max_gain)
        return (ng,), (g,)

    gains = torch.empty_like(mag_t)
    (g,) = scan(step, (gain,), (mag_t,), (gains,))
    return gains, g


@torch.no_grad()
def agc_block(x: CF32, gain: torch.Tensor, params: AgcParams):
    """Apply AGC to a `(..., T)` CF32 block with `(...)` carried gain."""
    gains, new_gain = agc_gains(x.abs().movedim(-1, 0), gain, params)
    g = gains.movedim(0, -1)
    return CF32(x.re * g, x.im * g), new_gain


# The JAX package's name for its sequential form; `agc_block` is that form here.
agc_block_exact = agc_block


def agc_slab_gains(mag_t: torch.Tensor, gain: torch.Tensor, params: AgcParams, chunk: int):
    """The slab form of `agc_gains` over a time-major `(T, ...)` magnitude
    block, T a multiple of K = `chunk`: gains applied at each sample, and
    the gain carried out.

    Given the magnitudes, the update `g' = (1 - rate*|x|)*g + rate*ref` is
    affine in g, so within a slab the gain after row k is `a_k*g + b_k` for
    the slab's first gain g, with (a_k, b_k) from a Hillis-Steele prefix
    (steps s = 1, 2, 4, ... < K: `b_k = a_k*b_{k-s} + b_k`, then
    `a_k = a_k*a_{k-s}`, for k >= s).  The clamp at max_gain M > 0 is exact:
    `min(a*g + b, M)` is monotone in g, so the clamped gain after row k is
    `min(a_k*min(g, cm_k) + b_k, M)` with cm_k the running minimum of
    `(M - b_j)/a_j` over j <= k.  Slabs chain through the clamped gain.  The
    order of operations is the Pallas kernel's (`frontend_pallas.py:87-150`)
    and the CUDA kernel's (`csrc/frontend.cu`)."""
    T = mag_t.shape[0]
    K = int(chunk)
    if K < 1 or T % K:
        raise ValueError(f"block length {T} not a multiple of block_k {K}")
    rate = float(np.float32(params.rate))
    rb = float(np.float32(params.rate) * np.float32(params.reference))
    M = float(np.float32(params.max_gain))
    m = mag_t.reshape((T // K, K) + tuple(mag_t.shape[1:]))
    a = 1.0 - rate * m
    b = torch.full_like(a, rb)
    s = 1
    while s < K:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    clamp = params.max_gain > 0
    if clamp:
        cm = (M - b) / a
        s = 1
        while s < K:
            cm = torch.cat([cm[:, :s], torch.minimum(cm[:, s:], cm[:, :-s])], dim=1)
            s *= 2
    else:
        cm = a

    def step(carry, x):
        (g,), (ak, bk, ck) = carry, x
        if clamp:
            gn = torch.clamp(ak * torch.minimum(g[None], ck) + bk, max=M)
        else:
            gn = ak * g[None] + bk
        return (gn[-1],), (torch.cat([g[None], gn[:-1]]),)

    gains = torch.empty_like(m)
    (g,) = scan(step, (gain,), (a, b, cm), (gains,))
    return gains.reshape(mag_t.shape), g
