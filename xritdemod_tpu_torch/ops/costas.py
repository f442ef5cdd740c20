"""Second-order BPSK Costas carrier-recovery loop.

Counterpart of `xritdemod_tpu/ops/costas.py::costas_block` (GNU Radio
`costas_loop_cc(loop_bw, order=2)` semantics):

    gains from loop bandwidth Bn with damping zeta = sqrt(2)/2:
        denom = 1 + 2*zeta*Bn + Bn^2
        alpha = 4*zeta*Bn / denom          (phase gain)
        beta  = 4*Bn^2  / denom            (frequency gain)
    per sample:
        y[n]   = x[n] * exp(-i*phase)
        e      = clip(Re(y)*Im(y), +-1)
        freq  += beta * e;  freq = clip(freq, +-1)
        phase += freq + alpha * e;  one +-2pi wrap step

This plain form loops over time in Python (vectorised over the leading
axes; `ops/scan.py`); on the GPU the recursion runs inside the fused front end
(`ops/frontend_cuda.py`) or, on the split path, as the standalone kernel
`ops/stream_cuda.costas_block_kernel`, whose plain version `costas_block` is.

`costas_block_update` is the slab form of `costas.costas_block_update`: a
slab of K samples is rotated on a frozen ramp and the loop filter advances
once a slab (K1's and K6's slab instances, whose plain version it is).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from xritdemod_tpu_torch.ops.scan import scan
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = [
    "CostasParams",
    "CostasState",
    "costas_init",
    "costas_block",
    "costas_block_update",
    "costas_gains",
    "costas_slab_steps",
    "costas_steps",
    "slab_wraps",
]


class CostasParams(NamedTuple):
    alpha: float   # phase gain
    beta: float    # frequency gain
    freq_min: float = -1.0
    freq_max: float = 1.0


def costas_gains(loop_bw: float) -> CostasParams:
    """GR blocks::control_loop::update_gains with damping sqrt(2)/2."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    return CostasParams(
        alpha=(4.0 * damping * loop_bw) / denom,
        beta=(4.0 * loop_bw * loop_bw) / denom,
    )


class CostasState(NamedTuple):
    phase: torch.Tensor   # (...,) float32
    freq: torch.Tensor    # (...,) float32


def costas_init(leading_shape: tuple = (), device="cpu") -> CostasState:
    return CostasState(
        phase=torch.zeros(tuple(leading_shape), dtype=torch.float32, device=device),
        freq=torch.zeros(tuple(leading_shape), dtype=torch.float32, device=device),
    )


_TWO_PI = float(np.float32(2.0 * math.pi))


def costas_steps(xr_t, xi_t, state: CostasState, params: CostasParams):
    """Run the loop over time-major `(T, ...)` planes; returns the rotated
    planes and the new state."""
    alpha = float(np.float32(params.alpha))
    beta = float(np.float32(params.beta))
    zero = torch.zeros((), dtype=torch.float32, device=xr_t.device)

    def step(carry, x):
        (phase, freq), (xr, xi) = carry, x
        c = torch.cos(phase)
        s = torch.sin(phase)
        yr = xr * c + xi * s          # y = x * exp(-i*phase)
        yi = xi * c - xr * s
        err = torch.clamp(yr * yi, -1.0, 1.0)
        freq = torch.clamp(freq + beta * err, params.freq_min, params.freq_max)
        phase = phase + freq + alpha * err
        phase = phase - torch.where(phase > _TWO_PI, _TWO_PI, zero)
        phase = phase + torch.where(phase < -_TWO_PI, _TWO_PI, zero)
        return (phase, freq), (yr, yi)

    yr_t = torch.empty_like(xr_t)
    yi_t = torch.empty_like(xi_t)
    phase, freq = scan(step, (state.phase, state.freq), (xr_t, xi_t), (yr_t, yi_t))
    return yr_t, yi_t, CostasState(phase=phase, freq=freq)


@torch.no_grad()
def costas_block(x: CF32, state: CostasState, params: CostasParams):
    """Run the Costas loop over a `(..., T)` CF32 block.

    Returns `(y, new_state)` with y the carrier-corrected samples.
    """
    yr_t, yi_t, new_state = costas_steps(
        x.re.movedim(-1, 0), x.im.movedim(-1, 0), state, params
    )
    return CF32(yr_t.movedim(0, -1), yi_t.movedim(0, -1)), new_state


def slab_wraps(params: CostasParams, chunk: int) -> int:
    """Conditional +-2pi steps after a slab of `chunk` samples: enough for
    the largest phase advance a slab can make (the JAX package's rule)."""
    advance = chunk * max(abs(params.freq_min), abs(params.freq_max)) + float(
        chunk * (params.alpha + params.beta * chunk))
    return int(math.ceil(advance / (2.0 * math.pi))) + 1


def costas_slab_steps(xr_t, xi_t, state: CostasState, params: CostasParams, chunk: int):
    """The slab form over time-major `(T, ...)` planes, T a multiple of
    `chunk`; returns the rotated planes and the new state.

    Slab sample k (k < K = `chunk`) is rotated by `phase + k*freq` with the
    slab's first phase and freq, its error `e_k` taken as in `costas_steps`,
    and the loop filter then advances once:

        s = sum_k e_k,  r = sum_k (K-1-k) e_k       (both summed in k order)
        freq'  = clip(freq + beta*s)
        phase' = ((phase + freq') + ((K-1)*freq + beta*r)) + alpha*s

    then `slab_wraps` conditional +-2pi steps.  This is the JAX package's
    `phase + K*freq + sum_k (alpha + beta*(K-k)) e_k` written so that K = 1
    is `costas_steps` bit for bit (the clipped freq' enters the phase, as in
    the exact step; the two differ only when the freq clip binds), and in
    the order the CUDA kernels compute it (`csrc/loops.cuh`)."""
    T = xr_t.shape[0]
    K = int(chunk)
    if K < 1 or T % K:
        raise ValueError(f"block length {T} not a multiple of chunk {K}")
    alpha = float(np.float32(params.alpha))
    beta = float(np.float32(params.beta))
    nwrap = slab_wraps(params, K)
    dev = xr_t.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lead = (1,) * (xr_t.ndim - 1)
    kf = torch.arange(K, dtype=torch.float32, device=dev).reshape((K,) + lead)
    wf = [float(K - 1 - k) for k in range(K)]

    def step(carry, x):
        (phase, freq), (xr, xi) = carry, x                  # xr: (K, ...)
        ph = phase[None] + kf * freq[None]
        c = torch.cos(ph)
        s = torch.sin(ph)
        yr = xr * c + xi * s
        yi = xi * c - xr * s
        err = torch.clamp(yr * yi, -1.0, 1.0)
        esum = torch.zeros_like(phase)
        rsum = torch.zeros_like(phase)
        for k in range(K):
            esum = esum + err[k]
            rsum = rsum + wf[k] * err[k]
        fnew = torch.clamp(freq + beta * esum, params.freq_min, params.freq_max)
        phase = ((phase + fnew) + ((K - 1) * freq + beta * rsum)) + alpha * esum
        for _ in range(nwrap):
            phase = phase - torch.where(phase > _TWO_PI, _TWO_PI, zero)
            phase = phase + torch.where(phase < -_TWO_PI, _TWO_PI, zero)
        return (phase, fnew), (yr, yi)

    shape = (T // K, K) + tuple(xr_t.shape[1:])
    yr_t = torch.empty(shape, dtype=xr_t.dtype, device=dev)
    yi_t = torch.empty_like(yr_t)
    phase, freq = scan(step, (state.phase, state.freq),
                       (xr_t.reshape(shape), xi_t.reshape(shape)), (yr_t, yi_t))
    return yr_t.reshape(xr_t.shape), yi_t.reshape(xi_t.shape), CostasState(phase, freq)


@torch.no_grad()
def costas_block_update(x: CF32, state: CostasState, params: CostasParams, chunk: int = 8):
    """The slab form (`costas_slab_steps`) over a `(..., T)` CF32 block, T a
    multiple of `chunk`.  Returns `(y, new_state)`."""
    yr_t, yi_t, new_state = costas_slab_steps(
        x.re.movedim(-1, 0), x.im.movedim(-1, 0), state, params, chunk
    )
    return CF32(yr_t.movedim(0, -1), yi_t.movedim(0, -1)), new_state
