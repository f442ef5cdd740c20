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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xritdemod_tpu_torch.ops.scan import scan
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["AgcParams", "agc_init", "agc_block", "agc_gains"]


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
