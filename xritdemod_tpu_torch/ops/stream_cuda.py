"""Standalone AGC and Costas loops over `(C, T)` blocks: wrappers for
`csrc/stream.cu`, the two feedback stages of the split front end.

Replaces `xritdemod_tpu/ops/stream_pallas.py` (`agc_block_pallas` /
`_agc_kernel`, `costas_block_pallas` / `_costas_kernel`), the exact
sequential recursions.  Those wrappers transpose to channels-last planes
around the kernel; here the kernel takes and gives `(C, T)` itself.

What bounds them on an H100: by bytes each reads the block once and writes
it once, but each channel is a chain of T dependent steps walked by one
lane.  So each kernel is warp-specialised as the fused front end is
(`csrc/frontend.cu`): per block of channels, a loader warp (`cp.async` of
channel rows into padded shared-memory tiles, several tiles ahead), for the
AGC magnitude warps (`|x|`, no state), a chain warp that walks the
recursion alone on its scheduler (the AGC's gain, or the Costas loop), and a
store warp (for the AGC also `x * gain`), handed on through `mbarrier`s.
`ROLES` names each kernel's warps.  The per-sample arithmetic is
`csrc/loops.cuh`, shared with the fused front end.

`costas_block_kernel(..., chunk=K)` launches the Costas kernel's slab form
(the Pallas fused kernel's `block_k`, here on the split path's `(C, T)`
layout): K rotations on the slab's frozen ramp, one loop update a slab
(`csrc/loops.cuh`, shared with the fused front end); `launches_costas_slab`
counts it.  For K 4, 8 and 16 it is `costas_spread_kernel`:
a slab's rotations spread over `SLAB_LANES` lanes a channel (four chain
warps, one a scheduler), the errors gathered by shuffles and summed in
slab order on every lane; any other K walks a lane a channel
(`stream_kernel<CostasSlabOp>`).

The plain versions are `ops/agc.agc_block`, `ops/costas.costas_block` and
`ops/costas.costas_block_update`; a CPU tensor takes them, a CUDA tensor
takes the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.agc import AgcParams, agc_block
from xritdemod_tpu_torch.ops.costas import (
    CostasParams, CostasState, costas_block, costas_block_update, slab_wraps,
)
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = [
    "ROLES",
    "spread_roles",
    "agc_block_kernel",
    "costas_block_kernel",
    "launches_agc",
    "launches_costas",
    "launches_costas_slab",
]

launches_agc = 0
launches_costas = 0
launches_costas_slab = 0

# Each kernel's warps in order of warp index (`enum Role` of csrc/stream.cu;
# a warp's scheduler is its index mod 4); None for a warp that leaves at
# once.  Names the rows of a stage-clock read.
ROLES = {
    "agc_block": ("loader", "mag", "store", "agc", "mag", "mag"),
    "costas_block": ("loader", None, "store", "costas"),
}
# Lanes a channel of the slab form's spread instances (`SLAB_LPC` of
# csrc/stream.cu; K = 4 takes 4).
SLAB_LANES = 8


def spread_roles(lanes: int) -> tuple:
    """`costas_spread_kernel`'s warps with `lanes` lanes a channel
    (`SpreadLayout`): 16 x lanes / 32 chain warps (at least one) at warps 3,
    1, 4, 6, one a scheduler, beside the loader (warp 0) and the store
    (warp 2)."""
    chains = max(1, 16 * lanes // 32)
    at = (3, 1, 4, 6)[:chains]
    out = [None] * (4 if chains <= 2 else 7)
    out[0], out[2] = "loader", "store"
    for w in at:
        out[w] = "costas"
    return tuple(out)


ROLES["costas_slab"] = spread_roles(SLAB_LANES)      # the K = 8 instance


def _fn(name: str, nptr: int, nfloat: int, nint: int = 0):
    fn = getattr(_build.load("stream"), name)
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * nptr + [ctypes.c_int] * 2
            + [ctypes.c_float] * nfloat + [ctypes.c_int] * nint + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _f32(v) -> float:
    return float(np.float32(v))


def _check(what: str, x: CF32, *state: torch.Tensor) -> tuple[int, int]:
    """`(C, T)` float32 planes and `(C,)` float32 state on one CUDA device."""
    if x.re.ndim != 2 or x.im.shape != x.re.shape or 0 in x.re.shape:
        raise ValueError(f"{what}: need non-empty (C, T) planes, got {tuple(x.re.shape)}")
    C, T = x.re.shape
    dev = x.re.device
    for t in (x.re, x.im, *state):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{what}: need float32 tensors on {dev}")
    if any(s.shape != (C,) for s in state):
        raise ValueError(f"{what}: state must have shape ({C},)")
    return C, T


@torch.no_grad()
def agc_block_kernel(x: CF32, gain: torch.Tensor, params: AgcParams):
    """Exact sequential AGC over a `(C, T)` CF32 block with `(C,)` carried
    gain; drop-in for `agc.agc_block` at that shape.  Returns `(y, gain')`."""
    global launches_agc
    if not x.re.is_cuda:
        return agc_block(x, gain, params)
    C, T = _check("agc_block_kernel", x, gain)
    # Every tensor handed to the kernel stays referenced until the launch.
    xr, xi, g_in = x.re.contiguous(), x.im.contiguous(), gain.contiguous()
    yr, yi, g_out = torch.empty_like(xr), torch.empty_like(xi), torch.empty_like(g_in)
    with _build.launch_on(xr) as stream:
        err = _fn("xrit_agc_block", 6, 3)(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            g_in.data_ptr(), g_out.data_ptr(), C, T,
            _f32(params.rate), _f32(params.reference), _f32(params.max_gain),
            stream,
        )
    _build.check(err, "xrit_agc_block")
    launches_agc += 1
    return CF32(yr, yi), g_out


@torch.no_grad()
def costas_block_kernel(x: CF32, state: CostasState, params: CostasParams, chunk: int = 0):
    """Costas loop over a `(C, T)` CF32 block with `(C,)` carried phase and
    freq: the exact sequential recursion (drop-in for `costas.costas_block`),
    or with `chunk` K > 0 the slab form (drop-in for
    `costas.costas_block_update`, T a multiple of K).  Returns
    `(y, state')`."""
    global launches_costas, launches_costas_slab
    K = int(chunk)
    if not x.re.is_cuda:
        if K:
            return costas_block_update(x, state, params, K)
        return costas_block(x, state, params)
    C, T = _check("costas_block_kernel", x, state.phase, state.freq)
    if K < 0 or (K and T % K):
        raise ValueError(f"costas_block_kernel: block length {T} not a multiple of chunk {K}")
    xr, xi = x.re.contiguous(), x.im.contiguous()
    ph_in, fr_in = state.phase.contiguous(), state.freq.contiguous()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    ph_out, fr_out = torch.empty_like(ph_in), torch.empty_like(fr_in)
    ptrs = (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            ph_in.data_ptr(), fr_in.data_ptr(), ph_out.data_ptr(), fr_out.data_ptr())
    gains = (_f32(params.alpha), _f32(params.beta),
             _f32(params.freq_min), _f32(params.freq_max))
    name = "xrit_costas_slab" if K else "xrit_costas_block"
    with _build.launch_on(xr) as stream:
        if K:
            err = _fn(name, 8, 4, 2)(*ptrs, C, T, *gains, K, slab_wraps(params, K), stream)
        else:
            err = _fn(name, 8, 4)(*ptrs, C, T, *gains, stream)
    _build.check(err, name)
    if K:
        launches_costas_slab += 1
    else:
        launches_costas += 1
    return CF32(yr, yi), CostasState(phase=ph_out, freq=fr_out)
