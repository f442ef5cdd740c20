"""Fused demodulator front end: AGC -> RRC FIR -> Costas on `(T, C)` planes.

Replaces `xritdemod_tpu/ops/frontend_pallas.py::demod_frontend_pallas`
(`_frontend_kernel`), exact per-sample forms (its `block_k=0`, float32).
The kernel is `csrc/frontend.cu`: one launch, one block per 32 channels,
whose warps are the stages of a pipeline over shared-memory tiles (loader,
magnitudes, AGC gain chain, six FIR warps, Costas chain, store), handed on
through `mbarrier`s.  The RRC product is the kernel's own code, taps in
ascending order; no scratch tensor lies between the stages and the new FIR
history is an output of the kernel.

What bounds it on an H100: by bytes the work is small (the block is read
once and written once).  The time is the length of one channel's Costas
recursion, T dependent steps on one warp; the design takes all other work
off that warp and off its scheduler, so the kernel runs at the pace of that
chain alone.

The plain version below composes the exact recursions of `ops/agc.py` and
`ops/costas.py` with the same tap order; a CPU tensor takes it, a CUDA
tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.agc import AgcParams, agc_gains
from xritdemod_tpu_torch.ops.costas import CostasParams, CostasState, costas_steps
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["demod_frontend", "demod_frontend_plain", "trig_mismatches", "launches"]

launches = 0

# The kernel's warps in order of warp index (`enum Role` of csrc/frontend.cu);
# None for a warp that leaves at once.  Names the rows of a stage-clock read.
ROLES = ("fir0", "fir1", "fir2", "costas", "fir3", "fir4", "fir5", None,
         "loader", "mag", "agc", None, "store")


def _fir_cl(ext: torch.Tensor, taps: torch.Tensor, T: int) -> torch.Tensor:
    """`y[t] = sum_k taps[k] * ext[t + k]`, taps accumulated in ascending k."""
    acc = taps[0] * ext[0:T]
    for k in range(1, taps.shape[0]):
        acc = acc + taps[k] * ext[k : k + T]
    return acc


@torch.no_grad()
def demod_frontend_plain(
    x: CF32, gain, rrc_hist: CF32, costas_state: CostasState,
    agc: AgcParams, taps: torch.Tensor, costas: CostasParams,
    stages: dict | None = None,
):
    """Plain PyTorch version of `demod_frontend` (same contract).

    A dict passed as `stages` receives what lies between the three stages:
    `agc` (the AGC's output) and `fir` (the matched filter's output, the
    Costas loop's input), both `(T, C)` CF32 — on the same data these are
    what the standalone AGC and Costas stages (`ops/stream_cuda.py`) give
    and take — and `seconds`, the wall time of each stage.
    """
    T = x.re.shape[0]
    nh = taps.shape[0] - 1
    clock = _StageClock(x.re.device) if stages is not None else None
    gains, new_gain = agc_gains(x.abs(), gain, agc)
    er = torch.cat([rrc_hist.re.t(), x.re * gains])       # (nh+T, C)
    ei = torch.cat([rrc_hist.im.t(), x.im * gains])
    if clock:
        clock.mark("agc")
    fr = _fir_cl(er, taps, T)
    fi = _fir_cl(ei, taps, T)
    if clock:
        clock.mark("fir")
    yr, yi, new_costas = costas_steps(fr, fi, costas_state, costas)
    if clock:
        clock.mark("costas")
        stages.update(agc=CF32(er[nh:], ei[nh:]), fir=CF32(fr, fi), seconds=clock.seconds)
    new_hist = CF32(er[T:].t().contiguous(), ei[T:].t().contiguous())
    return CF32(yr, yi), new_gain, new_hist, new_costas


class _StageClock:
    """Wall time between marks, the device's queue drained at each."""

    def __init__(self, device):
        self.device, self.seconds = device, {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        now = self._now()
        self.seconds[name], self._t = now - self._t, now


def _lib():
    fn = _build.load("frontend").xrit_frontend
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
            + [ctypes.c_float] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _f32(v) -> float:
    return float(np.float32(v))


def trig_mismatches(lo: float, hi: float, n: int, device) -> int:
    """How many of `n` arguments spread evenly over `[lo, hi]` give a sine or
    cosine in the kernels' Costas step (`csrc/loops.cuh::sincos_exact`) that
    differs in any bit from the CUDA library's `sinf` / `cosf`.  Runs on the
    card and synchronises: a check, not part of the receive path."""
    fn = _build.load("frontend").xrit_trig_mismatches
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    device = torch.device(device)
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with _build.launch_on(bad) as stream:
        err = fn(_f32(lo), _f32(hi), int(n), bad.data_ptr(),
                 stream)
    _build.check(err, "xrit_trig_mismatches")
    return int(bad.item())


@torch.no_grad()
def demod_frontend(
    x: CF32, gain, rrc_hist: CF32, costas_state: CostasState,
    agc: AgcParams, taps: torch.Tensor, costas: CostasParams,
):
    """AGC -> RRC -> Costas over a channels-last `(T, C)` block.

    Args:
      x: `(T, C)` CF32 block (channels-last), float32.
      gain: `(C,)` AGC gain state.
      rrc_hist: `(C, N-1)` CF32 FIR history (the last N-1 AGC outputs).
      costas_state: `(C,)` phase/freq.
      taps: `(N,)` float32 RRC taps on the block's device.

    Returns `(y, gain', rrc_hist', costas_state')` with `y` `(T, C)` CF32.
    """
    global launches
    if not x.re.is_cuda:
        return demod_frontend_plain(x, gain, rrc_hist, costas_state, agc, taps, costas)
    T, C = x.re.shape
    N = int(taps.shape[0])
    nh = N - 1
    dev = x.re.device
    tensors = dict(
        re=x.re, im=x.im, gain=gain, hist_re=rrc_hist.re, hist_im=rrc_hist.im,
        phase=costas_state.phase, freq=costas_state.freq, taps=taps,
    )
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
    if x.im.shape != (T, C) or gain.shape != (C,) or rrc_hist.re.shape != (C, nh):
        raise ValueError("front end: inconsistent shapes")
    # Every tensor handed to the kernel stays referenced until the launch.
    xr, xi = x.re.contiguous(), x.im.contiguous()
    hr, hi = rrc_hist.re.contiguous(), rrc_hist.im.contiguous()
    taps_c, gain_c = taps.contiguous(), gain.contiguous()
    phase_c, freq_c = costas_state.phase.contiguous(), costas_state.freq.contiguous()
    hr_out = torch.empty((C, nh), dtype=torch.float32, device=dev)
    hi_out = torch.empty_like(hr_out)
    yr = torch.empty((T, C), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    gain_out = torch.empty_like(gain)
    phase_out = torch.empty_like(gain)
    freq_out = torch.empty_like(gain)
    with _build.launch_on(xr) as stream:
        err = _lib()(
            xr.data_ptr(), xi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            hr_out.data_ptr(), hi_out.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            taps_c.data_ptr(), gain_c.data_ptr(), gain_out.data_ptr(),
            phase_c.data_ptr(), freq_c.data_ptr(),
            phase_out.data_ptr(), freq_out.data_ptr(),
            T, C, N,
            _f32(agc.rate), _f32(agc.reference), _f32(agc.max_gain),
            _f32(costas.alpha), _f32(costas.beta),
            _f32(costas.freq_min), _f32(costas.freq_max),
            stream,
        )
    _build.check(err, "xrit_frontend")
    launches += 1
    return CF32(yr, yi), gain_out, CF32(hr_out, hi_out), CostasState(phase_out, freq_out)
