"""Fused demodulator front end: AGC -> RRC FIR -> Costas on `(T, C)` planes.

Replaces `xritdemod_tpu/ops/frontend_pallas.py::demod_frontend_pallas`
(`_frontend_kernel`), in each of its forms: the exact per-sample recursions
(`block_k=0`, float32), the K-row slab form (`block_k=K`: the AGC as an
affine prefix over K-row slabs, `ops/agc.agc_slab_gains`, and the Costas
loop as the frozen-ramp slab update, `ops/costas.costas_slab_steps`), and
the same with the slab update on one loop only (`block_stages="agc"`: the
slab AGC and the exact Costas loop; `"costas"`: the exact AGC and the slab
Costas loop; `"both"`, the default, slabs both), and the bf16 matched filter
(`precision="bf16"`: each AGC output and tap rounded to bfloat16 before its
product, products and sums in float32).  Two kernel templates in
`csrc/frontend.cu`: `frontend_kernel<48, false, false, BF16>` for the exact
recursions (float32 and bf16) and `frontend_slab_kernel<TR, SLAB_AGC,
SLAB_COSTAS, BF16, SK>` for every slab form; `launches` counts the exact
form, `launches_form[(block_k, block_stages, precision)]` each of the
others (`block_stages` "both" where `block_k` is 0).
One launch, one block per 32 channels (the exact form) or 16 (the slab
forms), whose warps are the stages of a pipeline over shared-memory tiles
(loader, magnitudes, AGC gain chain, six FIR warps, Costas chain, store),
handed on through `mbarrier`s.  The RRC product is the kernel's own code,
taps in ascending order; no scratch tensor lies between the stages and the
new FIR history is an output of the kernel.

What bounds it on an H100: by bytes the work is small (the block is read
once and written once).  The time is the length of one channel's Costas
recursion, T dependent steps on one warp; the design takes all other work
off that warp and off its scheduler, so the kernel runs at the pace of that
chain alone.

With `block_k` K the two chains walk a slab, not a sample, and the FIR's
issue sets the time; so the slab kernel serves 16 channels a block (twice
the SMs for the FIR; each warp's two halves take the two planes), computes
each slab's AGC prefix (log2 K passes, the clamp's running minimum) in the
magnitude warp, off the gain chain, which then takes one clamped affine
step a slab, and at K = 8 spreads a slab's rotations over two lanes a
channel (`csrc/loops.cuh::costas_slab_spread`).  The tile holds whole
slabs: 48 samples where K divides 48, 64 (eight FIR warps) where K divides
64; other K raise on the card.

The plain version below composes the recursions of `ops/agc.py` and
`ops/costas.py` (exact or slab) with the same tap order; a CPU tensor takes
it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.agc import AgcParams, agc_gains, agc_slab_gains
from xritdemod_tpu_torch.ops.costas import (
    CostasParams, CostasState, costas_slab_steps, costas_steps, slab_wraps,
)
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["demod_frontend", "demod_frontend_plain", "trig_mismatches", "launches",
           "launches_form", "PRECISIONS", "BLOCK_STAGES", "roles", "tile_rows",
           "large_trig_mismatches"]

launches = 0          # the exact form
launches_form: dict = {}   # the slab and bf16 forms, by (block_k, block_stages, precision)

# The filter's precisions: "highest" is float32; "bf16" rounds its operands.
PRECISIONS = ("highest", "bf16")
# The loops a slab form runs in slabs, and the kernel's flags for them
# (1 the AGC, 2 the Costas loop).
BLOCK_STAGES = {"both": 3, "agc": 1, "costas": 2}


def _check_stages(block_stages: str) -> None:
    if block_stages not in BLOCK_STAGES:
        raise ValueError(f"block_stages must be one of {tuple(BLOCK_STAGES)}, "
                         f"got {block_stages!r}")


def tile_rows(block_k: int) -> int:
    """Samples a tile of the kernel's instance for `block_k` (0: exact)."""
    if block_k == 0 or 48 % block_k == 0:
        return 48
    if 64 % block_k == 0:
        return 64
    raise ValueError(f"the front-end kernel's slab form needs block_k dividing 48 or 64, "
                     f"got {block_k}")


def roles(block_k: int = 0, block_stages: str = "both") -> tuple:
    """The kernel's warps in order of warp index (`Layout` and
    `SlabLayout` of csrc/frontend.cu), for the instance of `block_k` and
    `block_stages`; None for a warp that leaves at once.  Names the rows of
    a stage-clock read.  Beside an exact Costas chain the Costas warp has
    warp 3, and so scheduler 3, to itself and the AGC warp sits among the
    FIR warps; beside the Costas slab walk the gain chain takes warp 7 and
    the magnitudes three warps (Layout's, its AGC slot, warp 11)."""
    _check_stages(block_stages)
    fir = tile_rows(block_k) // 8
    out, n = [], 0
    names = [f"fir{k}" for k in range(fir)] + ["loader", "mag", "agc", "store"]
    while n < len(names):
        w = len(out)
        if w % 4 == 3:
            out.append("costas" if w == 3 else None)
        else:
            out.append(names[n])
            n += 1
    if block_k and block_stages != "agc":
        out[out.index("agc")] = "mag"
        out[7], out[11] = "agc", "mag"
    return tuple(out)



ROLES = roles(0)


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
    stages: dict | None = None, block_k: int = 0, precision: str = "highest",
    block_stages: str = "both",
):
    """Plain PyTorch version of `demod_frontend` (same contract).

    A dict passed as `stages` receives what lies between the three stages:
    `agc` (the AGC's output) and `fir` (the matched filter's output, the
    Costas loop's input), both `(T, C)` CF32 — on the same data these are
    what the standalone AGC and Costas stages (`ops/stream_cuda.py`) give
    and take — and `seconds`, the wall time of each stage.
    """
    _check_form(block_k, precision, block_stages)
    T = x.re.shape[0]
    nh = taps.shape[0] - 1
    clock = _StageClock(x.re.device) if stages is not None else None
    slab = BLOCK_STAGES[block_stages] if block_k else 0
    if slab & 1:
        gains, new_gain = agc_slab_gains(x.abs(), gain, agc, block_k)
    else:
        gains, new_gain = agc_gains(x.abs(), gain, agc)
    er = torch.cat([rrc_hist.re.t(), x.re * gains])       # (nh+T, C)
    ei = torch.cat([rrc_hist.im.t(), x.im * gains])
    if clock:
        clock.mark("agc")
    if precision == "bf16":
        # Operands rounded to nearest even; their products are exact.
        bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
        fr = _fir_cl(bf(er), bf(taps), T)
        fi = _fir_cl(bf(ei), bf(taps), T)
    else:
        fr = _fir_cl(er, taps, T)
        fi = _fir_cl(ei, taps, T)
    if clock:
        clock.mark("fir")
    if slab & 2:
        yr, yi, new_costas = costas_slab_steps(fr, fi, costas_state, costas, block_k)
    else:
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


def _check_form(block_k: int, precision: str, block_stages: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if block_k < 0:
        raise ValueError(f"block_k must be >= 0, got {block_k}")
    _check_stages(block_stages)


def _lib(form: bool):
    lib = _build.load("frontend")
    fn = lib.xrit_frontend_form if form else lib.xrit_frontend
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
            + [ctypes.c_float] * 7 + [ctypes.c_int] * (4 if form else 0) + [ctypes.c_void_p]
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


# The bits of the library's large-argument threshold (105615.0, SINCOS_SMALL)
# and of +inf: every float with |x| >= 105615, infinities included, lies in
# [LARGE_LO, LARGE_HI] or in the same range with the sign bit set.
LARGE_LO, LARGE_HI = 0x47CE4780, 0x7F800000


def large_trig_mismatches(device) -> int:
    """How many floats with |x| >= 105615 (every one, both signs and the
    infinities: ~1.87e9 arguments) give a sine or cosine in the slab
    kernels' large-argument path (`csrc/loops.cuh::sincos_large_regs`) that
    differs in any bit from the CUDA library's `sinf` / `cosf`.  Runs on the
    card and synchronises: a check, not part of the receive path."""
    fn = _build.load("frontend").xrit_large_trig_mismatches
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=torch.device(device))
    with _build.launch_on(bad) as stream:
        for sign in (0, 0x80000000):
            _build.check(fn(sign | LARGE_LO, (sign | LARGE_HI) + 1, bad.data_ptr(), stream),
                         "xrit_large_trig_mismatches")
    return int(bad.item())


@torch.no_grad()
def demod_frontend(
    x: CF32, gain, rrc_hist: CF32, costas_state: CostasState,
    agc: AgcParams, taps: torch.Tensor, costas: CostasParams,
    block_k: int = 0, precision: str = "highest", block_stages: str = "both",
):
    """AGC -> RRC -> Costas over a channels-last `(T, C)` block.

    Args:
      x: `(T, C)` CF32 block (channels-last), float32.
      gain: `(C,)` AGC gain state.
      rrc_hist: `(C, N-1)` CF32 FIR history (the last N-1 AGC outputs).
      costas_state: `(C,)` phase/freq.
      taps: `(N,)` float32 RRC taps on the block's device.
      block_k: 0 for the exact recursions, K > 0 for the slab forms (T a
        multiple of K).
      precision: "highest" (float32) or "bf16" (the filter's operands
        rounded to bfloat16).
      block_stages: with `block_k` K > 0, the loops that take the slab
        update: "both", "agc" (the Costas loop exact) or "costas" (the AGC
        exact).  Any other string is refused (the JAX kernel runs both
        loops exactly for one it does not know).

    Returns `(y, gain', rrc_hist', costas_state')` with `y` `(T, C)` CF32.
    """
    global launches
    _check_form(block_k, precision, block_stages)
    if not x.re.is_cuda:
        return demod_frontend_plain(x, gain, rrc_hist, costas_state, agc, taps, costas,
                                    block_k=block_k, precision=precision,
                                    block_stages=block_stages)
    T, C = x.re.shape
    form = bool(block_k) or precision == "bf16"
    if block_k:
        tile_rows(block_k)
        if T % block_k:
            raise ValueError(f"front end: block length {T} not a multiple of block_k {block_k}")
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
    extra = (block_k, slab_wraps(costas, block_k) if block_k else 0,
             BLOCK_STAGES[block_stages], int(precision == "bf16")) if form else ()
    with _build.launch_on(xr) as stream:
        err = _lib(form)(
            xr.data_ptr(), xi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            hr_out.data_ptr(), hi_out.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            taps_c.data_ptr(), gain_c.data_ptr(), gain_out.data_ptr(),
            phase_c.data_ptr(), freq_c.data_ptr(),
            phase_out.data_ptr(), freq_out.data_ptr(),
            T, C, N,
            _f32(agc.rate), _f32(agc.reference), _f32(agc.max_gain),
            _f32(costas.alpha), _f32(costas.beta),
            _f32(costas.freq_min), _f32(costas.freq_max),
            *extra, stream,
        )
    _build.check(err, "xrit_frontend_form" if form else "xrit_frontend")
    if form:
        key = (block_k, block_stages if block_k else "both", precision)
        launches_form[key] = launches_form.get(key, 0) + 1
    else:
        launches += 1
    return CF32(yr, yi), gain_out, CF32(hr_out, hi_out), CostasState(phase_out, freq_out)
