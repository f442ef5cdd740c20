"""CUDA M&M clock recovery: wrapper for `csrc/clock.cu`.

Replaces `xritdemod_tpu/ops/clock_pallas.py` (`_clock_pallas_core` /
`_mm_kernel`, entries `clock_recovery_block_pallas_batch[_cl]`), exact
per-symbol forms with either interpolator (`interp` "mmse" or "sinc", one
kernel instance each, `launches` and `launches_sinc` count them): the
recursion of `ops/clock_recovery.py` over
`[tail | block]` in channels-last layout, each channel indexing its own
sample position.  With `chunk` K > 0 the kernel's block-update instances
run instead (the Pallas kernel's `block_update=True`; plain version
`clock_recovery_block_update_batch`; `launches_bu`, `launches_bu_sinc`):
the clock frozen over each chunk of K slots, whose K interpolations are
independent of each other, `segments` the reference's time segments.

What bounds it on an H100: the bytes are one read of the block and one
write of the symbols, but each channel is a chain of ~T/sps dependent
symbols whose next samples lie where the loop filter says, with only C
threads in flight.  The exact mmse instance serves 32 channels a block with
three warps: a loader keeps a 256-row ring of the group's samples in shared
memory ahead of the walk (`cp.async`, `mbarrier`s), the chain warp (one lane a
channel) reads its eight samples and its tap row from shared memory, and a
third warp writes the symbols out as coalesced rows.  The sinc instances,
whose taps (a sine, a sine and cosine, sixteen divisions) lie on the chain,
serve 16 channels a block with four chain warps, eight lanes a channel and
one tap a lane, and the same loader and store warps (`ROLES`).  The mmse
block update (`clock_bu_kernel`) serves 16 channels a block with four chain
warps, eight lanes a channel, each lane interpolating its own slots of a
chunk, so only the loop filter's running sums stay on the chain; its ring
of 1024 rows holds a chunk's windows at every K up to 64 at the LRIT and
HRIT rates (a larger K reads the rest from device memory), and it reads a
`(C, T)` block as it is (the `(C, T)` entry hands it over with no
transposed copy).  A lane whose position lies outside the ring (the clocks
of one group may drift apart) reads that symbol's samples from device
memory inside the kernel; `out_of_ring_symbols` counts those.

The plain version is `ops/clock_recovery.clock_recovery_block_batch`; a CPU
tensor takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.ops.clock_recovery import (
    NTAIL,
    ClockRecoveryParams,
    ClockRecoveryState,
    check_interp,
    clock_recovery_block_batch,
    clock_recovery_block_update_batch,
    mmse_table,
    segment_rows,
    sinc_table,
)
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = [
    "clock_recovery_block_kernel_batch",
    "clock_recovery_block_kernel_batch_cl",
    "clock_recovery_block_plain_cl",
    "out_of_ring_symbols",
    "launches",
    "launches_sinc",
    "launches_bu",
    "launches_bu_sinc",
    "sinc_tap_mismatches",
    "SINC_MU_MIN",
]

launches = 0          # the mmse instance
launches_sinc = 0     # the sinc instance
launches_bu = 0       # the block update, mmse
launches_bu_sinc = 0  # the block update, sinc

# Each instance's warps in order of warp index: the exact mmse instance's
# `enum Role` of csrc/clock.cu; the mmse block update's BU_CHAINS chain warps
# (one a scheduler), then its loader (clock_bu_kernel); the sinc instances'
# SINC_CHAINS chain warps, then the loader and the store warp
# (clock_sinc_kernel).
_SINC_ROLES = ("chain",) * 4 + ("loader", "store")
ROLES = {"clock": ("chain", "loader", "store"), "clock_bu": ("chain",) * 4 + ("loader",),
         "clock_sinc": _SINC_ROLES, "clock_bu_sinc": _SINC_ROLES}

# Per device: a one-element int32 tensor to which every launch adds the
# symbols whose samples it read from device memory because they lay outside
# the kernel's shared-memory ring.
_slow: dict = {}


def out_of_ring_symbols(device, reset: bool = False) -> int:
    """Symbols the kernel has read from device memory instead of its ring on
    `device` since the last reset (synchronises: for checks, not for the
    receive path)."""
    t = _slow.get(torch.device(device))
    if t is None:
        return 0
    n = int(t.item())
    if reset:
        t.zero_()
    return n


# The entries by (interpolator, block update, channels first): only the mmse
# block update reads a `(C, T)` block.
_ENTRIES = {("mmse", False, False): "xrit_clock", ("sinc", False, False): "xrit_clock_sinc",
            ("mmse", True, False): "xrit_clock_bu", ("sinc", True, False): "xrit_clock_sinc_bu",
            ("mmse", True, True): "xrit_clock_bu_ct"}


def _lib(entry: str):
    fn = getattr(_build.load("clock"), entry)
    if not fn.argtypes:
        bu = "_bu" in entry
        fn.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_float] * 4 + [ctypes.c_int] * (2 if bu else 0) + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _plain(x: CF32, state, params, num_slots: int, interp: str, chunk: int, segments: int):
    if chunk:
        return clock_recovery_block_update_batch(x, state, params, num_slots, chunk, interp,
                                                 segments)
    return clock_recovery_block_batch(x, state, params, num_slots, interp)


@torch.no_grad()
def clock_recovery_block_plain_cl(x: CF32, state, params, num_slots: int,
                                  interp: str = "mmse", chunk: int = 0, segments: int = 1):
    """Plain version at the kernel's channels-last contract."""
    xc = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    return _plain(xc, state, params, num_slots, interp, chunk, segments)


@torch.no_grad()
def clock_recovery_block_kernel_batch_cl(
    x: CF32,
    state: ClockRecoveryState,
    params: ClockRecoveryParams,
    num_slots: int,
    interp: str = "mmse",
    chunk: int = 0,
    segments: int = 1,
):
    """Channels-last entry: `(T, C)` CF32 block (as the front end leaves it),
    `(C,)`-leading state.  Returns `(symbols (C, S) CF32, valid (C, S) bool,
    new_state)` — the contract of `clock_recovery_block_batch`, or with
    `chunk` K > 0 of `clock_recovery_block_update_batch`.  The mmse block
    update's ring of 1024 rows holds a chunk's windows for every K up to 64
    at the LRIT and HRIT rates; a K whose windows span more reads the rest
    from device memory, with the same values, slower, counted by
    `out_of_ring_symbols`."""
    check_interp(interp)
    K = _chunk(chunk)
    if not x.re.is_cuda:
        return clock_recovery_block_plain_cl(x, state, params, num_slots, interp, K, segments)
    return _launch(x, False, state, params, num_slots, interp, K, segments)


@torch.no_grad()
def clock_recovery_block_kernel_batch(
    x: CF32,
    state: ClockRecoveryState,
    params: ClockRecoveryParams,
    num_slots: int,
    interp: str = "mmse",
    chunk: int = 0,
    segments: int = 1,
):
    """`(C, T)` entry: drop-in for `clock_recovery_block_batch` (with
    `chunk` K > 0: for `clock_recovery_block_update_batch`).  The mmse block
    update reads the block as it is (its ring as in
    `clock_recovery_block_kernel_batch_cl`); the other instances take it
    transposed."""
    check_interp(interp)
    K = _chunk(chunk)
    if not x.re.is_cuda:
        return _plain(x, state, params, num_slots, interp, K, segments)
    if interp == "mmse" and K:
        return _launch(x, True, state, params, num_slots, interp, K, segments)
    xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    return _launch(xT, False, state, params, num_slots, interp, K, segments)


def _chunk(chunk: int) -> int:
    K = int(chunk)
    if K < 0:
        raise ValueError(f"chunk must be >= 0, got {K}")
    return K


def _launch(x: CF32, channels_first: bool, state: ClockRecoveryState,
            params: ClockRecoveryParams, num_slots: int, interp: str, K: int, segments: int):
    """One launch on a CUDA block, `(C, T)` with its `(C, NTAIL)` tail when
    `channels_first` (the mmse block update only), else `(T, C)` with the
    tail transposed to `(NTAIL, C)`."""
    global launches, launches_sinc, launches_bu, launches_bu_sinc
    if channels_first:
        C, T = x.re.shape
    else:
        T, C = x.re.shape
    _, seg_rows = segment_rows(T, segments)
    S = int(num_slots)
    dev = x.re.device
    if T < NTAIL:
        raise ValueError(f"block of {T} samples is shorter than the {NTAIL}-sample tail")
    f32s = [x.re, x.im, state.mu, state.omega, state.p.re, state.p.im,
            state.c.re, state.c.im, state.tail.re, state.tail.im]
    if any(t.dtype != torch.float32 or t.device != dev for t in f32s):
        raise ValueError("clock recovery: need float32 tensors on one device")
    if state.ii.dtype != torch.int32 or state.mu.shape != (C,) or state.p.re.shape != (C, 3):
        raise ValueError("clock recovery: inconsistent state")

    f32 = lambda v: float(np.float32(v))
    xr, xi = x.re.contiguous(), x.im.contiguous()
    if channels_first:
        tr, ti = state.tail.re.contiguous(), state.tail.im.contiguous()     # (C, NTAIL)
    else:
        tr, ti = state.tail.re.t().contiguous(), state.tail.im.t().contiguous()   # (NTAIL, C)
    new = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=dev)
    sr, si = new(C, S), new(C, S)
    nvalid = new(C, dt=torch.int32)
    mu_o, om_o, ii_o = new(C), new(C), new(C, dt=torch.int32)
    pr_o, pi_o, cr_o, ci_o = new(C, 3), new(C, 3), new(C, 3), new(C, 3)
    ins = [
        tr, ti, xr, xi, mmse_table(dev) if interp == "mmse" else sinc_table(dev),
        state.mu.contiguous(), state.omega.contiguous(), state.ii.contiguous(),
        state.p.re.contiguous(), state.p.im.contiguous(),
        state.c.re.contiguous(), state.c.im.contiguous(),
    ]
    slow = _slow.get(dev)
    if slow is None:
        slow = _slow[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = [sr, si, nvalid, mu_o, om_o, ii_o, pr_o, pi_o, cr_o, ci_o, slow]
    if K:
        mask = new(C, S, dt=torch.uint8)
        outs.append(mask)
    ptrs = (ctypes.c_void_p * len(ins + outs))(*[t.data_ptr() for t in ins + outs])
    omega_lim = params.omega * params.omega_relative_limit
    bu = (K, seg_rows if segments > 1 else 0) if K else ()
    entry = _ENTRIES[interp, bool(K), channels_first]
    with _build.launch_on(xr) as stream:
        err = _lib(entry)(
            ctypes.cast(ptrs, ctypes.c_void_p), T, C, S,
            f32(params.omega), f32(omega_lim),
            f32(params.gain_omega), f32(params.gain_mu),
            *bu, stream,
        )
    _build.check(err, entry)
    if K:
        if interp == "mmse":
            launches_bu += 1
        else:
            launches_bu_sinc += 1
        valid = mask.bool()
    else:
        if interp == "mmse":
            launches += 1
        else:
            launches_sinc += 1
        valid = torch.arange(S, device=dev)[None, :] < nvalid[:, None]
    if channels_first:
        tail = CF32(xr[:, T - NTAIL :].contiguous(), xi[:, T - NTAIL :].contiguous())
    else:
        tail = CF32(xr[T - NTAIL :].t().contiguous(), xi[T - NTAIL :].t().contiguous())
    new_state = ClockRecoveryState(
        mu=mu_o, omega=om_o, ii=ii_o,
        p=CF32(pr_o, pi_o), c=CF32(cr_o, ci_o), tail=tail,
    )
    return CF32(sr, si), valid, new_state


# The least nonzero mu an unchecked step of the sinc instances can meet
# (csrc/clock.cu, fast_taps): every step's nmu is at least 1.
SINC_MU_MIN = 2.0 ** -23


def sinc_tap_mismatches(device, lo: float = SINC_MU_MIN) -> dict:
    """At how many floats mu in [0, 1] the sinc instances' branch-free taps
    (`csrc/clock.cu`: the unchecked steps' `sincos_reduced`, `div_fast_path`)
    differ in any bit from the exact ones (`sinf`, `sincos_exact`, IEEE
    division): `trig` counts mu whose sine of pi mu or sine or cosine of
    pi mu / 4 differ, `taps` mu whose eight normalised taps differ, and
    `taps_unchecked` those among mu = 0 and mu >= `lo` (the mu an unchecked
    step meets); of `mu` values in all.  Runs on the card and synchronises:
    a check, not part of the receive path."""
    fn = _build.load("clock").xrit_sinc_tap_mismatches
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    device = torch.device(device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    with _build.launch_on(counts) as stream:
        err = fn(sinc_table(device).data_ptr(), float(lo), counts.data_ptr(), stream)
    _build.check(err, "xrit_sinc_tap_mismatches")
    trig, taps, unchecked = counts.tolist()
    return dict(mu=int(np.float32(1.0).view(np.uint32)) + 1, trig=trig, taps=taps,
                taps_unchecked=unchecked, unchecked_mu_min=float(lo))
