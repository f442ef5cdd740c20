"""Mueller & Muller symbol-clock recovery (plain per-symbol recursion).

Counterpart of `xritdemod_tpu/ops/clock_recovery.py` (GNU Radio
`clock_recovery_mm_cc` semantics).  Per output symbol:

    p0 = interp(x[ii .. ii+7], mu);  c0 = slicer(p0)   # (re>0, im>0) -> {0,1}
    u  = (p0 - p2)*conj(c1) - (c0 - c2)*conj(p1)       # lag-1 / lag-2 history
    e  = clip(Re(u), +-1)
    omega += gain_omega*e;  omega = omega_mid + clip(omega - omega_mid, +-lim)
    mu += omega + gain_mu*e;  ii += floor(mu);  mu -= floor(mu)

The interpolator is `interp`: "mmse" (the default) is the tabulated 8-tap
MMSE filter (`ops/interp_taps.py`): row `floor(mu*128 + 0.5)` clipped to
[0, 128] of a 129-row table, used as is.  "sinc" evaluates 8 Hamming-windowed
sinc taps at the exact mu, `sinc(u) * (0.54 + 0.46 cos(pi u / 4))` for
`u = k - 3 - mu`, normalised by their sum.  It is written in the
angle-addition form of the reference's Pallas kernel: with k an integer,

    sin(pi u)     = (-1)^k sin(pi mu)
    cos(pi u / 4) = cos(pi (k-3)/4) cos(pi mu/4) + sin(pi (k-3)/4) sin(pi mu/4)

so a symbol takes one `sin(pi mu)` and one sine and cosine of `pi mu / 4`,
the per-tap window coefficients are constants (`sinc_constants`, handed to
the kernel as they are), and the operations run in the order the CUDA kernel
runs them.

Symbols are emitted while `ii < n - 8` into fixed-capacity slots; the valid
mask is a per-channel prefix, invalid slots are zero and leave the state
untouched.  Block boundaries carry a fixed `NTAIL`-sample input tail.

`clock_recovery_block_update_batch` is the block-update form (the Pallas
kernel's `block_update=True`, `clock_recovery.py:511` of the JAX package):
the clock is frozen over a chunk of K symbols, whose K interpolations then
carry no dependency on each other, and the loop filter runs over the chunk's
errors.  Its valid mask is not always a prefix (see there).

The JAX package stages dense windows because per-channel offsets serialise
on its device; here each channel simply indexes its own `ii`.  This plain
form loops over the symbol slots in Python, vectorised over channels, and
serves the CPU and the tests; `ops/clock_cuda.py` is the GPU form.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from xritdemod_tpu_torch.ops.interp_taps import NSTEPS, mmse_taps_table
from xritdemod_tpu_torch.ops.scan import scan
from xritdemod_tpu_torch.utils.cplx import CF32, map_tree

__all__ = [
    "ClockRecoveryParams",
    "ClockRecoveryState",
    "clock_recovery_init",
    "clock_recovery_block",
    "clock_recovery_block_batch",
    "clock_recovery_block_update_batch",
    "segment_rows",
    "mmse_table",
    "max_symbols",
    "NTAIL",
    "INTERP_TAPS",
    "INTERPS",
    "check_interp",
    "sinc_constants",
    "sinc_table",
]

INTERP_TAPS = 8
# Fixed-size carry of raw samples across block boundaries.  Must exceed
# INTERP_TAPS + ceil(max omega); 32 is comfortably safe for sps <= 20.
NTAIL = 32


_tables: dict = {}


def mmse_table(device) -> torch.Tensor:
    """The 129 x 8 MMSE tap table on `device` (kept per device)."""
    tab = _tables.get(device)
    if tab is None:
        tab = torch.from_numpy(mmse_taps_table()).to(device).contiguous()
        _tables[device] = tab
    return tab


def _mmse_rows(mu: torch.Tensor) -> torch.Tensor:
    """Tabulated MMSE tap rows for `mu` of any shape -> `mu.shape + (8,)`.

    imu = floor(mu*128 + 0.5) (not round-half-even), row lookup by index.
    """
    tab = mmse_table(mu.device)                                       # (129, 8)
    imu = torch.clamp(torch.floor(mu * NSTEPS + 0.5).to(torch.int64), 0, NSTEPS)
    return tab[imu]


INTERPS = ("mmse", "sinc")


def check_interp(interp: str) -> None:
    if interp not in INTERPS:
        raise ValueError(f"interp must be 'mmse' or 'sinc', got {interp!r}")


_f32 = np.float32
PI = _f32(math.pi)
QUARTER_PI = _f32(math.pi / 4.0)
WIN_A, WIN_B = _f32(0.54), _f32(0.46)


def sinc_constants() -> np.ndarray:
    """`(2, 8)` float32: per tap k, the window coefficients `cos(pi (k-3)/4)`
    and `sin(pi (k-3)/4)` (float64, rounded)."""
    k = np.arange(INTERP_TAPS, dtype=np.float64)
    return np.stack([np.cos(math.pi / 4.0 * (k - 3.0)),
                     np.sin(math.pi / 4.0 * (k - 3.0))]).astype(np.float32)


def sinc_table(device) -> torch.Tensor:
    """`sinc_constants()` on `device` (kept per device)."""
    key = ("sinc", device)
    tab = _tables.get(key)
    if tab is None:
        tab = _tables[key] = torch.from_numpy(sinc_constants()).to(device)
    return tab


def _sinc_rows(mu: torch.Tensor) -> torch.Tensor:
    """Normalised windowed-sinc taps for `(C,)` mu -> `(C, 8)`, in the
    CUDA kernel's order of operations (see the module docstring)."""
    ca, sa = sinc_table(mu.device).unbind(0)
    k = torch.arange(INTERP_TAPS, device=mu.device)
    s = torch.sin(mu * float(PI))[:, None]
    q = mu * float(QUARTER_PI)
    sq, cq = torch.sin(q)[:, None], torch.cos(q)[:, None]
    u = (k - 3).to(torch.float32) - mu[:, None]                    # (C, 8)
    w = float(WIN_A) + float(WIN_B) * (ca * cq + sa * sq)
    sn = torch.where(k % 2 == 1, -s, s)                            # (-1)^k sin(pi mu)
    one = torch.ones((), dtype=torch.float32, device=mu.device)
    t = torch.where(u == 0.0, one, sn / (u * float(PI))) * w
    tsum = t[:, 0]
    for k in range(1, INTERP_TAPS):
        tsum = tsum + t[:, k]
    return t / tsum[:, None]


class ClockRecoveryParams(NamedTuple):
    omega: float                 # nominal samples/symbol (omega_mid)
    gain_omega: float
    gain_mu: float
    omega_relative_limit: float = 0.005


class ClockRecoveryState(NamedTuple):
    mu: torch.Tensor      # (C,) f32
    omega: torch.Tensor   # (C,) f32
    ii: torch.Tensor      # (C,) i32, index into [tail | block]
    p: CF32               # (C, 3) sample history  [1 back, 2 back, 3 back]
    c: CF32               # (C, 3) slicer history
    tail: CF32            # (C, NTAIL) last samples of previous extended block


def clock_recovery_init(
    params: ClockRecoveryParams, mu: float = 0.5, channels: int = 1, device="cpu"
) -> ClockRecoveryState:
    f = lambda shape, v=0.0: torch.full(shape, v, dtype=torch.float32, device=device)
    Cn = channels
    return ClockRecoveryState(
        mu=f((Cn,), mu),
        omega=f((Cn,), params.omega),
        ii=torch.full((Cn,), NTAIL, dtype=torch.int32, device=device),
        p=CF32(f((Cn, 3)), f((Cn, 3))),
        c=CF32(f((Cn, 3)), f((Cn, 3))),
        tail=CF32(f((Cn, NTAIL)), f((Cn, NTAIL))),
    )


def max_symbols(block_len: int, params: ClockRecoveryParams) -> int:
    """Static output-slot budget for a block of `block_len` input samples."""
    min_omega = params.omega * (1.0 - params.omega_relative_limit)
    return int(math.ceil((block_len + NTAIL) / min_omega)) + 4


@torch.no_grad()
def clock_recovery_block_batch(
    x: CF32,
    state: ClockRecoveryState,
    params: ClockRecoveryParams,
    num_slots: int,
    interp: str = "mmse",
):
    """Recover symbols from one `(C, T)` CF32 block, `(C,)`-leading state,
    with the `interp` interpolator ("mmse" or "sinc").

    Returns `(symbols, valid, new_state)`: `symbols` `(C, num_slots)` CF32,
    `valid` `(C, num_slots)` bool marking real outputs (a prefix per
    channel; the count depends on the data).
    """
    check_interp(interp)
    taps = _mmse_rows if interp == "mmse" else _sinc_rows
    f32 = lambda v: float(np.float32(v))
    omega_mid = f32(params.omega)
    omega_lim = f32(params.omega * params.omega_relative_limit)
    gain_omega = f32(params.gain_omega)
    gain_mu = f32(params.gain_mu)

    xr = torch.cat([state.tail.re, x.re], dim=-1)          # (C, n)
    xi = torch.cat([state.tail.im, x.im], dim=-1)
    Cn, n = xr.shape
    limit = n - INTERP_TAPS
    dev = xr.device
    koff = torch.arange(INTERP_TAPS, device=dev)

    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def step(carry, _):
        (mu, omega, ii, p1r, p2r, p3r, p1i, p2i, p3i,
         c1r, c2r, c3r, c1i, c2i, c3i) = carry
        valid = ii < limit
        idx = torch.clamp(ii, 0, limit - 1)[:, None] + koff       # (C, 8)
        t = taps(mu)                                               # (C, 8)
        wr = torch.gather(xr, 1, idx) * t
        wi = torch.gather(xi, 1, idx) * t
        p0r, p0i = wr[:, 0], wi[:, 0]
        for k in range(1, INTERP_TAPS):
            p0r = p0r + wr[:, k]
            p0i = p0i + wi[:, k]
        c0r = torch.where(p0r > 0, one, zero)
        c0i = torch.where(p0i > 0, one, zero)
        e = (
            (p0r - p2r) * c1r
            + (p0i - p2i) * c1i
            - ((c0r - c2r) * p1r + (c0i - c2i) * p1i)
        )
        e = torch.clamp(e, -1.0, 1.0)
        new_omega = omega + gain_omega * e
        new_omega = omega_mid + torch.clamp(new_omega - omega_mid, -omega_lim, omega_lim)
        new_mu = mu + new_omega + gain_mu * e
        adv = torch.floor(new_mu)
        new_ii = torch.clamp(ii + adv.to(torch.int64), min=0)
        new_mu = new_mu - adv

        out = (torch.where(valid, p0r, zero), torch.where(valid, p0i, zero), valid)
        mu = torch.where(valid, new_mu, mu)
        omega = torch.where(valid, new_omega, omega)
        ii = torch.where(valid, new_ii, ii)
        p1r, p2r, p3r = (torch.where(valid, p0r, p1r), torch.where(valid, p1r, p2r),
                         torch.where(valid, p2r, p3r))
        p1i, p2i, p3i = (torch.where(valid, p0i, p1i), torch.where(valid, p1i, p2i),
                         torch.where(valid, p2i, p3i))
        c1r, c2r, c3r = (torch.where(valid, c0r, c1r), torch.where(valid, c1r, c2r),
                         torch.where(valid, c2r, c3r))
        c1i, c2i, c3i = (torch.where(valid, c0i, c1i), torch.where(valid, c1i, c2i),
                         torch.where(valid, c2i, c3i))
        return (mu, omega, ii, p1r, p2r, p3r, p1i, p2i, p3i,
                c1r, c2r, c3r, c1i, c2i, c3i), out

    sr = torch.zeros((num_slots, Cn), dtype=torch.float32, device=dev)
    si = torch.zeros_like(sr)
    vd = torch.zeros((num_slots, Cn), dtype=torch.bool, device=dev)
    (mu, omega, ii, p1r, p2r, p3r, p1i, p2i, p3i, c1r, c2r, c3r, c1i, c2i, c3i) = scan(
        step,
        (state.mu, state.omega, state.ii.to(torch.int64), *state.p.re.unbind(-1),
         *state.p.im.unbind(-1), *state.c.re.unbind(-1), *state.c.im.unbind(-1)),
        (), (sr, si, vd))
    new_state = ClockRecoveryState(
        mu=mu,
        omega=omega,
        ii=(ii - (n - NTAIL)).to(torch.int32),   # re-based onto the next block
        p=CF32(torch.stack([p1r, p2r, p3r], -1), torch.stack([p1i, p2i, p3i], -1)),
        c=CF32(torch.stack([c1r, c2r, c3r], -1), torch.stack([c1i, c2i, c3i], -1)),
        tail=CF32(xr[:, -NTAIL:].contiguous(), xi[:, -NTAIL:].contiguous()),
    )
    return CF32(sr.t().contiguous(), si.t().contiguous()), vd.t().contiguous(), new_state


@torch.no_grad()
def clock_recovery_block(
    x: CF32,
    state: ClockRecoveryState,
    params: ClockRecoveryParams,
    num_slots: int,
    interp: str = "sinc",
):
    """The unbatched form: one `(T,)` CF32 block with an unbatched state
    (scalar mu, omega and ii; `(3,)` histories; `(NTAIL,)` tail) ->
    `(symbols (num_slots,), valid (num_slots,), new state)`.  The default
    interpolator is "sinc", as in the JAX package's `clock_recovery_block`;
    `clock_recovery_block_batch` over one channel."""
    batched = map_tree(lambda a: a[None], state)
    syms, valid, new = clock_recovery_block_batch(
        CF32(x.re[None], x.im[None]), batched, params, num_slots, interp)
    return syms[0], valid[0], map_tree(lambda a: a[0], new)


@torch.no_grad()
def clock_recovery_block_update_batch(
    x: CF32,
    state: ClockRecoveryState,
    params: ClockRecoveryParams,
    num_slots: int,
    chunk: int = 16,
    interp: str = "mmse",
    segments: int = 1,
):
    """Block-update M&M over one `(C, T)` CF32 block: the clock frozen for
    each chunk of K = `chunk` symbol slots (slots jK .. jK+K-1 from slot 0).

    At a chunk's start (mu, omega, ii) are frozen; symbol j of the chunk
    lies at `mu + j*omega` past ii (floor: its first sample; the rest: the
    interpolator's mu), valid while that first sample is below the limit.
    The valid symbols, in order, take their errors against the carried
    history (the lag-1 / lag-2 convention) and then

        cum_j  = cum_{j-1} + e_j
        om_j   = omega_mid + clip((omega + gain_omega*cum_j) - omega_mid, +-lim)
        pos_j  = (pos_{j-1} + om_j) + gain_mu*e_j,   pos_{-1} = mu

    and after the chunk ii += floor(pos), mu = pos - floor(pos) (ii kept
    >= 0), omega = om of the last valid symbol, the history its last three
    symbols.  That is the algorithm of the JAX package's
    `clock_recovery_block_update_batch` and of its Pallas kernel with
    `block_update=True`, in an order that makes K = 1 the exact recursion
    (`clock_recovery_block_batch`) bit for bit, and that the CUDA kernel
    (`csrc/clock.cu`) runs.  The interpolator is the exact form's at the
    symbol's own mu.

    With `segments` > 1 the block is the reference's chain of equal time
    segments (`slot_budget` past 2^17 samples): a chunk counts symbols only
    below its segment's end, and a chunk that finds none there moves to the
    next segment, where the chunk grid starts again, as the reference's
    segmented launches do; the slots stay one sequence.  The symbols of a
    chunk cut short by a limit leave their slots invalid, so the valid mask
    may have a gap where the next chunk goes on (the reference's layout):
    take `soft[valid]`.  Returns `(symbols, valid, new_state)` as
    `clock_recovery_block_batch`."""
    check_interp(interp)
    K = int(chunk)
    if K < 1:
        raise ValueError(f"chunk must be >= 1, got {K}")
    taps = _mmse_rows if interp == "mmse" else _sinc_rows
    f32 = lambda v: float(np.float32(v))
    omega_mid = f32(params.omega)
    omega_lim = f32(params.omega * params.omega_relative_limit)
    gain_omega = f32(params.gain_omega)
    gain_mu = f32(params.gain_mu)

    xr = torch.cat([state.tail.re, x.re], dim=-1)          # (C, n)
    xi = torch.cat([state.tail.im, x.im], dim=-1)
    Cn, n = xr.shape
    T = n - NTAIL
    limit = n - INTERP_TAPS
    segs, seg_rows = segment_rows(T, segments)
    dev = xr.device
    koff = torch.arange(INTERP_TAPS, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    steps = -(-num_slots // K)

    jf = torch.arange(K, dtype=torch.float32, device=dev)[:, None]       # (K, 1)
    jk = torch.arange(K, device=dev)[:, None]
    rows = torch.arange(Cn, device=dev)[None, :, None]

    def step(carry, xs):
        (mu, omega, ii, lim, p1r, p2r, p3r, p1i, p2i, p3i,
         c1r, c2r, c3r, c1i, c2i, c3i) = carry
        (slot0,) = xs
        for _ in range(segs - 1):
            lim = torch.where((ii >= lim) & (lim < limit),
                              torch.clamp(lim + seg_rows, max=limit), lim)
        # The chunk's K symbols at once: positions, windows and interpolations
        # depend on the frozen clock only; the valid ones are a prefix.
        pj = mu[None] + jf * omega[None]                                   # (K, C)
        ilf = torch.floor(pj)
        base = ii[None] + ilf.to(torch.int64)
        valid = (base < lim[None]) & (slot0 + jk < num_slots)
        idx = torch.clamp(base, 0, limit - 1)[..., None] + koff           # (K, C, 8)
        t = taps((pj - ilf).reshape(-1)).reshape(K, Cn, INTERP_TAPS)
        wr = xr[rows, idx] * t
        wi = xi[rows, idx] * t
        p0r, p0i = wr[..., 0], wi[..., 0]
        for k in range(1, INTERP_TAPS):
            p0r = p0r + wr[..., k]
            p0i = p0i + wi[..., k]
        c0r = torch.where(p0r > 0, one, zero)
        c0i = torch.where(p0i > 0, one, zero)
        # Symbol j's lags one and two are entries j + 2 and j + 1 of the
        # history extended by the chunk's symbols.
        Ar = torch.cat([torch.stack([p3r, p2r, p1r]), p0r])               # (K+3, C)
        Ai = torch.cat([torch.stack([p3i, p2i, p1i]), p0i])
        Br = torch.cat([torch.stack([c3r, c2r, c1r]), c0r])
        Bi = torch.cat([torch.stack([c3i, c2i, c1i]), c0i])
        e = (
            (p0r - Ar[1:K + 1]) * Br[2:K + 2]
            + (p0i - Ai[1:K + 1]) * Bi[2:K + 2]
            - ((c0r - Br[1:K + 1]) * Ar[2:K + 2] + (c0i - Bi[1:K + 1]) * Ai[2:K + 2])
        )
        e = torch.clamp(e, -1.0, 1.0)
        # The loop filter's sums, in slot order (past the valid prefix they
        # are never used).
        cum, cums = torch.zeros_like(mu), []
        for j in range(K):
            cum = cum + e[j]
            cums.append(cum)
        om = omega_mid + torch.clamp((omega[None] + gain_omega * torch.stack(cums))
                                     - omega_mid, -omega_lim, omega_lim)
        gme = gain_mu * e
        pos = mu
        for j in range(K):
            pos = torch.where(valid[j], (pos + om[j]) + gme[j], pos)
        nv = valid.sum(0)                                                  # (C,)
        last = lambda E, d: E.gather(0, (nv + 2 - d)[None]).squeeze(0)
        om_last = torch.where(nv > 0, om.gather(0, (nv - 1).clamp(min=0)[None]).squeeze(0),
                              omega)
        p1r, p2r, p3r = last(Ar, 0), last(Ar, 1), last(Ar, 2)
        p1i, p2i, p3i = last(Ai, 0), last(Ai, 1), last(Ai, 2)
        c1r, c2r, c3r = last(Br, 0), last(Br, 1), last(Br, 2)
        c1i, c2i, c3i = last(Bi, 0), last(Bi, 1), last(Bi, 2)
        adv = torch.floor(pos)
        ii = torch.clamp(ii + adv.to(torch.int64), min=0)
        mu = pos - adv
        return (mu, om_last, ii, lim, p1r, p2r, p3r, p1i, p2i, p3i,
                c1r, c2r, c3r, c1i, c2i, c3i), (
            torch.where(valid, p0r, zero), torch.where(valid, p0i, zero), valid)

    sr = torch.zeros((steps, K, Cn), dtype=torch.float32, device=dev)
    si = torch.zeros_like(sr)
    vd = torch.zeros((steps, K, Cn), dtype=torch.bool, device=dev)
    slot0 = torch.arange(steps, device=dev) * K
    lim0 = torch.full((Cn,), NTAIL + seg_rows - INTERP_TAPS if segs > 1 else limit,
                      dtype=torch.int64, device=dev)
    (mu, omega, ii, _, p1r, p2r, p3r, p1i, p2i, p3i, c1r, c2r, c3r, c1i, c2i, c3i) = scan(
        step,
        (state.mu, state.omega, state.ii.to(torch.int64), lim0, *state.p.re.unbind(-1),
         *state.p.im.unbind(-1), *state.c.re.unbind(-1), *state.c.im.unbind(-1)),
        (slot0,), (sr, si, vd))
    new_state = ClockRecoveryState(
        mu=mu,
        omega=omega,
        ii=(ii - (n - NTAIL)).to(torch.int32),
        p=CF32(torch.stack([p1r, p2r, p3r], -1), torch.stack([p1i, p2i, p3i], -1)),
        c=CF32(torch.stack([c1r, c2r, c3r], -1), torch.stack([c1i, c2i, c3i], -1)),
        tail=CF32(xr[:, -NTAIL:].contiguous(), xi[:, -NTAIL:].contiguous()),
    )
    flat = lambda a: a.reshape(steps * K, Cn)[:num_slots].t().contiguous()
    return CF32(flat(sr), flat(si)), flat(vd), new_state


def segment_rows(T: int, segments: int) -> tuple[int, int]:
    """(segment count, rows a segment) of a T-sample block cut into
    `segments` equal time segments (1 and T when there are none)."""
    segs = int(segments)
    if segs < 1 or T % segs:
        raise ValueError(f"cannot cut a block of {T} samples into {segs} equal segments")
    return segs, T // segs
