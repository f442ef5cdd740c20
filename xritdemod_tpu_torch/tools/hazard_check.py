"""Hazard cases for every kernel of the port whose warps or blocks hand work
to each other, and a tool that runs them once, alone or under the CUDA
toolkit's `compute-sanitizer`.

    python -m xritdemod_tpu_torch.tools.hazard_check [--case PREFIX ...]
        every case once, each result (every output and every carried
        state) held bit for bit against the case's plain version; one JSON
        line a case; exit 1 on a difference or an error.
    python -m xritdemod_tpu_torch.tools.hazard_check --isolate
        the same, each case in a process of its own: a kernel that traps
        (a wait of more than 4 s on an mbarrier, csrc/sync.cuh) ends that
        process's CUDA context, and the other cases still run.
    python -m xritdemod_tpu_torch.tools.hazard_check --sanitize memcheck \\
            racecheck synccheck initcheck [--out DIR]
        `compute-sanitizer --tool T` over this tool with `--launch-only`
        (every case launched once, no plain version: its CUDA graphs and
        per-sample loops would take the sanitizers hours), a process a
        tool, memcheck and initcheck with PyTorch's caching allocator off
        (every tensor its own allocation, so a read past a tensor's end is
        one past an allocation's); each tool's full report in
        DIR/<tool>.log and one JSON line a tool: its exit code, seconds,
        summary line and the report lines that name each kernel.  Without
        `compute-sanitizer` on the machine, or where it refuses the card
        ("Device not supported"), it says so and exits 2.

`cases()` builds the `(name, launch, plain)` triples that
`chip_smoke.py::check_under_load` also runs, LOAD_REPS times each beside a
side stream's load.  Each name is `family/what`; FAMILIES names the
`__global__` kernel (of `csrc/`) each family launches.  Every case is small
(T at most a few thousand samples, C at most two blocks' channels and a
few) and starts from edge states, with the grid's last block of channels
part-filled:

  k1, k1_slab   K1's exact and slab forms (every tile size, loop choice and
                precision) at 3 and 70 channels, from edge states (AGC gains
                at and past the clamp, Costas phases at the wrap bounds and
                past the large-argument threshold) and from random ones on
                unscaled samples (the inputs on which an unordered write
                to the FIR ring first showed);
  k2_*          K2's four kernels: the mmse clock through both entries at
                33 and 70 channels (mu and omega at their edges, channels
                far apart, one at its row limit, and a slot limit that ends
                the chain while the loader waits); the sinc clocks, exact
                and block update, at 21 channels (a last block of two chain
                warps) with one chain warp that has no symbol at all
                (`retire`) or chain warps 1500 rows apart (`apart`); the
                mmse block update at K 1, 16, 64 through both entries;
  k5, k6_*      K5 (with and without the clamp), K6, K6's slab through
                `stream_kernel` (K 2, 64) and through `costas_spread_kernel`
                (K 4, 8, 16) at 21 channels, T = 960 (a part-filled tile);
  k4a, k4b      the ring's append and in-place extract, float32 and bf16, on
                the edges of their realignment and of the shift (fill 0, a
                full ring, an overflow, pos near L - E, channels short of a
                frame beside channels that shift);
  k7_roll       the roll probe's kernel;
  k8_rs         the RS decoder through both entries on tiles of 16
                codewords with all, one and no rows errored (and the edge
                words), more tiles than the persistent grid has blocks, a
                part-filled last tile (4805 codewords; 1201 frames);
  k9_acquire    the acquisition, float32 and bf16, on 27 channels: blocks
                of eight with all, one and no channel unlocked and a
                part-filled last block, on rows that start on 16-byte
                boundaries and on rows that do not; LRIT's words (the
                complement pair's instance) and HRIT's (words that tie).

Imports only the port and numpy; runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import (
    acquire_cuda, clock_cuda, correlator, frontend_cuda, reed_solomon, ring_cuda, stream_cuda,
)
from xritdemod_tpu_torch.ops import agc as agc_op
from xritdemod_tpu_torch.ops import costas as costas_op
from xritdemod_tpu_torch.ops.clock_recovery import NTAIL, ClockRecoveryState
from xritdemod_tpu_torch.tools import edge_cases, roll_probe, timing
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["FAMILIES", "SANITIZER_TOOLS", "cases", "flat", "first_difference", "main"]

# Each case family and the kernel of csrc/ it launches.
FAMILIES = {
    "k1": "frontend_kernel",
    "k1_slab": "frontend_slab_kernel",
    "k2_mmse": "clock_kernel",
    "k2_sinc": "clock_sinc_kernel",
    "k2_bu16_sinc": "clock_sinc_kernel",
    "k2_bu16": "clock_bu_kernel",
    "k5_agc": "stream_kernel",
    "k6_costas": "stream_kernel",
    "k6_slab": "stream_kernel",
    "k6_spread": "costas_spread_kernel",
    "k4a": "ring_append_kernel",
    "k4b": "ring_extract_kernel",
    "k7_roll": "roll_kernel",
    "k8_rs": "rs_decode_kernel",
    "k9_acquire": "acquire_kernel",
}
SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")

SEED = 20261
# K1's forms (block_k, block_stages, precision): both exact instances, and
# the slab kernel's tiles of 48 and 64 rows, each loop choice and precision,
# the spread Costas walk (K = 8) and a lane a channel (K 1, 4, 64).
K1_FORMS = ((0, "both", "highest"), (0, "both", "bf16"),
            (8, "both", "highest"), (8, "both", "bf16"), (8, "agc", "highest"),
            (8, "agc", "bf16"), (8, "costas", "highest"), (8, "costas", "bf16"),
            (1, "costas", "highest"), (4, "both", "highest"), (64, "both", "highest"),
            (64, "costas", "bf16"))
K1_SHAPES = ((3, 960), (70, 960))      # channels fewer than a block; last block 6 of 32 / 16
CLOCK_T = 2000
# mu at 0, just below 1, at 1, inside, outside [0, 1] either way; omega at
# both ends of its range.
CLOCK_EDGE_MU = (0.0, 1.0 - 2.0 ** -24, 1.0, 0.5, -0.25, 1.5, 0.999)
CLOCK_EDGE_OMEGA = (1.0, -1.0, 0.0, 0.5)          # times the relative limit
APART = 1500                                      # rows: past every ring
STREAM_C, STREAM_T = 21, 960
EDGE_PHASE = (2 * np.pi, -2 * np.pi, np.nextafter(np.float32(2 * np.pi), np.float32(9)), 0.0,
              -0.0, 3.0, 2e5, -2e5, 105615.0, 7e4, 12.0, -12.5, 1.0)
EDGE_FREQ = (1.0, -1.0, 1.5, -1.5, 0.0, 0.01, -0.01)     # times freq_max
EDGE_GAIN = (1e-6, 0.5, 2.5, 1e4, 1.0, 4000.0, 3999.0)
RING_L, RING_S = 40001, 3001


def flat(out) -> list:
    """A result as a flat list of its tensors (CF32 and states included)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return []


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def first_difference(got: list, want: list) -> int | None:
    """Index of the first output whose shape, type or bits differ; None
    when every output is bit-equal."""
    if len(got) != len(want):
        return min(len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            return i
    return None


def _cycle(values, n: int, dev) -> torch.Tensor:
    return torch.tensor([float(values[i % len(values)]) for i in range(n)],
                        dtype=torch.float32, device=dev)


def _signal(T: int, C: int, rnd, dev, scale=None) -> CF32:
    """BPSK-like samples with noise, channel c scaled by scale[c]."""
    n = torch.arange(T, device=dev)[:, None]
    carrier = 0.5 * torch.sign(torch.sin(1.4771 * n + torch.arange(C, device=dev)))
    x = CF32(carrier + rnd(T, C, scale=0.05), rnd(T, C, scale=0.05))
    if scale is not None:
        x = CF32(x.re * scale, x.im * scale)
    return x


def _ct(x: CF32) -> CF32:
    return CF32(x.re.t().contiguous(), x.im.t().contiguous())


def _k1_cases(dm: Demodulator, dev, rnd) -> list:
    fe = (dm._agc, dm._rrc_taps, dm._costas)
    nh = int(dm._rrc_taps.shape[0]) - 1
    out = []
    for bk, stages, prec in K1_FORMS:
        family = "k1" if bk == 0 else "k1_slab"
        for C, T in K1_SHAPES:
            hist = CF32(rnd(C, nh), rnd(C, nh))
            # Edges: gains at and past the clamp on small inputs (the clamp
            # binds in a slab's first row and mid-slab), on large ones falling.
            gain = _cycle(EDGE_GAIN, C, dev)
            amp = _cycle((1e-3, 1.2, 0.3, 1e-4, 2.0), C, dev)
            costas = costas_op.CostasState(
                _cycle(EDGE_PHASE, C, dev), _cycle(EDGE_FREQ, C, dev) * dm._costas.freq_max)
            # Random: the initial gain raised by up to a few tenths, the
            # initial Costas state, samples of unit scale.
            init = dm.init_state_batch(C)
            kinds = (("edges", (gain, hist, costas), _signal(T, C, rnd, dev, amp)),
                     ("random", (init.agc_gain + rnd(C).abs(), hist, init.costas),
                      _signal(T, C, rnd, dev)))
            form = dict(block_k=bk, precision=prec, block_stages=stages)
            for what, s, x in kinds:
                out.append((
                    f"{family}/K={bk} {stages} {prec} {what} C={C} T={T}",
                    lambda x=x, s=s, form=form: flat(
                        frontend_cuda.demod_frontend(x, *s, *fe, **form)),
                    lambda x=x, s=s, form=form: flat(
                        frontend_cuda.demod_frontend_plain(x, *s, *fe, **form))))
    return out


def _clock_state(dm: Demodulator, C: int, rnd, dev, ii_off) -> ClockRecoveryState:
    st = dm.init_state_batch(C).clock
    lim = dm._clock.omega_relative_limit
    p = CF32(rnd(C, 3), rnd(C, 3))
    return st._replace(
        mu=_cycle(CLOCK_EDGE_MU, C, dev),
        omega=st.omega * (1.0 + lim * _cycle(CLOCK_EDGE_OMEGA, C, dev)),
        ii=st.ii + torch.tensor(ii_off, dtype=torch.int32, device=dev),
        p=p, c=CF32((p.re > 0).float(), (p.im > 0).float()),
        tail=CF32(rnd(C, NTAIL), rnd(C, NTAIL)))


def _clock_case(name, dm, y, st, S, interp, chunk, channels_first):
    """Kernel (through the `(T, C)` or the `(C, T)` entry) and plain version
    on the same `(T, C)` block."""
    p = dm._clock
    if channels_first:
        yc = _ct(y)
        launch = lambda: flat(clock_cuda.clock_recovery_block_kernel_batch(
            yc, st, p, S, interp, chunk))
    else:
        launch = lambda: flat(clock_cuda.clock_recovery_block_kernel_batch_cl(
            y, st, p, S, interp, chunk))
    plain = lambda: flat(clock_cuda.clock_recovery_block_plain_cl(y, st, p, S, interp, chunk))
    return name, launch, plain


def _clock_cases(dm: Demodulator, dev, rnd) -> list:
    T = CLOCK_T
    limit = T + NTAIL - 8                       # a window's first row must lie below it
    S = T // 4 + 20
    out = []
    # The mmse clock (32 channels a block, one chain warp): offsets within
    # a few rows, one channel 1700 rows on (it reaches its row limit early,
    # outside the ring), one past its limit (no symbol); and a slot limit
    # that ends the chain with most of the block still to load.
    for C in (33, 70):
        off = [(5 * c) % 13 for c in range(C)]
        off[5], off[C - 1] = 1700, limit + 3
        st = _clock_state(dm, C, rnd, dev, off)
        y = _signal(T, C, rnd, dev)
        for S_, what in ((S, "edges"), (96, "slot limit")):
            for cf in (False, True):
                entry = "(C, T)" if cf else "(T, C)"
                out.append(_clock_case(f"k2_mmse/{entry} {what} C={C} T={T} S={S_}", dm, y, st,
                                       S_, "mmse", 0, cf))
    # The sinc clocks and the mmse block update: 16 channels a block, four
    # channels a chain warp; at C = 21 the last block has two chain warps.
    C = 21
    retire = [0] * C
    for c in (8, 9, 10, 11, 20):                # block 0's warp 2, block 1's warp 1
        retire[c] = limit + 5
    apart = [(3 * c) % 7 for c in range(C)]
    for c in range(12, 20):                     # block 0's warp 3, block 1's warp 0
        apart[c] += APART
    both = list(apart)
    for c in (8, 9, 10, 11, 20):
        both[c] = limit + 5
    y = _signal(T, C, rnd, dev)
    for family, chunk in (("k2_sinc", 0), ("k2_bu16_sinc", 16)):
        for what, off in (("retire", retire), ("apart", apart)):
            st = _clock_state(dm, C, rnd, dev, off)
            out.append(_clock_case(f"{family}/{what} C={C} T={T}", dm, y, st, S, "sinc", chunk,
                                   False))
    st = _clock_state(dm, C, rnd, dev, both)
    y20, st20 = CF32(y.re[:, :20], y.im[:, :20]), _clock_state(dm, 20, rnd, dev, both[:20])
    for chunk in (1, 16, 64):
        for cf in (False, True):
            # 20 channels (whole 16-byte copies of a (T, C) row) or 21.
            c20 = (chunk == 16) != cf
            yy, ss = (y20, st20) if c20 else (y, st)
            entry = "(C, T)" if cf else "(T, C)"
            out.append(_clock_case(f"k2_bu16/K={chunk} {entry} C={yy.re.shape[1]} T={T}", dm,
                                   yy, ss, S, "mmse", chunk, cf))
    return out


def _stream_cases(dm: Demodulator, dev, rnd) -> list:
    C, T = STREAM_C, STREAM_T
    amp = _cycle((1e-3, 1.2, 0.3, 1e-4, 2.0, 0.7), C, dev)
    x = _ct(_signal(T, C, rnd, dev, amp))               # (C, T)
    gain = _cycle(EDGE_GAIN, C, dev)
    cp = dm._costas
    st = costas_op.CostasState(_cycle(EDGE_PHASE, C, dev), _cycle(EDGE_FREQ, C, dev) * cp.freq_max)
    out = []
    for what, agc in (("clamp", dm._agc._replace(max_gain=2.5)),
                      ("no clamp", dm._agc._replace(max_gain=0.0))):
        out.append((f"k5_agc/{what} C={C} T={T}",
                    lambda agc=agc: flat(stream_cuda.agc_block_kernel(x, gain, agc)),
                    lambda agc=agc: flat(agc_op.agc_block(x, gain, agc))))
    out.append((f"k6_costas/edges C={C} T={T}",
                lambda: flat(stream_cuda.costas_block_kernel(x, st, cp)),
                lambda: flat(costas_op.costas_block(x, st, cp))))
    for family, Ks in (("k6_slab", (2, 64)), ("k6_spread", (4, 8, 16))):
        for Kc in Ks:
            out.append((f"{family}/K={Kc} C={C} T={T}",
                        lambda Kc=Kc: flat(stream_cuda.costas_block_kernel(x, st, cp, Kc)),
                        lambda Kc=Kc: flat(costas_op.costas_block_update(x, st, cp, Kc))))
    return out


def ring_edges(L: int, S: int, E: int, dev, gen) -> dict:
    """Channels on the edges of K4a's and K4b's realignment and of the
    in-place shift, at ring length L, S new symbols, frame E.  Append: fills
    at every residue mod 8 against counts at every residue mod 8, none and
    one symbol, a block that fits exactly, one that overflows by a symbol, a
    full ring.  Extract: pos 0 with 0-7 symbols kept, nothing kept, more
    kept than pos, fill == L, pos at every residue mod 8 and near L - E,
    and channels short of a frame (not ok: their whole cluster returns)
    between channels that shift.  The last channel ends at its row's end,
    the last word of the tensors."""
    r8 = list(range(8))
    afill = [8 * 517 + r for r in r8] + [8 * 1001 + r for r in r8] + [0, 5, L - S, L - S + 1, L]
    an = [S - q for q in r8] + [S - 8 - q for q in r8[::-1]] + [0, 1, S, S, 1]
    xcase = ([(0, E + r) for r in r8]
             + [(p, p + E) for p in (0, 3, 8, 1001)]
             + [(5 + r, 5 + r + E + 20000 + 3 * r) for r in r8]
             + [(3 * r, L) for r in r8]
             + [(L - E - r, L) for r in range(4)]
             + [(p, min(L, p + E + 4999)) for p in range(1, 9)])
    short = [(0, E - 1), (0, 0), (7, 100), (40, E + 39), (L - E + 1, L)]
    mixed = []
    for i, v in enumerate(xcase):
        mixed.append(v)
        if i % 7 == 6:
            mixed.append(short[(i // 7) % len(short)])
    xcase = mixed + short
    # The last channel reaches the end of its row, the tensor's last word:
    # an append of S symbols at L - S, a frame popped at L - E of a full ring.
    C = max(len(afill), len(xcase)) + 1
    pad = lambda v, x, end: (v + [x] * C)[:C - 1] + [end]
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return dict(afill=t(pad(afill, 0, L - S)), an=t(pad(an, 0, S)),
                new=torch.randn((C, S), generator=gen).to(dev),
                xpos=t(pad([p for p, _ in xcase], 0, L - E)),
                xfill=t(pad([f for _, f in xcase], 0, L)),
                vals=torch.randn((C, L), generator=gen).to(dev))


def _ring_cases(dev) -> list:
    gen = torch.Generator().manual_seed(SEED + 4)
    E = K.CODED_FRAME_SIZE
    d = ring_edges(RING_L, RING_S, E, dev, gen)
    lane = torch.arange(RING_L, device=dev)[None, :]
    out = []
    for dtype in ring_cuda.RING_DTYPES:
        name = str(dtype).replace("torch.", "")
        ra = torch.where(lane < d["afill"][:, None], d["vals"], 0.0).to(dtype)
        rx = torch.where(lane < d["xfill"][:, None], d["vals"], 0.0).to(dtype)
        args = (d["afill"], d["new"], d["an"])
        out.append((f"k4a/{name} C={ra.shape[0]} L={RING_L} S={RING_S}",
                    lambda ra=ra: flat(ring_cuda.ring_append(ra.clone(), *args)),
                    lambda ra=ra: flat(ring_cuda.ring_append_plain(ra.clone(), *args))))
        # In place: each run on its own clone, the plain version on another.
        out.append((f"k4b/{name} C={rx.shape[0]} L={RING_L} E={E}",
                    lambda rx=rx: flat(ring_cuda.ring_extract(rx.clone(), d["xfill"], d["xpos"],
                                                              E)),
                    lambda rx=rx: flat(ring_cuda.ring_extract_plain(rx.clone(), d["xfill"],
                                                                    d["xpos"], E))))
    return out


def _roll_cases(dev) -> list:
    gen = torch.Generator().manual_seed(SEED + 5)
    C, L = 5, 2049 + 2048                        # two blocks a row and a ragged third
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (C, L), generator=gen).to(torch.int32)
    words = words.to(dev)
    amt = torch.tensor([0, 1, L - 1, L + 3, -2], dtype=torch.int32, device=dev)
    return [(f"k7_roll/C={C} L={L}", lambda: flat(roll_probe.barrel(words, amt)),
             lambda: flat(roll_probe.barrel_plain(words, amt)))]


RS_TILES = 300                 # tiles of 16 codewords: more than the grid's blocks
RS_TAIL = 5                    # codewords of the part-filled last tile
ACQ_C = 27                     # channels: three blocks of eight and one of three


def _rs_cases(dev) -> list:
    rng = np.random.default_rng(SEED + 6)
    cw = lambda n: reed_solomon.rs_encode_np(
        rng.integers(0, 256, (n, 223), dtype=np.int64).astype(np.uint8))
    edges = edge_cases.rs_batch(edge_cases.rs_edge_cases(SEED + 7), 16 * 8, SEED + 8)
    tiles = []
    for i in range(RS_TILES):
        kind = i % 4
        if kind == 0:                                   # every row errored
            t = rng.integers(0, 256, (16, 255), dtype=np.int64).astype(np.uint8)
        elif kind == 1:                                 # one row errored
            t = cw(16)
            t[i % 16, rng.choice(255, size=9, replace=False)] ^= 0x5A
        elif kind == 2:                                 # none
            t = cw(16)
        else:                                           # the edge words
            t = edges[16 * (i % 8): 16 * (i % 8) + 16]
        tiles.append(t)
    words = np.concatenate(tiles + [cw(RS_TAIL)])
    x = torch.from_numpy(words).to(dev)
    f = reed_solomon.interleave(x[: 4 * (x.shape[0] // 4)].reshape(-1, 4, 255)).contiguous()
    return [(f"k8_rs/codewords B={x.shape[0]}",
             lambda: flat(reed_solomon.rs_decode(x)),
             lambda: flat(reed_solomon.rs_decode_plain(x, 0))),
            (f"k8_rs/frames F={f.shape[0]}",
             lambda: flat(reed_solomon.rs_decode_frame(f)),
             lambda: flat(reed_solomon.rs_decode_frame_plain(f, 0)))]


def _acquire_cases(dev) -> list:
    """LRIT's words (a complement pair, the kernel's own instance) and
    HRIT's (two words that can tie), each on its edge ring."""
    lags = K.CODED_FRAME_SIZE
    window = lags + correlator.UW_BITS - 1
    # Block 0 all unlocked, block 1 one channel, block 2 none, block 3 two of three.
    locked = torch.ones(ACQ_C, dtype=torch.bool)
    locked[:8] = False
    locked[11] = False
    locked[24] = locked[26] = False
    locked = locked.to(dev)
    out = []
    for mode, words, seed in (("lrit", [K.LRIT_UW0, K.LRIT_UW2], SEED + 9),
                              ("hrit", [K.HRIT_UW0, K.HRIT_UW2], SEED + 10)):
        tpl = correlator.make_templates(words)
        masks = acquire_cuda.pack_masks(tpl)
        soft = torch.from_numpy(edge_cases.acquire_ring(ACQ_C, words, lags, seed))
        for dtype in ring_cuda.RING_DTYPES:
            name = str(dtype).replace("torch.", "")
            for pad in (0, 1):                    # rows on 16-byte boundaries, and not
                ring = torch.nn.functional.pad(soft, (0, pad)).to(dtype).to(dev)
                out.append((f"k9_acquire/{mode} {name} C={ACQ_C} L={ring.shape[1]}",
                            lambda ring=ring, masks=masks: flat(acquire_cuda.acquire_positions(
                                ring, locked, masks, window, K.MIN_CORRELATION_BITS)),
                            lambda ring=ring, tpl=tpl: flat(correlator.acquire_positions_plain(
                                ring, locked, tpl.to(dev), window, K.MIN_CORRELATION_BITS))))
    return out


def cases() -> list:
    """Every case as `(name, launch, plain)`: `launch()` runs the kernel once
    and returns its outputs and carried state as a flat list of tensors,
    `plain()` the plain version's on the same inputs.  Inputs are made here,
    from SEED, on the card; the loops' parameters are the LRIT
    configuration's at 1.25 Msps."""
    dev = torch.device("cuda")
    dm = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), STREAM_T, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *shape, scale=0.3: scale * torch.randn(shape, generator=g, device=dev)
    out = (_k1_cases(dm, dev, rnd) + _clock_cases(dm, dev, rnd) + _stream_cases(dm, dev, rnd)
           + _ring_cases(dev) + _roll_cases(dev) + _rs_cases(dev) + _acquire_cases(dev))
    for name, _, _ in out:
        if name.split("/")[0] not in FAMILIES:
            raise AssertionError(f"case {name!r} belongs to no family")
    return out


def _selected(all_cases: list, prefixes) -> list:
    if not prefixes:
        return all_cases
    return [c for c in all_cases if any(c[0].startswith(p) for p in prefixes)]


def run_cases(prefixes=(), launch_only: bool = False) -> int:
    """Each selected case once; one JSON line a case.  Returns the number of
    cases that differed or raised."""
    bad = 0
    for name, launch, plain in _selected(cases(), prefixes):
        t0 = time.perf_counter()
        timing.reset_launches()
        row = dict(case=name)
        try:
            got = launch()
            torch.cuda.synchronize()
            row["launches"] = sum(timing.launch_counts().values())
            if not launch_only:
                i = first_difference(got, plain())
                row["first_differing_output"] = i
                bad += i is not None
        except Exception as e:                      # a trap, a refused launch
            row["error"] = repr(e)[:400]
            bad += 1
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if "error" in row and "CUDA" in row["error"]:
            break                                   # the context is gone
    return bad


def run_isolated(prefixes=()) -> int:
    """Each case in a process of its own (`--case` its name); returns the
    number of cases whose process failed."""
    names = [c[0] for c in _selected(cases(), prefixes)]
    bad = 0
    for name in names:
        r = subprocess.run([sys.executable, "-m", "xritdemod_tpu_torch.tools.hazard_check",
                            "--case", name],
                           capture_output=True, text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        row = json.loads(lines[-1]) if lines else dict(case=name)
        row.update(rc=r.returncode)
        if r.returncode and not lines:
            row["stderr"] = r.stderr.strip().splitlines()[-3:]
        print(json.dumps(row), flush=True)
        bad += r.returncode != 0
    return bad


def find_sanitizer() -> str | None:
    exe = shutil.which("compute-sanitizer")
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if exe is None and home and (Path(home) / "bin" / "compute-sanitizer").exists():
            exe = str(Path(home) / "bin" / "compute-sanitizer")
    return exe


def sanitize(tools, out_dir: Path, prefixes=()) -> int:
    """This tool's `--launch-only` run under each sanitizer tool, a process
    each.  Returns 2 without a sanitizer or where it refuses the card, 1 if
    any tool reported an error or the run failed, else 0."""
    exe = find_sanitizer()
    if exe is None:
        print(json.dumps(dict(sanitizer=None, error="compute-sanitizer is not on this machine "
                              "(PATH, CUDA_HOME, /usr/local/cuda/bin): nothing was checked")))
        return 2
    out_dir.mkdir(parents=True, exist_ok=True)
    version = subprocess.run([exe, "--version"], capture_output=True, text=True).stdout
    kernels = sorted(set(FAMILIES.values()))
    status = 0
    for tool in tools:
        env = dict(os.environ)
        if tool in ("memcheck", "initcheck"):
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        cmd = [exe, "--tool", tool, "--error-exitcode", "9", "--report-api-errors", "no",
               sys.executable, "-m",
               "xritdemod_tpu_torch.tools.hazard_check", "--launch-only"]
        for p in prefixes:
            cmd += ["--case", p]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
            rc, text = r.returncode, r.stdout + r.stderr
        except subprocess.TimeoutExpired as e:
            rc, text = "timeout", (e.stdout or b"").decode() + (e.stderr or b"").decode()
        log = out_dir / f"{tool}.log"
        log.write_text(text)
        if "Device not supported" in text:
            # The sanitizer is there but refuses this card: nothing checked.
            print(json.dumps(dict(tool=tool, rc=rc, sanitizer=exe, checked=False,
                                  error="compute-sanitizer: Device not supported", log=str(log))),
                  flush=True)
            status = 2
            continue
        report = [ln for ln in text.splitlines() if ln.startswith("=========")]
        summary = [ln for ln in report if "SUMMARY" in ln]
        by_kernel = {k: sum(k in ln for ln in report) for k in kernels}
        cases_run = sum(ln.startswith('{"case"') for ln in text.splitlines())
        row = dict(tool=tool, rc=rc, seconds=time.perf_counter() - t0, cases=cases_run,
                   summary=summary, report_lines=len(report),
                   report_lines_naming=dict((k, v) for k, v in by_kernel.items() if v),
                   first_report_lines=[ln for ln in report if "SUMMARY" not in ln][:12],
                   log=str(log), command=" ".join(cmd[:7] + ["python", *cmd[8:]]))
        print(json.dumps(row), flush=True)
        if rc != 0:
            status = max(status, 1) if status != 2 else 2
    print(json.dumps(dict(sanitizer=exe, version=version.strip().splitlines()[-1:])))
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xritdemod_tpu_torch.tools.hazard_check")
    ap.add_argument("--case", action="append", default=[],
                    help="run only the cases whose names start with this (repeatable)")
    ap.add_argument("--launch-only", action="store_true",
                    help="launch each case once, no plain version (for the sanitizers)")
    ap.add_argument("--isolate", action="store_true", help="each case in its own process")
    ap.add_argument("--sanitize", nargs="+", choices=SANITIZER_TOOLS,
                    help="run under compute-sanitizer with these tools, a process each")
    ap.add_argument("--out", default="build/hazard_check",
                    help="directory of the sanitizers' full reports")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("hazard_check: no CUDA device: the cases run on the card\n")
        return 1
    print(json.dumps(dict(package=str(Path(clock_cuda.__file__).parents[1]),
                          card=timing.card(torch.device("cuda")))), flush=True)
    if args.sanitize:
        return sanitize(args.sanitize, Path(args.out), args.case)
    if args.isolate:
        return 1 if run_isolated(args.case) else 0
    return 1 if run_cases(args.case, args.launch_only) else 0


if __name__ == "__main__":
    sys.exit(main())
