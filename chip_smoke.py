#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc, no network
    python3 chip_smoke.py --profile  # also: device time of a step by kernel name,
                                     # and which warp of K1, K2, K5, K6 sets their time
    python3 chip_smoke.py --under-load   # the build and the `under_load` phase alone

Builds the eight CUDA libraries from `xritdemod_tpu_torch/csrc/` (and the apps'
host library, `runtime/native.py`, whose failure it reports), holds every
kernel against its plain PyTorch version on the card at the shapes its path
gives it (the RS decoder, K8, on the fused step's 4 x 2048 codewords on noise
and clean, at every Kmax of the plain route, on the edge words of
`tools/edge_cases.py` and at 1, 3, 33 rows; the acquisition, K9, on C = 2048
rings of the fused step's length with all, half and no channels unlocked,
float32 and bf16, their edge channels at the generator's positions, and at
1 and 17 channels) (the front end and the clock, both of its interpolators, over two
chained blocks, each version carrying its own state) and at small ragged
shapes (also: the clock where channels stand further apart than its
shared-memory ring, the sinc clock from edge states of mu and at one
channel, its branch-free taps against the exact ones at every float mu in
[0, 1], and the Costas step's sine and cosine against the CUDA library's,
the slab walks' large-argument path at every float with |x| >= 105615;
the plain recurrences run as replayed CUDA graphs, `ops/scan.py`,
themselves held bit-equal to eager loops first; the banded-matmul FIR at the
split path's shape against cuDNN and a float64 sum; the symbol ring's append
and in-place extract, float32 and bf16, on the edges of their realignment
and of the shift, bit for bit, and timed again at the main path's steady
fills, `ring_steady`), then drives the paths at
the shipped LRIT operating point,
C = 2048 channels x 131072 samples per block, on synthesised captures:

  - the fused receive, `FusedReceiver.step` and one block of `step_int8`;
    one steady block also through `step_cl` as its `(T, C)` transpose,
    from a copy of the same state, bit-equal to `step`; every step after
    the first under `torch.cuda.set_sync_debug_mode("error")`: a steady
    step makes no synchronising call (the acquisition and the RS decoder
    decide on the device);
  - the split receive, `Demodulator(frontend_kernel="split").block_batch`
    -> `quantize_symbols` -> int8 symbols -> one `StreamDecoder` per channel
    for 16 of the channels;
  - the fused receive again with `clock_interp="sinc"`;
  - `onchip`: the JAX package's own on-chip configuration, the fused
    receive with `frontend_block_update=8`, `frontend_precision="bf16"` and
    a bfloat16 ring (K1's slab and bf16 instance, K4 on a bf16 ring), its
    frames within 1 % of the exact receive's; the split path with
    `frontend_block_update=8, clock_block_update=16` (K6's slab instance,
    K2's block update) into `StreamDecoder`s; `block_batch` with the other
    forms (K1-bk8 in float32, K1-bf16, K2's sinc block update); every new
    instance against its plain version at its path's shape and on the
    ragged shapes (the slab kernels also at one channel, 17 and 48 channels,
    K6 at a K that runs across its tiles, and from Costas and AGC edge
    states), at K = 1 K6, K2 and K1's Costas slab against their exact
    instances; the slab instances built without stack frame or spill; the
    times beside the exact forms'; K1 with the slab on one loop
    (`block_stages="agc"` or `"costas"`, float32 and bf16) called as its op,
    and the four float32 forms of K = 8 timed in turns on one input;
  - `under_load`: every kernel whose warps or blocks hand work to each
    other, in the cases of `tools/hazard_check.py` (its FAMILIES; part-filled
    last blocks of channels, edge states), launched again and again beside a
    side stream's matrix products and beside its copies of a 1 GiB buffer,
    each launch bit for bit against the plain version; then the fused step
    and the split path with `StreamDecoder`s at C = 64 x 2^15, bit-equal
    between an idle run and a run beside each load;
  - `clock_max_block=2^15`: one `block_batch` exact and one with the block
    update, four segments, against the plain clock over the same segments;

and checks every recovered VCDU bit for bit against what was transmitted.
Then: the reference's frozen answers (`tests/fixtures/`: the SHA-pinned
streams through `StreamDecoder`, the raw-IQ fixture through `process` and
`block_batch` against the scalar chain of `tests/test_demod_kat.py`); one
LRIT stream through the serial `Demodulator.process` -> `StreamDecoder`,
per interpolator (its first block's kernels held against their plain
versions at one channel); `CaduDecoder.decode_multi` at 2048 x 8 frames
against sequential `decode_frames` (its one Viterbi launch against the plain
decoder); the RS decoder in `decode_frames` at 2048 frames (the kernel
against the plain route's sparse, full and errored-rows branches, every
field equal; the kernel's route makes no host read); the apps, the entry points a user starts: the two-process
interop (`tools/interop_run.py`: `cli decode` and `cli demod` over loopback
on 30 s of LRIT at 1.25 Msps, every frame checked on the vchannel port and
the statistics stream parsed), `ReceiverApp` at the config loader's default
(LRIT at 3 Msps, then the same file with `mode=hrit`; 10 s each) with its
kernel launches counted and its kernels held against their plain versions
on each capture's first block, and `DemodulatorApp` with `batch_pad=128`
against its serial path in alternated runs; the parallel layer
(`parallel`: 60 s of LRIT at 1.25 Msps and 10 s of HRIT at 3 Msps, 100 ppm
clock drift, s8 wire, through `tools/long_soak.py`'s `FoldedCaptureReceiver`
at 128 folds and through `cli reprocess` as a process, every frame checked,
the fold path's kernels held against their plain versions at C = 128;
the channel axis, the time-block axis (its split kernels held against their
plain versions on its rows, past 2^17 samples) and the sharded fused
receive on a mesh of four `cuda:0` entries against their unsharded
counterparts; two `tools/dist_worker.py` ranks over `gloo`); the repo's
measuring tools, ported (`tools`: `ber_sweep` on BER_SWEEP_r05's points,
LRIT in its two decoder variants, every frame bit-exact from -1 dB, and HRIT,
from 4 dB and below it the JAX tool's own frames;
`viterbi_margin_sweep` on VITERBI_MARGIN_r04's grid, the segmented Viterbi
bit-equal to the exact one; `interp_margin` at C = 128, both interpolators
within the JAX tool's rule and 128 of 128 channels full at sigma 0.01;
`scaling_sweep` over channels and a mesh of `cuda:0` entries; the per-stage
profilers of the fused receive, the decode, the demod chains, the clock and
front-end kernels and the host's budget; `drive_demod`'s checks; each
tool's launches counted apart); and the roll probe (`tools/roll_probe.py`).
Every phase prints one JSON line; any failure exits non-zero.  The last line
is `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Imports only the port (`xritdemod_tpu_torch`) and, for its scalar
transcription, `tests/test_demod_kat.py` (numpy only), never JAX.  The
processes it starts (the interop's two apps, four synthesis workers, two
`cli reprocess` runs, two `dist_worker` ranks) end before it does.  The
global TF32 flags stay at PyTorch's defaults: what needs full float32 asks
for it itself.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; this script runs on a GPU only\n")
    sys.exit(1)

from xritdemod_tpu_torch import _build, tx
from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig, StreamDecoder
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator, quantize_symbols
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.ops import agc as agc_op
from xritdemod_tpu_torch.ops import clock_recovery
from xritdemod_tpu_torch.ops import costas as costas_op
from xritdemod_tpu_torch.ops import scan as scan_op
from xritdemod_tpu_torch.ops import viterbi as viterbi_op
from xritdemod_tpu_torch.ops import (
    acquire_cuda, clock_cuda, correlator, filters, fir, frontend_cuda, reed_solomon, ring_cuda,
    rs_cuda, stream_cuda, viterbi_cuda,
)
from xritdemod_tpu_torch.ops.clock_recovery import NTAIL
from xritdemod_tpu_torch.parallel import distributed as pdist
from xritdemod_tpu_torch.parallel.channels import make_channel_mesh
from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver, TimeBlockDemodulator
from xritdemod_tpu_torch.runtime.apps import DemodulatorApp, ReceiverApp
from xritdemod_tpu_torch.runtime.config import demod_config_from_file
from xritdemod_tpu_torch.runtime import native
from xritdemod_tpu_torch.runtime.frontends import CFileFrontend
from xritdemod_tpu_torch.tools import (
    dist_worker, edge_cases, hazard_check, interop_run, long_soak, roll_probe, timing,
)
from xritdemod_tpu_torch.utils.cplx import (
    CF32, dequantize_iq_s8, from_complex, quantize_iq_s8, to_complex,
)

SEED = 20240
CHANNELS = 2048
BLOCK_LEN = 1 << 17
BLOCKS = 6               # `step`: one warm-up block + five steady blocks
SINC_BLOCKS = 4          # the same with the sinc interpolator: 1 warm-up + 3 steady
INT8_BLOCKS = 1          # then `step_int8` on the capture's next block
PROFILE_STEPS = 3        # further blocks of the capture, for --profile
STREAMS = 4              # distinct transmitted streams tiled over the channels
STREAM_DECODERS = 16     # channels of the split path that feed a StreamDecoder
MAX_DELAY = 69_649       # samples; per-channel delays spread over ~1 frame
# Noise per I/Q component (signal amplitude 0.3): one part in each stream, one
# part independent per channel; together they put Es/N0 near 7.7 dB.
NOISE_STREAM = 0.03
NOISE_CHANNEL = 0.03

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

DEV = torch.device("cuda", 0)
PROFILE = "--profile" in sys.argv[1:]
UNDER_LOAD_ONLY = "--under-load" in sys.argv[1:]      # the build and `under_load` alone


PHASE_S: dict[str, float] = {}        # wall seconds from the previous line to each
_LAST_LINE = [time.perf_counter()]


def say(phase: str, **kw) -> None:
    now = time.perf_counter()
    PHASE_S[phase] = PHASE_S.get(phase, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def once_ms(fn):
    """(result, wall ms) of one synchronised run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(nbytes: float, nops: float):
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------------------
# captures
# --------------------------------------------------------------------------

def make_streams(cfg: DemodConfig):
    """STREAMS transmitted streams: VCDUs (own VCID and counter base) and
    their IQ captures (own carrier offset, phase, noise), numpy."""
    need = (BLOCKS + INT8_BLOCKS + PROFILE_STEPS) * BLOCK_LEN + MAX_DELAY + 4096
    frames = int(np.ceil(need / cfg.sps / K.CODED_FRAME_SIZE)) + 1
    vcdus, iq = [], []
    for s in range(STREAMS):
        v = tx.make_vcdus(
            frames, scid=13, vcid=s + 1, counter0=1000 * (s + 1),
            rng=np.random.default_rng(SEED + s),
        )
        sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(SEED + 10 + s))
        sig = tx.modulate(
            sym, cfg, np.random.default_rng(SEED + 20 + s),
            freq_offset=(s - 1.5) * 2e-4, phase=0.4 + 0.9 * s, amp=0.3,
            noise=NOISE_STREAM,
        )
        if len(sig) < need:
            fail(f"stream {s}: {len(sig)} samples < {need} needed")
        vcdus.append(v)
        iq.append(sig[:need])
    iq = np.stack(iq)
    # Es/N0 as the receiver sees it: signal power per sample times samples
    # per symbol, over the noise density of both noise sources together.
    p_sig = float(np.mean(np.abs(iq) ** 2)) - 2 * NOISE_STREAM**2
    esn0 = p_sig * cfg.sps / (2 * (NOISE_STREAM**2 + NOISE_CHANNEL**2))
    return vcdus, 10 * np.log10(esn0), CF32(
        torch.from_numpy(np.ascontiguousarray(iq.real)).to(DEV),
        torch.from_numpy(np.ascontiguousarray(iq.imag)).to(DEV),
    )


def channel_delays() -> np.ndarray:
    c = np.arange(CHANNELS)
    return ((c // STREAMS) * 137 + (c % STREAMS) * 11) * 1009 % MAX_DELAY


def make_block(base: CF32, delays: np.ndarray, b: int, gen: torch.Generator,
               length: int = BLOCK_LEN) -> CF32:
    """Block `b` of the `(C, T)` capture (T = `length`): channel c carries
    stream c % STREAMS delayed by its own number of samples, plus its own
    noise."""
    t0 = b * length
    planes = []
    for plane in (base.re, base.im):
        rows = [
            plane[c % STREAMS, t0 + int(d) : t0 + int(d) + length]
            for c, d in enumerate(delays)
        ]
        x = torch.stack(rows)
        x += NOISE_CHANNEL * torch.randn(x.shape, generator=gen, device=DEV)
        planes.append(x)
    return CF32(*planes)


# --------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# --------------------------------------------------------------------------

def stage_clocks(library: str, roles, launch, kernel: str | None = None) -> None:
    """`--profile`: one launch of a debug build of `library` that counts, for
    its kernel's first block, the cycles every warp spends waiting on a
    barrier and the cycles of its whole role.  The stage that hardly waits
    sets the kernel's time."""
    with _build.stage_clocks(library) as read:
        launch()
        read()                      # the first launch also loads the library
        launch()
        wait, role = read()
    say("stage_clocks", kernel=kernel or library, warps=[
        dict(role=name, cycles=role[i], waiting_share=wait[i] / max(role[i], 1))
        for i, name in enumerate(roles) if name is not None])


def frontend_errs(k, p) -> list[float]:
    """Largest differences of two front-end results: output, gain, history,
    Costas state."""
    return [
        max_err(k[0].re, p[0].re), max_err(k[0].im, p[0].im), max_err(k[1], p[1]),
        max_err(k[2].re, p[2].re), max_err(k[2].im, p[2].im),
        max_err(k[3].phase, p[3].phase), max_err(k[3].freq, p[3].freq),
    ]


def clock_errs(k, p, what: str) -> list[float]:
    """Largest differences of two clock results; symbol counts and sample
    positions must be equal."""
    (ks, kv, kst), (ps, pv, pst) = k, p
    if not torch.equal(kv, pv):
        fail(f"{what}: symbol counts differ from the plain version")
    if not torch.equal(kst.ii, pst.ii):
        fail(f"{what}: sample positions differ from the plain version")
    return [
        max_err(ks.re, ps.re), max_err(ks.im, ps.im), max_err(kst.mu, pst.mu),
        max_err(kst.omega, pst.omega), max_err(kst.p.re, pst.p.re), max_err(kst.p.im, pst.p.im),
        max_err(kst.c.re, pst.c.re), max_err(kst.c.im, pst.c.im),
        max_err(kst.tail.re, pst.tail.re), max_err(kst.tail.im, pst.tail.im),
    ]


def check_kernels(rx: FusedReceiver, x0: CF32, x1: CF32, vcdus,
                  where: str = "main path") -> list[dict]:
    """Each kernel against its plain version on the card, at the shapes of
    `rx`'s step on `(C, T)` blocks.  The front end and
    the clock run the capture's first two blocks chained, the kernel carrying
    its own state and the plain version its own, from the same cold start;
    both blocks are compared, and the times are the second block's (loops
    pulled in, as in steady reception).  The standalone AGC and Costas stages
    take the second block with the state the plain front end's first block
    left.  One run of the plain front end serves three kernels: its AGC stage
    is the plain standalone AGC on the same block and gain, and its Costas
    stage, fed its own filter output, the plain standalone Costas loop
    (`demod_frontend_plain(stages=...)`).  A disagreement fails `where`."""
    demod = rx._demod
    C, T = x0.re.shape
    st = demod.init_state_batch(C)
    fe_params = (demod._agc, demod._rrc_taps, demod._costas)
    rows = []

    # K1 front end, block 0 then block 1.
    xT0 = CF32(x0.re.t().contiguous(), x0.im.t().contiguous())
    k0 = frontend_cuda.demod_frontend(xT0, st.agc_gain, st.rrc_hist, st.costas, *fe_params)
    p0 = frontend_cuda.demod_frontend_plain(xT0, st.agc_gain, st.rrc_hist, st.costas, *fe_params)
    errs0 = frontend_errs(k0, p0)
    if not max(errs0) <= 1e-4:
        fail(f"{where}: front end, first block, disagrees with its plain version: {errs0}")
    # The clock's first block, on the plain front end's output for both.
    ck0 = (p0[0], st.clock, demod._clock, demod.num_slots)
    kc0 = clock_cuda.clock_recovery_block_kernel_batch_cl(*ck0)
    pc0 = clock_cuda.clock_recovery_block_plain_cl(*ck0)
    cerrs0 = clock_errs(kc0, pc0, f"{where}: clock, first block")
    if not max(cerrs0) <= 1e-4:
        fail(f"{where}: clock, first block, disagrees with its plain version: {cerrs0}")
    # The sinc instance on the same input, each version from the same cold
    # state.
    ks0 = clock_cuda.clock_recovery_block_kernel_batch_cl(*ck0, "sinc")
    ps0 = clock_cuda.clock_recovery_block_plain_cl(*ck0, "sinc")
    serrs0 = clock_errs(ks0, ps0, f"{where}: clock (sinc), first block")
    if not max(serrs0) <= 0.0:
        fail(f"{where}: clock (sinc), first block, disagrees with its plain version: {serrs0}")
    del xT0, ck0
    k_state, p_state = k0[1:], p0[1:]
    kc_state, pc_state = kc0[2], pc0[2]
    ks_state, ps_state = ks0[2], ps0[2]
    del k0, p0, kc0, pc0, ks0, ps0

    xT = CF32(x1.re.t().contiguous(), x1.im.t().contiguous())
    k_out = frontend_cuda.demod_frontend(xT, *k_state, *fe_params)
    torch.cuda.synchronize()
    stages: dict = {}
    p_out, plain_ms = once_ms(
        lambda: frontend_cuda.demod_frontend_plain(xT, *p_state, *fe_params, stages=stages))
    errs = frontend_errs(k_out, p_out)
    if not max(errs) <= 1e-4:
        fail(f"{where}: front end, second block, disagrees with its plain version: {errs}")
    errs = errs + errs0
    fe_args = (xT, *k_state, *fe_params)
    ms = time_ms(lambda: frontend_cuda.demod_frontend(*fe_args), 3)
    if PROFILE:
        stage_clocks("frontend", frontend_cuda.ROLES,
                     lambda: frontend_cuda.demod_frontend(*fe_args))
    N = int(demod._rrc_taps.shape[0])
    bms, by = bound(4 * (4 * T * C + 4 * C * (N - 1) + 6 * C), T * C * (4 * N + 40))
    rows.append(dict(
        name="frontend", route="cuda", source="xritdemod_tpu_torch/csrc/frontend.cu",
        replaces="xritdemod_tpu/ops/frontend_pallas.py:335", max_abs_err=max(errs),
        tolerance="atol 1e-4, two chained blocks", ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
    ))

    # K5 standalone AGC on the (C, T) block: expected is the plain front
    # end's AGC stage.
    agc_args = (x1, p_state[0], demod._agc)
    ky, kg = stream_cuda.agc_block_kernel(*agc_args)
    errs = [max_err(ky.re, stages["agc"].re.t()), max_err(ky.im, stages["agc"].im.t()),
            max_err(kg, p_out[1])]
    if not max(errs) <= 1e-4:
        fail(f"{where}: agc_block_kernel disagrees with its plain version: {errs}")
    ms = time_ms(lambda: stream_cuda.agc_block_kernel(*agc_args), 3)
    if PROFILE:
        stage_clocks("stream", stream_cuda.ROLES["agc_block"],
                     lambda: stream_cuda.agc_block_kernel(*agc_args), "agc_block")
    bms, by = bound(4 * (4 * T * C + 2 * C), T * C * 10.0)
    rows.append(dict(
        name="agc_block", route="cuda", source="xritdemod_tpu_torch/csrc/stream.cu",
        replaces="xritdemod_tpu/ops/stream_pallas.py:152", max_abs_err=max(errs),
        tolerance="atol 1e-4, gain included", ms=ms,
        plain_ms=stages["seconds"]["agc"] * 1e3, bound_ms=bms, bound_by=by, library_ms=None,
    ))
    del ky, kg

    # K6 standalone Costas on the (C, T) filter output: expected is the plain
    # front end's Costas stage.
    fir_ct = CF32(stages["fir"].re.t().contiguous(), stages["fir"].im.t().contiguous())
    cos_args = (fir_ct, p_state[2], demod._costas)
    ky, ks_ = stream_cuda.costas_block_kernel(*cos_args)
    errs = [max_err(ky.re, p_out[0].re.t()), max_err(ky.im, p_out[0].im.t()),
            max_err(ks_.phase, p_out[3].phase), max_err(ks_.freq, p_out[3].freq)]
    if not max(errs) <= 1e-4:
        fail(f"{where}: costas_block_kernel disagrees with its plain version: {errs}")
    ms = time_ms(lambda: stream_cuda.costas_block_kernel(*cos_args), 3)
    if PROFILE:
        stage_clocks("stream", stream_cuda.ROLES["costas_block"],
                     lambda: stream_cuda.costas_block_kernel(*cos_args), "costas_block")
    bms, by = bound(4 * (4 * T * C + 4 * C), T * C * 40.0)
    rows.append(dict(
        name="costas_block", route="cuda", source="xritdemod_tpu_torch/csrc/stream.cu",
        replaces="xritdemod_tpu/ops/stream_pallas.py:187", max_abs_err=max(errs),
        tolerance="atol 1e-4, phase and freq included", ms=ms,
        plain_ms=stages["seconds"]["costas"] * 1e3, bound_ms=bms, bound_by=by,
        library_ms=None,
    ))
    del ky, ks_, fir_ct, cos_args, p_out, stages

    # K2 clock, second block: the front end's output, each version with the
    # state its own first block left.
    yT = k_out[0]
    ck_args = (yT, kc_state, demod._clock, demod.num_slots)
    ks, kv, kst = clock_cuda.clock_recovery_block_kernel_batch_cl(*ck_args)
    torch.cuda.synchronize()
    (ps, pv, pst), plain_ms = once_ms(lambda: clock_cuda.clock_recovery_block_plain_cl(
        yT, pc_state, demod._clock, demod.num_slots))
    errs = clock_errs((ks, kv, kst), (ps, pv, pst), f"{where}: clock, second block")
    if not max(errs) <= 1e-4:
        fail(f"{where}: clock, second block, disagrees with its plain version: {errs}")
    errs = errs + cerrs0
    ms = time_ms(lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(*ck_args), 3)
    if PROFILE:
        stage_clocks("clock", clock_cuda.ROLES["clock"],
                     lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(*ck_args))
    nsym = int(kv.sum())
    S = demod.num_slots
    bms, by = bound(4 * (2 * (T + NTAIL) * C + 2 * C * S + 30 * C), nsym * 70.0)
    rows.append(dict(
        name="clock", route="cuda", source="xritdemod_tpu_torch/csrc/clock.cu",
        replaces="xritdemod_tpu/ops/clock_pallas.py:539", max_abs_err=max(errs),
        tolerance="atol 1e-4, equal symbol counts and positions, two chained blocks", ms=ms,
        plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None, symbols=nsym,
    ))
    del ps, pv, pst

    # K2's sinc instance, second block: the same input, each version with
    # the state its own first block left.  The same bytes as the mmse
    # instance; per symbol ~190 float operations (sinf, the shared-reduction
    # sine and cosine, eight window taps, sixteen divisions, the
    # interpolation and the loop).
    sk = clock_cuda.clock_recovery_block_kernel_batch_cl(
        yT, ks_state, demod._clock, demod.num_slots, "sinc")
    torch.cuda.synchronize()
    sp, plain_ms = once_ms(lambda: clock_cuda.clock_recovery_block_plain_cl(
        yT, ps_state, demod._clock, demod.num_slots, "sinc"))
    errs = clock_errs(sk, sp, f"{where}: clock (sinc), second block")
    if not max(errs) <= 0.0:
        fail(f"{where}: clock (sinc), second block, disagrees with its plain version: {errs}")
    errs = errs + serrs0
    sargs = (yT, ks_state, demod._clock, demod.num_slots, "sinc")
    ms = time_ms(lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(*sargs), 3)
    if PROFILE:
        stage_clocks("clock", clock_cuda.ROLES["clock_sinc"],
                     lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(*sargs),
                     "clock_sinc")
    nsym_s = int(sk[1].sum())
    bms, by = bound(4 * (2 * (T + NTAIL) * C + 2 * C * S + 30 * C), nsym_s * 190.0)
    rows.append(dict(
        name="clock_sinc", route="cuda", source="xritdemod_tpu_torch/csrc/clock.cu",
        replaces="xritdemod_tpu/ops/clock_pallas.py:539",
        form="interp_mode='sinc' (clock_pallas.py:352-372)", max_abs_err=max(errs),
        tolerance="exact, equal symbol counts and positions, two chained blocks", ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None, symbols=nsym_s,
    ))
    del sk, sp, sargs

    # K4a ring append: the clock's symbols onto rings with random fills; a
    # few channels are set to overflow.
    g = torch.Generator(device="cpu").manual_seed(SEED)
    L = rx.ring_len
    n_new = kv.sum(-1).to(torch.int32)
    fill = torch.randint(0, L - S, (C,), generator=g).to(torch.int32)
    fill[::97] = L - 100
    fill = fill.to(DEV)
    ring0 = torch.randn((C, L), generator=g).to(DEV)
    ring0 = torch.where(torch.arange(L, device=DEV)[None, :] < fill[:, None], ring0, 0.0)
    kr, kf, ko = ring_cuda.ring_append(ring0.clone(), fill, ks.re, n_new)
    (pr, pf, po), plain_ms = once_ms(
        lambda: ring_cuda.ring_append_plain(ring0.clone(), fill, ks.re, n_new))
    if not (torch.equal(kr, pr) and torch.equal(kf, pf) and torch.equal(ko, po)):
        fail(f"{where}: ring_append differs from its plain version")
    if not bool(ko.any()) or bool(ko.all()):
        fail(f"{where}: ring_append check: wanted some overflowing channels, not all")
    scratch = ring0.clone()
    ms = time_ms(lambda: ring_cuda.ring_append(scratch, fill, ks.re, n_new), 10)
    moved = int(n_new[~ko].sum())
    bms, by = bound(4 * (2 * moved + 4 * C), 0.0)
    # No one PyTorch call appends n_new[c] of a channel's S lanes at its fill
    # and refuses a channel that would overflow: the nearest, one `scatter_`
    # of all S lanes from the fill on (the index made beforehand), writes
    # the lanes past n_new too and checks nothing.
    idx = (fill[:, None].to(torch.int64) + torch.arange(S, device=DEV)).clamp(max=L - 1)
    near = time_ms(lambda: scratch.scatter_(1, idx, ks.re), 10)
    rows.append(dict(
        name="ring_append", route="cuda", source="xritdemod_tpu_torch/csrc/ring.cu",
        replaces="xritdemod_tpu/ops/ring_pallas.py:114", max_abs_err=0.0, tolerance="exact",
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        nearest_library_call=dict(call="Tensor.scatter_ of all S lanes at the fill (no "
                                  "n_new mask, no overflow check)", ms=near),
    ))
    del idx

    # K4b ring extract: random positions; channels short of a frame stay.
    # Every 61st channel holds half a frame, so some are short at any C.
    E = K.CODED_FRAME_SIZE
    kf[1::61] = E // 2
    kr[1::61, E // 2 :] = 0
    pos = torch.randint(0, E, (C,), generator=g).to(torch.int32).to(DEV)
    # The extract works in place: each version on its own copy; the timed
    # calls reuse one ring (a call's traffic depends only on fill and pos).
    kin, pin = kr.clone(), kr.clone()
    kout = ring_cuda.ring_extract(kin, kf, pos, E)
    pout, plain_ms = once_ms(lambda: ring_cuda.ring_extract_plain(pin, kf, pos, E))
    if kout[0].data_ptr() != kin.data_ptr():
        fail(f"{where}: ring_extract did not hand back the ring it was given")
    if not all(torch.equal(a, b) for a, b in zip(kout, pout)):
        fail(f"{where}: ring_extract differs from its plain version")
    if bool(kout[3].all()) or not bool(kout[3].any()):
        fail(f"{where}: ring_extract check: wanted both ok and not-ok channels")
    del kin, pin
    scratch = kr.clone()
    ms = time_ms(lambda: ring_cuda.ring_extract(scratch, kf, pos, E), 10)
    # Least traffic for these fills and positions: a channel that pops reads
    # the symbols it keeps and writes them at the front, zeroes the slots it
    # vacated up to its old fill; every channel reads and writes E symbols of
    # `out`; a channel short of a frame moves nothing else.
    okc = kout[3]
    kept = int(kout[1][okc].sum())
    bms, by = bound(4 * (kept + int(kf[okc].sum()) + 2 * C * E + 4 * C), 0.0)
    # No one PyTorch call both takes a frame out at pos and shifts the rest
    # of the ring to its front: the nearest, one `torch.gather` of the E
    # symbols from pos (the index made beforehand), leaves the ring as it is.
    idx = pos[:, None].to(torch.int64) + torch.arange(E, device=DEV)
    near = time_ms(lambda: torch.gather(kr, 1, idx), 10)
    rows.append(dict(
        name="ring_extract", route="cuda", source="xritdemod_tpu_torch/csrc/ring.cu",
        replaces="xritdemod_tpu/ops/ring_pallas.py:145", max_abs_err=0.0, tolerance="exact",
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        nearest_library_call=dict(call="torch.gather of the E symbols at pos (the ring "
                                  "not shifted)", ms=near),
    ))
    del idx
    del kr, pr, kout, pout, ring0, scratch

    # K3 Viterbi: C noisy coded frames with history, windowed as the decoder
    # windows them (S from its rule, overlap 128).
    soft = []
    for s in range(STREAMS):
        sym = tx.encode_stream(
            vcdus[s][:2], lrit=True, noise=0.7, rng=np.random.default_rng(SEED + 30 + s))
        soft.append(sym[K.CODED_FRAME_SIZE - 64 : 2 * K.CODED_FRAME_SIZE])
    ext = torch.from_numpy(np.stack(soft)).to(DEV).repeat(C // STREAMS, 1)
    ext = ext + 0.3 * torch.randn(ext.shape, generator=torch.Generator(DEV).manual_seed(SEED),
                                  device=DEV)
    segs = rx._dec._segments(C)
    wins, _, Lw = viterbi_cuda.segment_windows(ext, segs, 128)
    kb = viterbi_cuda.decode_bits(wins)
    pb, plain_ms = once_ms(lambda: viterbi_cuda.decode_bits_plain(wins))
    nbad = int((kb != pb).sum())
    if nbad:
        fail(f"{where}: viterbi differs from its plain version in {nbad} bits")
    ms = time_ms(lambda: viterbi_cuda.decode_bits(wins), 5)
    NW = wins.shape[0]
    bms, by = bound(NW * Lw * 9.0, NW * Lw * (64 * 4 + 12.0))
    # The windows `StreamDecoder` gives K3 (16 per frame of 770 steps: 8
    # frames, then the one frame of a flush), bit for bit and timed.
    split_shapes = []
    for nw in (128, 16):
        w_s = wins[:nw, : 2 * 770].contiguous()
        if not torch.equal(viterbi_cuda.decode_bits(w_s), viterbi_cuda.decode_bits_plain(w_s)):
            fail(f"{where}: viterbi at {nw} x 770 differs from its plain version")
        split_shapes.append(dict(
            windows=nw, steps=770, lanes=viterbi_cuda.lanes_per_window(nw),
            ms=time_ms(lambda: viterbi_cuda.decode_bits(w_s), 20)))
    rows.append(dict(
        name="viterbi", route="cuda", source="xritdemod_tpu_torch/csrc/viterbi.cu",
        replaces="xritdemod_tpu/ops/viterbi_pallas.py:253", max_abs_err=0.0, tolerance="exact",
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        lanes=viterbi_cuda.lanes_per_window(NW), split_shapes=split_shapes,
        windows=NW, steps=Lw,
    ))
    return rows


RS_ROWS = 4 * CHANNELS         # the fused step's codewords: 4 a frame, a frame a channel
RS_RAGGED = (1, 3, 33)
RS_EDGE_ROWS = 1024            # the edge words in one batch, at the automatic Kmax 128
RS_SPARSE = (0, 4, None)       # the plain route's Kmax: its rows, its sparse and full branches


def rs_bound(nerr: torch.Tensor):
    """K8's least time for the rows whose results are `nerr`: the design's
    work (`rs_cuda.bound_work`: bytes, and the errored rows' table
    multiply-adds against the float32 rate; the syndromes' b1 product on the
    tensor cores left out), then the table algorithm's (`rs_cuda.table_work`,
    the yardstick of the one-warp kernel before it): `(ms, by, table_ms,
    table_by)`."""
    rows, errored = nerr.numel(), int((nerr != 0).sum())
    return bound(*rs_cuda.bound_work(nerr)) + bound(*rs_cuda.table_work(rows, errored))


def check_rs() -> dict:
    """K8 against the plain route on the card, bit for bit, through both
    entries.  Codewords: the fused step's 4 x 2048 on noise (random words:
    every one errored and uncorrectable) and on clean frames (codewords),
    each at every Kmax of RS_SPARSE (the plain route's errored rows, its
    sparse and its full branch); the edge words of `tools/edge_cases.py`
    (16 and 17 errors, parity only, the end bytes, all-zero and all-0xFF
    words, a miscorrection, random and length-18 words) in a batch of 1024;
    the ragged batches of 1, 3 and 33 rows.  Frames (the frame entry, the
    interleave read in place) against `rs_decode_frame_plain` at every
    Kmax: the fused step's 2048 frames on noise, clean and mixed (slots of
    clean, errored and random words); the edge words in every slot
    (`edge_cases.rs_frames`); 1, 3 and 33 frames.  Times of the kernel on
    noise and on clean words through each entry: the device time
    (`timing.graph_ms`, its host time left out) and the eager time (20 calls
    between two events); the plain route's errored rows (Kmax 0) on each;
    the kernels one frame call launches (torch.profiler: K8 alone, no copy
    around it)."""
    rng = np.random.default_rng(SEED + 80)
    noise = torch.from_numpy(rng.integers(0, 256, (RS_ROWS, 255), dtype=np.int64)
                             .astype(np.uint8)).to(DEV)
    clean = torch.from_numpy(reed_solomon.rs_encode_np(
        rng.integers(0, 256, (RS_ROWS, 223), dtype=np.int64).astype(np.uint8))).to(DEV)
    cases = edge_cases.rs_edge_cases(SEED + 81)
    edges = torch.from_numpy(edge_cases.rs_batch(cases, RS_EDGE_ROWS, SEED + 82)).to(DEV)
    mixed = torch.cat([edges[:40], noise[:8], clean[:8]])
    as_frames = lambda cw: reed_solomon.interleave(cw.reshape(-1, 4, 255)).contiguous()
    slots = torch.stack([clean, noise, edges.repeat(RS_ROWS // RS_EDGE_ROWS, 1)], 1)
    pick = torch.from_numpy(rng.integers(0, 3, RS_ROWS)).to(DEV)
    mixed_frames = as_frames(slots[torch.arange(RS_ROWS, device=DEV), pick])
    edge_frames = torch.from_numpy(edge_cases.rs_frames(cases, SEED + 83)).to(DEV)
    out = dict(cases={}, frame_cases={})

    def held(name, x, sparse=RS_SPARSE):
        k = rs_cuda.rs_decode_kernel(x)
        for sm in sparse:
            p = reed_solomon.rs_decode_plain(x, sm)
            if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
                fail(f"rs: the kernel differs from the plain route (Kmax {sm}) on {name}")
        out["cases"][name] = dict(rows=int(x.shape[0]), corrected=int((k[1] > 0).sum()),
                                  failed=int((k[1] < 0).sum()))
        return k

    def held_frames(name, f, sparse=RS_SPARSE):
        k = reed_solomon.rs_decode_frame(f)
        for sm in sparse:
            p = reed_solomon.rs_decode_frame_plain(f, sm)
            if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
                fail(f"rs: the frame entry differs from the plain route (Kmax {sm}) on {name}")
        out["frame_cases"][name] = dict(frames=int(f.shape[0]),
                                        corrected=int((k[1] > 0).sum()),
                                        failed=int((k[1] < 0).sum()))

    kn = held("noise", noise)
    held("clean", clean)
    held("edges", edges)
    for B in RS_RAGGED:
        held(f"ragged_{B}", mixed[:B].contiguous(), (0, None))
    if out["cases"]["clean"]["corrected"] or out["cases"]["clean"]["failed"]:
        fail(f"rs: clean codewords corrected or failed: {out['cases']['clean']}")
    noise_f, clean_f = as_frames(noise), as_frames(clean)
    held_frames("noise", noise_f)
    held_frames("clean", clean_f)
    held_frames("mixed", mixed_frames)
    held_frames("edges_in_every_slot", edge_frames)
    for F in RS_RAGGED:
        held_frames(f"ragged_{F}", edge_frames[F:2 * F].contiguous())
    before = rs_cuda.launches
    _, ks = timing.device_kernels(lambda: reed_solomon.rs_decode_frame(noise_f))
    frame_kernels = sum(c for _, _, c in ks)
    if rs_cuda.launches - before != 1 or frame_kernels > 1:
        fail(f"rs: a frame call launched {frame_kernels} kernels: {[k for k, _, _ in ks]}")
    ms = time_ms(lambda: rs_cuda.rs_decode_kernel(noise), 20)
    clean_ms = time_ms(lambda: rs_cuda.rs_decode_kernel(clean), 20)
    dev_ms = timing.graph_ms(lambda: rs_cuda.rs_decode_kernel(noise))
    clean_dev_ms = timing.graph_ms(lambda: rs_cuda.rs_decode_kernel(clean))
    frame_times = dict(
        noise_device_ms=timing.graph_ms(lambda: reed_solomon.rs_decode_frame(noise_f)),
        noise_eager_ms=time_ms(lambda: reed_solomon.rs_decode_frame(noise_f), 20),
        clean_device_ms=timing.graph_ms(lambda: reed_solomon.rs_decode_frame(clean_f)),
        clean_eager_ms=time_ms(lambda: reed_solomon.rs_decode_frame(clean_f), 20),
        kernels_per_call=frame_kernels)
    _, plain_ms = once_ms(lambda: reed_solomon.rs_decode_plain(noise, 0))
    _, plain_clean_ms = once_ms(lambda: reed_solomon.rs_decode_plain(clean, 0))
    errored = int((kn[1] != 0).sum())
    bms, by, tbms, tby = rs_bound(kn[1])
    cbms, cby, ctbms, ctby = rs_bound(torch.zeros(RS_ROWS, dtype=torch.int32))
    return dict(
        name="rs", route="cuda", source="xritdemod_tpu_torch/csrc/rs.cu",
        replaces="xritdemod_tpu/ops/reed_solomon.py:313",
        replaces_kind="rs_decode with _rs_correct (:313-518): an XLA program (lax.scan, "
                      "lax.cond), no pl.pallas_call",
        max_abs_err=0.0, tolerance="exact, every Kmax of the plain route, both entries",
        ms=ms, ms_is="eager: 20 calls between two events, the wrapper's host time in it",
        device_ms=dev_ms, device_ms_is="timing.graph_ms: 20 calls as a CUDA graph",
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None, rows=RS_ROWS,
        errored_rows=errored, clean_ms=clean_ms, clean_device_ms=clean_dev_ms,
        clean_plain_ms=plain_clean_ms, clean_bound_ms=cbms, clean_bound_by=cby,
        table_bound_ms=tbms, table_bound_by=tby, clean_table_bound_ms=ctbms,
        clean_table_bound_by=ctby,
        bound_is="the design's work (rs_cuda.bound_work); table_bound: the table algorithm's "
                 "(rs_cuda.table_work)", frames=frame_times, **out)


ACQ_SEED = SEED + 90


def check_acquire(rx: FusedReceiver) -> dict:
    """K9 against its plain version on the card, bit for bit, on the fused
    step's rings (C = 2048, its ring length) from `tools/edge_cases.py`
    (its edge channels first: a sync at lag 0 and at the last lag, both
    words, ties between words and between lags, -0.0 symbols, a word below
    the threshold; the rest a sync at a random lag or noise), float32 and
    bf16, with all, half and no channels unlocked; the edge channels'
    positions as the generator places them; the ragged C = 1 and 17; then
    HRIT's words (two words that tie, the kernel's general instance) on
    their own edge ring, f32 and bf16, all, half and no channels unlocked.
    The kernel takes the packed sign masks, the plain version the templates
    they stand for.  Times (the receiver's LRIT words): the kernel's device time (`timing.graph_ms`) and
    eager time, and the plain version's, in each case."""
    C, L, window = CHANNELS, rx.ring_len, rx._acq
    words = rx.decoder_config.uws
    thresh = rx.decoder_config.min_correlation_bits
    lags = window - correlator.UW_BITS + 1
    tpl = acquire_cuda.unpack_masks(rx._acq_words, DEV)
    soft = torch.from_numpy(edge_cases.acquire_ring(C, words, lags, ACQ_SEED)).to(DEV)
    ring = torch.zeros((C, L), device=DEV)
    ring[:, : soft.shape[1]] = soft
    del soft
    lockings = dict(all_unlocked=torch.zeros(C, dtype=torch.bool, device=DEV),
                    half_unlocked=torch.arange(C, device=DEV) % 2 == 1,
                    none_unlocked=torch.ones(C, dtype=torch.bool, device=DEV))
    want_edges = [0, lags - 1, lags // 2 + 17, 5000, 300, 40, 0, 0, 1]
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        r = ring.to(dt)
        esize = r.element_size()
        for name, locked in lockings.items():
            args = (r, locked, tpl, window, thresh)
            kargs = (r, locked, rx._acq_words, window, thresh)
            k = acquire_cuda.acquire_positions(*kargs)
            correlator.acquire_positions_plain(*args)        # cuDNN's choice made
            p, plain_ms = once_ms(lambda: correlator.acquire_positions_plain(*args))
            if not torch.equal(k, p):
                fail(f"acquire ({name}, {dt}): the kernel differs from its plain version")
            if name == "all_unlocked" and k[1:edge_cases.EDGE_CHANNELS].tolist() != want_edges:
                fail(f"acquire ({dt}): edge channels at {k[:edge_cases.EDGE_CHANNELS].tolist()}")
            unlocked = int((~locked).sum())
            bms, by = bound(*acquire_cuda.bound_work(C, unlocked, window, len(words), esize))
            kernel = lambda: acquire_cuda.acquire_positions(*kargs)
            cases[f"{name}_{str(dt).replace('torch.', '')}"] = dict(
                unlocked=unlocked, ms=time_ms(kernel, 20), device_ms=timing.graph_ms(kernel),
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, synced=int((k != 0).sum()))
        for Cr in (1, 17):
            sub = r[:Cr].contiguous()
            lk = torch.zeros(Cr, dtype=torch.bool, device=DEV)
            if not torch.equal(acquire_cuda.acquire_positions(sub, lk, rx._acq_words, window,
                                                              thresh),
                               correlator.acquire_positions_plain(sub, lk, tpl, window, thresh)):
                fail(f"acquire (C = {Cr}, {dt}): the kernel differs from its plain version")
    # HRIT's words, two that can tie (the kernel's general instance; the
    # receiver's LRIT pair takes the complement instance): held, not timed.
    hmasks = acquire_cuda.pack_masks(correlator.make_templates([K.HRIT_UW0, K.HRIT_UW2]))
    htpl = acquire_cuda.unpack_masks(hmasks, DEV)
    hring = torch.zeros((C, L), device=DEV)
    hsoft = edge_cases.acquire_ring(C, [K.HRIT_UW0, K.HRIT_UW2], lags, ACQ_SEED + 1)
    hring[:, : hsoft.shape[1]] = torch.from_numpy(hsoft).to(DEV)
    del hsoft
    for dt in (torch.float32, torch.bfloat16):
        r = hring.to(dt)
        for name, locked in lockings.items():
            k = acquire_cuda.acquire_positions(r, locked, hmasks, window, thresh)
            if not torch.equal(k, correlator.acquire_positions_plain(r, locked, htpl, window,
                                                                     thresh)):
                fail(f"acquire (HRIT words, {name}, {dt}): the kernel differs from its plain "
                     f"version")
            if name == "all_unlocked" and k[1:edge_cases.EDGE_CHANNELS].tolist() != want_edges:
                fail(f"acquire (HRIT words, {dt}): edge channels at "
                     f"{k[:edge_cases.EDGE_CHANNELS].tolist()}")
            cases[f"hrit_{name}_{str(dt).replace('torch.', '')}"] = dict(
                unlocked=int((~locked).sum()), synced=int((k != 0).sum()))
    del hring
    # The nearest PyTorch call: one convolution of the ring's signs (made
    # beforehand) with the templates gives the counts, not the first best
    # lag, the threshold or the lock select.
    signs = torch.where(ring[:, None, :window] < 0, -1.0, 1.0)
    near = time_ms(lambda: F.conv1d(signs, tpl[:, None, :]), 20)
    main = cases["all_unlocked_float32"]
    return dict(
        name="acquire", route="cuda", source="xritdemod_tpu_torch/csrc/acquire.cu",
        replaces="xritdemod_tpu/models/receiver.py:164",
        replaces_kind="do_acq under lax.cond, the threshold and the lock select (:164-191): "
                      "an XLA program, no pl.pallas_call",
        max_abs_err=0.0, tolerance="exact", ms=main["ms"],
        ms_is="eager: 20 calls between two events, the wrapper's host time in it",
        device_ms=main["device_ms"], device_ms_is="timing.graph_ms: 20 calls as a CUDA graph",
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, steady_ms=cases["none_unlocked_float32"]["ms"],
        steady_device_ms=cases["none_unlocked_float32"]["device_ms"], channels=C, cases=cases,
        nearest_library_call=dict(call="F.conv1d of the window's signs with the templates "
                                  "(the counts only)", ms=near))


# (channels, samples) of the small blocks: one channel (the serial path's
# count), channels fewer than a warp, one more than a warp and 70; samples
# one less and one more than a multiple of the front end's 48-sample tile
# and of the clock's 32-row chunk, barely more than the 62-row filter
# history (64), and the clock's shortest block (NTAIL + 9 = 41).
RAGGED_SHAPES = ((70, 1003), (5, 64), (33, 95), (33, 97), (5, 47), (40, 49), (33, 1023),
                 (3, 1025), (64, 41), (1, 1023))


def ragged_signal(T: int, C: int, rnd) -> CF32:
    n = torch.arange(T, device=DEV)[:, None]
    carrier = 0.5 * torch.sign(torch.sin(1.4771 * n + torch.arange(C, device=DEV)))
    return CF32(carrier + rnd(T, C, scale=0.05), rnd(T, C, scale=0.05))


# K2's instances as (interpolator, chunk): the exact mmse and sinc forms and
# both block updates at the on-chip configuration's K.
SLOW_CLOCKS = {"clock": ("mmse", 0), "clock_sinc": ("sinc", 0), "clock_bu": ("mmse", 16),
               "clock_bu_sinc": ("sinc", 16)}


def check_slow_clock(demod: Demodulator, rnd) -> dict:
    """The clock kernel where channels of one group stand further apart than
    its shared-memory ring spans (every second channel starts 1500 samples
    ahead, past the mmse block update's ring of 1024 rows; omega at both
    ends of its range), for each instance of
    SLOW_CLOCKS: the lanes ahead must take their samples from device memory
    (counted), and the result must still be the plain version's (the sinc
    instances' and the mmse block update's bit for bit; the mmse block
    update through both of its entries, `(T, C)` and `(C, T)`)."""
    C, T = 40, 4000
    st = demod.init_state_batch(C).clock
    ii = st.ii.clone()
    ii[1::2] += 1500
    omega = st.omega.clone()
    lim = demod._clock.omega_relative_limit
    omega[::3] *= 1.0 + lim
    omega[1::3] *= 1.0 - lim
    st = st._replace(ii=ii, omega=omega)
    y = ragged_signal(T, C, rnd)
    S = T // 4 + 20
    out = {}
    yc = CF32(y.re.t().contiguous(), y.im.t().contiguous())
    for name, (interp, K) in SLOW_CLOCKS.items():
        p = clock_cuda.clock_recovery_block_plain_cl(y, st, demod._clock, S, interp, K)
        entries = [("(T, C)", clock_cuda.clock_recovery_block_kernel_batch_cl, y)]
        if name == "clock_bu":
            entries.append(("(C, T)", clock_cuda.clock_recovery_block_kernel_batch, yc))
        for entry, fn, x in entries:
            what = f"{name} outside its ring, {entry}"
            clock_cuda.out_of_ring_symbols(DEV, reset=True)
            k = fn(x, st, demod._clock, S, interp, K)
            taken = clock_cuda.out_of_ring_symbols(DEV, reset=True)
            err = max(clock_errs(k, p, what))
            if taken <= 0:
                fail(f"{what}: the kernel never read a symbol from device memory")
            if (interp == "sinc" or K) and err != 0.0:
                fail(f"{what} differs from its plain version: {err}")
            row = dict(symbols=int(k[1].sum()), symbols_from_device_memory=taken,
                       max_abs_err=err)
            if name in out:
                out[name]["channels_first"] = row
            else:
                out[name] = row
    return dict(shape=[C, T], **out)


# States a sinc clock may enter with: mu at 0, at the largest float below 1
# and at 1.0 (u = 0 on taps 3 and 4), outside [0, 1] (one step takes it
# back), and past the sine's large-argument threshold (pi mu > 105615).
SINC_EDGE_MU = (0.0, 1.0 - 2.0 ** -24, 1.0, -0.25, 1.5, 33619.25)


def check_sinc_clock(demod: Demodulator, rnd) -> dict:
    """K2's sinc instances (exact and block update at K = 16) against their
    plain versions bit for bit: from states whose mu is each of
    SINC_EDGE_MU (C = 6, T = 4000), and at one channel over two chained
    full-size blocks; then the branch-free taps of their unchecked steps
    against the exact forms at every float mu in [0, 1] (bit-equal at every
    mu an unchecked step can meet: 0 and [2^-23, 1])."""
    out = {}
    cases = (("mu_edges", len(SINC_EDGE_MU), 4000, torch.tensor(SINC_EDGE_MU, device=DEV)),
             ("one_channel", 1, BLOCK_LEN, None))
    for what, C, T, mu in cases:
        st = demod.init_state_batch(C).clock
        if mu is not None:
            st = st._replace(mu=mu.to(torch.float32))
        S = demod.num_slots if T == BLOCK_LEN else T // 4 + 20
        row = {}
        for name, K in (("clock_sinc", 0), ("clock_bu_sinc", 16)):
            kst = pst = st
            errs, nsym = [], 0
            for _ in range(2):
                y = ragged_signal(T, C, rnd)
                k = clock_cuda.clock_recovery_block_kernel_batch_cl(y, kst, demod._clock, S,
                                                                    "sinc", K)
                p = clock_cuda.clock_recovery_block_plain_cl(y, pst, demod._clock, S, "sinc", K)
                errs += clock_errs(k, p, f"{name}, {what}")
                nsym += int(k[1].sum())
                kst, pst = k[2], p[2]
            if max(errs) != 0.0:
                fail(f"{name}, {what}: differs from its plain version: {max(errs)}")
            row[name] = dict(max_abs_err=max(errs), symbols=nsym)
        out[what] = dict(shape=[C, T], **row)
    out["mu_edges"]["mu"] = list(SINC_EDGE_MU)
    taps = clock_cuda.sinc_tap_mismatches(DEV)
    if taps["trig"] or taps["taps_unchecked"]:
        fail(f"the sinc clock's branch-free taps differ from the exact ones: {taps}")
    out["branch_free_taps"] = taps
    return out


def check_trig() -> dict:
    """The shared-reduction sine and cosine of the Costas step against the
    CUDA library's `sinf` and `cosf`, bit for bit, over a dense sweep of the
    range a phase lives in and a sweep across the library's large-argument
    threshold."""
    out = {}
    for name, lo, hi, n in (("phase_range", -8.0, 8.0, 1 << 28),
                            ("across_threshold", -2.5e5, 2.5e5, 1 << 24)):
        bad = frontend_cuda.trig_mismatches(lo, hi, n, DEV)
        out[name] = dict(lo=lo, hi=hi, arguments=n, mismatches=bad)
        if bad:
            fail(f"sincos_exact differs from sinf/cosf in {bad} of {n} arguments in [{lo}, {hi}]")
    # The slab walks' own large-argument path, at every float past the threshold.
    t0 = time.perf_counter()
    bad = frontend_cuda.large_trig_mismatches(DEV)
    out["large_arguments_every_float"] = dict(
        abs_at_least=105615.0, arguments=2 * (frontend_cuda.LARGE_HI - frontend_cuda.LARGE_LO + 1),
        mismatches=bad, seconds=time.perf_counter() - t0)
    if bad:
        fail(f"sincos_large_regs differs from sinf/cosf at {bad} large arguments")
    return out


RING_EDGE_LENS = (72064, 40001)    # the fused receive's ring; an odd one (rows at every alignment)
RING_EDGE_S = (30983, 3001)        # new symbols a block: the main path's (odd), a short one


def ring_edge_inputs(L: int, S: int, E: int, gen) -> dict:
    """Channels on the edges of K4a's and K4b's realignment and of the
    in-place shift, at ring length L, S new symbols, frame E.  Append: fills
    at every residue mod 8 against counts at every residue mod 8 (S odd),
    none and one symbol, a block that fits exactly and one that overflows by
    a symbol.  Extract: pos 0 (drop = E) with 0-7 symbols kept, nothing kept
    (fill == pos + E), more kept than pos (nf > pos), fill == L, positions
    at every residue mod 8, and channels short of a frame (not ok)."""
    r8 = list(range(8))
    afill = [8 * 517 + r for r in r8] + [8 * 1001 + r for r in r8] + [0, 5, L - S, L - S + 1]
    an = [S - q for q in r8] + [S - 8 - q for q in r8[::-1]] + [0, 1, S, S]
    xcase = ([(0, E + r) for r in r8]                              # pos 0, drop = E
             + [(p, p + E) for p in (0, 3, 8, 1001)]               # nothing kept
             + [(5 + r, 5 + r + E + 20000 + 3 * r) for r in r8]    # nf > pos
             + [(3 * r, L) for r in r8]                            # fill == L
             + [(p, min(L, p + E + 4999)) for p in range(1, 9)]    # pos at every residue
             + [(0, E - 1), (0, 0), (7, 100), (40, E + 39)])       # not ok
    C = max(len(afill), len(xcase))
    pad = lambda v, x: (v + [x] * C)[:C]
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=DEV)
    return dict(afill=t(pad(afill, 0)), an=t(pad(an, 0)), new=torch.randn(
        (C, S), generator=gen).to(DEV), xpos=t(pad([p for p, _ in xcase], 0)),
        xfill=t(pad([f for _, f in xcase], 0)), vals=torch.randn((C, L), generator=gen).to(DEV))


def check_ring_edges(dtype) -> float:
    """K4a and K4b on `ring_edge_inputs` at both RING_EDGE_LENS, on `dtype`
    rings, against their plain versions: `torch.equal` on the ring (its
    bits), fill, flags and pop; a channel not ok keeps its row byte for
    byte; the extract hands back the tensor it was given.  Returns 0.0
    (any difference fails the run)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    E = K.CODED_FRAME_SIZE
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    same = lambda a, b: all(torch.equal(bits(x) if x.is_floating_point() else x,
                                        bits(y) if y.is_floating_point() else y)
                            for x, y in zip(a, b))
    for L, S in zip(RING_EDGE_LENS, RING_EDGE_S):
        d = ring_edge_inputs(L, S, E, gen)
        lane = torch.arange(L, device=DEV)[None, :]
        what = f"{str(dtype).replace('torch.', '')} ring edges, L = {L}, S = {S}"
        ring = torch.where(lane < d["afill"][:, None], d["vals"], 0.0).to(dtype)
        ka = ring_cuda.ring_append(ring.clone(), d["afill"], d["new"], d["an"])
        pa = ring_cuda.ring_append_plain(ring.clone(), d["afill"], d["new"], d["an"])
        if not same(ka, pa):
            fail(f"{what}: ring_append differs from its plain version")
        ring = torch.where(lane < d["xfill"][:, None], d["vals"], 0.0).to(dtype)
        kin = ring.clone()
        ke = ring_cuda.ring_extract(kin, d["xfill"], d["xpos"], E)
        pe = ring_cuda.ring_extract_plain(ring.clone(), d["xfill"], d["xpos"], E)
        if ke[0].data_ptr() != kin.data_ptr():
            fail(f"{what}: ring_extract did not hand back the ring it was given")
        if not same(ke, pe):
            fail(f"{what}: ring_extract differs from its plain version")
        held = ~ke[3]
        if not held.any() or not torch.equal(bits(ke[0][held]), bits(ring[held])):
            fail(f"{what}: a channel short of a frame was not left as it was")
    return 0.0


def check_ragged(rx: FusedReceiver) -> dict:
    """The kernels against their plain versions at small sizes that are no
    multiple of any tile (see RAGGED_SHAPES), where a wrong edge guard would
    show.  The front end, the clock and the standalone AGC and Costas stages
    run two chained blocks of every shape, each version carrying its own
    state.  Returns the largest differences."""
    demod = rx._demod
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rnd = lambda *shape, scale=0.3: scale * torch.randn(shape, generator=g, device=DEV)
    fe_params = (demod._agc, demod._rrc_taps, demod._costas)
    out = {"frontend": 0.0, "clock": 0.0, "clock_sinc": 0.0}
    for C, T in RAGGED_SHAPES:
        st = demod.init_state_batch(C)
        kfe = pfe = (st.agc_gain + rnd(C).abs(), CF32(rnd(C, 62), rnd(C, 62)), st.costas)
        kck = pck = ksc = psc = st.clock
        S = T // 4 + 20
        for _ in range(2):
            x = ragged_signal(T, C, rnd)
            k = frontend_cuda.demod_frontend(x, *kfe, *fe_params)
            p = frontend_cuda.demod_frontend_plain(x, *pfe, *fe_params)
            out["frontend"] = max(out["frontend"], *frontend_errs(k, p))
            kfe, pfe = k[1:], p[1:]
            kc = clock_cuda.clock_recovery_block_kernel_batch_cl(p[0], kck, demod._clock, S)
            pc = clock_cuda.clock_recovery_block_plain_cl(p[0], pck, demod._clock, S)
            out["clock"] = max(out["clock"], *clock_errs(kc, pc, f"ragged clock {C} x {T}"))
            kck, pck = kc[2], pc[2]
            kc = clock_cuda.clock_recovery_block_kernel_batch_cl(p[0], ksc, demod._clock, S, "sinc")
            pc = clock_cuda.clock_recovery_block_plain_cl(p[0], psc, demod._clock, S, "sinc")
            out["clock_sinc"] = max(out["clock_sinc"],
                                    *clock_errs(kc, pc, f"ragged clock (sinc) {C} x {T}"))
            ksc, psc = kc[2], pc[2]
    if out["clock_sinc"] != 0.0:
        fail(f"ragged clock (sinc) differs from its plain version: {out['clock_sinc']}")
    out["clock_outside_its_ring"] = check_slow_clock(demod, rnd)
    out["sinc_clock"] = check_sinc_clock(demod, rnd)
    out["sincos"] = check_trig()

    Cr, L, Sr, E = 5, 300, 77, 64
    cpu = torch.Generator().manual_seed(SEED + 4)
    fill = torch.tensor([0, 10, 150, 223, 290], dtype=torch.int32, device=DEV)
    ring = torch.where(torch.arange(L, device=DEV)[None, :] < fill[:, None], rnd(Cr, L), 0.0)
    new = rnd(Cr, Sr)
    n_new = torch.tensor([77, 0, 33, 77, 5], dtype=torch.int32, device=DEV)
    ka = ring_cuda.ring_append(ring.clone(), fill, new, n_new)
    pa = ring_cuda.ring_append_plain(ring.clone(), fill, new, n_new)
    pos = torch.randint(0, 40, (Cr,), generator=cpu).to(torch.int32).to(DEV)
    ke = ring_cuda.ring_extract(ka[0].clone(), ka[1], pos, E)
    pe = ring_cuda.ring_extract_plain(pa[0].clone(), pa[1], pos, E)
    if not all(torch.equal(a, b) for a, b in zip(ka + ke, pa + pe)):
        fail("ragged ring differs from its plain version")
    out["ring"] = check_ring_edges(torch.float32)

    # The standalone stages on (C, T), against `agc_block` / `costas_block`:
    # two chained blocks of every shape, each version carrying its own state;
    # the Costas loop takes the plain AGC's output.  Every second shape runs
    # the AGC without its max-gain clamp (max_gain 0: the kernel's other form).
    out["agc_block"] = out["costas_block"] = 0.0
    for k, (C, T) in enumerate(RAGGED_SHAPES):
        agc_p = demod._agc if k % 2 == 0 else demod._agc._replace(max_gain=0.0)
        kg = pg = demod.init_state_batch(C).agc_gain + rnd(C).abs()
        kc = pc = costas_op.CostasState(rnd(C, scale=2.0), rnd(C, scale=0.01))
        for _ in range(2):
            x = ragged_signal(T, C, rnd)
            xc = CF32(x.re.t().contiguous(), x.im.t().contiguous())
            ka, kg = stream_cuda.agc_block_kernel(xc, kg, agc_p)
            pa, pg = agc_op.agc_block(xc, pg, agc_p)
            out["agc_block"] = max(out["agc_block"], max_err(ka.re, pa.re),
                                   max_err(ka.im, pa.im), max_err(kg, pg))
            ky, kc = stream_cuda.costas_block_kernel(pa, kc, demod._costas)
            py, pc = costas_op.costas_block(pa, pc, demod._costas)
            out["costas_block"] = max(out["costas_block"], max_err(ky.re, py.re),
                                      max_err(ky.im, py.im), max_err(kc.phase, pc.phase),
                                      max_err(kc.freq, pc.freq))

    # The roll: ragged lengths, amounts 0, 1, L-1, beyond one turn, negative.
    for Cr_, L_ in ((5, 37), (3, 1000), (2, 2049)):
        words = torch.randint(-(1 << 31), (1 << 31) - 1, (Cr_, L_), generator=cpu).to(
            torch.int32).to(DEV)
        amt = torch.tensor([0, 1, L_ - 1, L_ + 3, -2][:Cr_], dtype=torch.int32, device=DEV)
        for dt in (torch.int32, torch.float32, torch.uint32):
            kr = roll_probe.barrel(words.view(dt), amt)
            if kr.dtype != dt or not torch.equal(
                    kr.view(torch.int32), roll_probe.barrel_plain(words, amt)):
                fail(f"ragged roll ({Cr_} x {L_}, {dt}) differs from its plain version")
    out["roll"] = 0.0

    out["viterbi"] = check_ragged_viterbi(rnd)
    slow = out["clock_outside_its_ring"]
    worst = max([v["max_abs_err"] if k == "viterbi" else v for k, v in out.items()
                 if k not in ("sincos", "sinc_clock", "clock_outside_its_ring")]
                + [slow[name]["max_abs_err"] for name in SLOW_CLOCKS])
    if not worst <= 1e-4:
        fail(f"ragged shapes: a kernel disagrees with its plain version: {out}")
    return out


def check_ragged_viterbi(rnd) -> dict:
    """K3 against its plain version, bit for bit: odd sizes at every lanes-
    per-window instance; window counts just below and at each threshold of
    `lanes_per_window`; the window shapes `decode_block` gives (16 windows
    per frame of 770 steps: 128 for 8 frames, 16 for one); tie-heavy inputs
    (all zeros, a constant, int8-quantized symbols as `quantize_symbols`
    makes them); one `viterbi_decode_kernel` call, one window a frame."""
    cases = []
    for lanes in viterbi_cuda.LANES:
        for nw, steps in ((7, 101), (33, 95), (3, K.FRAME_BITS + 32), (1, 1)):
            cases.append((f"{nw} x {steps}", rnd(nw, 2 * steps, scale=1.0), lanes))
    counts = {1, 2, 3, 128, 16}
    for least, _ in viterbi_cuda._LANES_RULE:
        counts |= {least - 1, least} if least > 0 else set()
    for nw in sorted(counts):
        cases.append((f"{nw} x 97", rnd(nw, 2 * 97, scale=1.0), None))
    steps = 770
    q = quantize_symbols(rnd(64, 2 * steps, scale=0.5)).to(torch.float32) / K.SYMBOL_SCALE
    for name, soft in (("zeros", torch.zeros((64, 2 * steps), device=DEV)),
                       ("constant", torch.full((64, 2 * steps), 0.25, device=DEV)),
                       ("int8-quantized", q)):
        for lanes in viterbi_cuda.LANES:
            cases.append((name, soft, lanes))
    lanes_run = set()
    for name, soft, lanes in cases:
        got = viterbi_cuda.decode_bits(soft, lanes=lanes)
        lanes_run.add(lanes or viterbi_cuda.lanes_per_window(soft.shape[0]))
        if not torch.equal(got, viterbi_cuda.decode_bits_plain(soft)):
            fail(f"ragged viterbi ({name}, {soft.shape[0]} windows, lanes {lanes}) differs "
                 "from its plain version")
    frames = rnd(3, 2 * (K.FRAME_BITS + 32), scale=1.0)
    kb, ke = viterbi_cuda.viterbi_decode_kernel(frames)
    pb, pe = viterbi_op.viterbi_decode(frames)
    if not (torch.equal(kb, pb) and torch.equal(ke, pe)):
        fail("viterbi_decode_kernel differs from viterbi_decode")
    return dict(cases=len(cases) + 1, lanes_run=sorted(lanes_run),
                window_counts=sorted(counts), max_abs_err=0.0)


def check_fir() -> dict:
    """`fir.fir_block` (a cuDNN convolution) on the card against the
    ascending-tap sum, with the RRC taps at decimation 1 and the decimating
    low-pass at decimation 2, the global TF32 flags untouched.  Also reports,
    without judging it, what the bare convolution gives under those flags."""
    C, T, tol = 256, 32768, 1e-5
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rnd = lambda *shape: 0.5 * torch.randn(shape, generator=g, device=DEV)
    x = CF32(rnd(C, T), rnd(C, T))
    out = dict(
        shape=[C, T], tolerance=f"atol {tol}",
        cudnn_allow_tf32=bool(torch.backends.cudnn.allow_tf32),
        matmul_allow_tf32=bool(torch.backends.cuda.matmul.allow_tf32),
    )
    cases = (
        ("rrc_dec1", 1, filters.rrc_taps(1.0, 1_250_000, K.LRIT_SYMBOL_RATE,
                                         K.LRIT_RRC_ALPHA, K.RRC_TAPS)),
        ("lowpass_dec2", 2, filters.lowpass_taps(1.0, 2_500_000, 625_000, 100e3)),
    )
    for name, dec, taps_np in cases:
        taps = torch.from_numpy(taps_np).to(DEV)
        N = int(taps.shape[0])
        hist = CF32(rnd(C, N - 1), rnd(C, N - 1))
        y, h = fir.fir_block(x, taps, hist, dec)
        errs, bare = [], []
        for yp, hp, xp, hin in ((y.re, h.re, x.re, hist.re), (y.im, h.im, x.im, hist.im)):
            ext = torch.cat([hin, xp], dim=-1)
            want = frontend_cuda._fir_cl(ext.t().contiguous(), taps, T)[::dec].t()
            if yp.shape != want.shape or not torch.equal(hp, ext[:, T:]):
                fail(f"fir {name}: wrong output shape or history")
            errs.append(max_err(yp, want))
            bare.append(max_err(
                F.conv1d(ext[:, None, :], taps[None, None, :], stride=dec)[:, 0, :], want))
        out[name] = dict(taps=N, max_abs_err=max(errs),
                         bare_conv1d_max_abs_err_under_global_flags=max(bare))
        if not max(errs) <= tol:
            fail(f"fir {name}: fir_block differs from the ascending-tap sum by {max(errs)}")
    return out


FIR_MM_SHAPE = (512, 1 << 17)     # the split path's RRC in `frontend_bench`


def check_fir_matmul() -> dict:
    """`fir.fir_block(method="matmul")` (the banded tap matrix, one cuBLAS
    float32 product a plane) against the convolution (cuDNN, the split
    path's RRC) and the ascending-tap sum in float64, at C = 512 x 131072
    with the RRC taps, the global TF32 flags untouched.  Fails where an
    output of the matmul form lies further from the float64 sum than
    gamma_N = N x 2^-24 times sum_k |t_k x_(n+k)| (the tolerance of
    `tests/test_torch_demod.py::test_banded_matmul_fir`: float32 products
    and sums in any order).  Both times, both errors, the bound."""
    C, T = FIR_MM_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    rnd = lambda *shape: 0.5 * torch.randn(shape, generator=g, device=DEV)
    taps = torch.from_numpy(filters.rrc_taps(1.0, 1_250_000, K.LRIT_SYMBOL_RATE,
                                             K.LRIT_RRC_ALPHA, K.RRC_TAPS)).to(DEV)
    N = int(taps.shape[0])
    x, hist = CF32(rnd(C, T), rnd(C, T)), CF32(rnd(C, N - 1), rnd(C, N - 1))
    ym, hm = fir.fir_block(x, taps, hist, method="matmul")
    yc, _ = fir.fir_block(x, taps, hist)
    gamma = N * 2.0 ** -24
    errs, ratio = dict(matmul=0.0, conv=0.0), dict(matmul=0.0, conv=0.0)
    for m, c, xp, hin in ((ym.re, yc.re, x.re, hist.re), (ym.im, yc.im, x.im, hist.im)):
        ext = torch.cat([hin, xp], dim=-1).t().contiguous().double()
        exact = frontend_cuda._fir_cl(ext, taps.double(), T).t()
        scale = frontend_cuda._fir_cl(ext.abs(), taps.double().abs(), T).t()
        del ext
        for name, y in (("matmul", m), ("conv", c)):
            d = (y.double() - exact).abs()
            errs[name] = max(errs[name], float(d.max()))
            ratio[name] = max(ratio[name], float((d / (gamma * scale)).max()))
        del exact, scale
    if not torch.equal(hm.re, torch.cat([hist.re, x.re], -1)[:, T:]):
        fail("fir matmul: wrong history")
    mm_ms = time_ms(lambda: fir.fir_block(x, taps, hist, method="matmul"), 5)
    conv_ms = time_ms(lambda: fir.fir_block(x, taps, hist), 5)
    # Two planes, each read once and written once, N products and sums an
    # output; the banded product also multiplies the band's zeros.
    bms, by = bound(2 * 2 * C * T * 4, 2 * C * T * N * 2)
    banded_flop = 2 * C * (T // 256) * (256 + N - 1) * 256 * 2
    if not ratio["matmul"] <= 1.0:
        fail(f"fir matmul: {ratio['matmul']} x its tolerance from the float64 sum")
    return dict(shape=[C, T], taps=N, matmul_ms=mm_ms, conv_ms=conv_ms, bound_ms=bms,
                bound_by=by, banded_product_gflop=banded_flop / 1e9,
                banded_product_f32_ms=banded_flop / PEAK_F32 * 1e3, matmul_max_abs_err=errs["matmul"], conv_max_abs_err=errs["conv"],
                matmul_err_over_tolerance=ratio["matmul"],
                conv_err_over_tolerance=ratio["conv"],
                tolerance="|y - float64 sum| <= N 2^-24 sum_k |t_k x_(n+k)|",
                matmul_precision=torch.get_float32_matmul_precision())


def _leaves(o) -> list:
    return [o] if isinstance(o, torch.Tensor) else [t for v in o for t in _leaves(v)]


def check_scan() -> dict:
    """The plain recurrences' CUDA graphs (`ops/scan.py`, through which
    every plain version below is held against its kernel) against the same
    loops run eagerly: Costas, AGC and the clock (mmse, sinc) over 8192
    samples of 128 channels, every output and carry bit-equal; each form's
    seconds."""
    C, T = 128, 8192
    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    xr, xi = (torch.randn((T, C), generator=g, device=DEV) for _ in range(2))
    d = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), T)
    x = CF32((0.3 * xr + torch.sign(xr)).t().contiguous(), (0.3 * xi).t().contiguous())
    clock = lambda interp: clock_recovery.clock_recovery_block_batch(
        x, d.init_state_batch(C).clock, d._clock, d.num_slots, interp)
    runs = dict(
        costas=lambda: costas_op.costas_steps(xr, xi, costas_op.costas_init((C,), DEV),
                                              d._costas),
        agc=lambda: agc_op.agc_gains(xr.abs(), torch.ones(C, device=DEV), d._agc),
        clock=lambda: clock("mmse"), clock_sinc=lambda: clock("sinc"))
    out, chunk = dict(shape=[C, T], chunk=scan_op.CHUNK), scan_op.CHUNK
    for name, fn in runs.items():
        got, sec = [], []
        for c in (0, chunk):
            scan_op.CHUNK = c
            try:
                t0 = time.perf_counter()
                got.append(_leaves(fn()))
                torch.cuda.synchronize()
                sec.append(time.perf_counter() - t0)
            finally:
                scan_op.CHUNK = chunk
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            fail(f"scan: the graphed {name} loop differs from the eager one")
        out[name] = dict(eager_s=sec[0], graph_s=sec[1])
    return out


def check_roll() -> dict:
    """The roll kernel at the probe's shape against its plain version and
    against `torch.gather`, exact, for the three dtypes; its time, the plain
    version's and `torch.gather`'s."""
    C, L = roll_probe.C, roll_probe.L
    g = torch.Generator().manual_seed(SEED + 6)
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (C, L), generator=g).to(torch.int32).to(DEV)
    amt = torch.randint(0, L, (C,), generator=g).to(torch.int32).to(DEV)
    amt[:3] = torch.tensor([0, 1, L - 1], dtype=torch.int32)
    want, plain_ms = once_ms(lambda: roll_probe.barrel_plain(words, amt))
    for dt in (torch.float32, torch.int32, torch.uint32):
        got = roll_probe.barrel(words.view(dt), amt)
        if got.dtype != dt or not torch.equal(got.view(torch.int32), want):
            fail(f"roll ({dt}) differs from its plain version")
    if not torch.equal(roll_probe.barrel_gather(words, amt), want):
        fail("roll: torch.gather differs from the plain version")
    x = words.view(torch.float32)
    ms = time_ms(lambda: roll_probe.barrel(x, amt), 20)
    lib_ms = time_ms(lambda: roll_probe.barrel_gather(x, amt), 20)
    bms, by = bound(2.0 * C * L * 4 + 4 * C, 0.0)
    return dict(
        name="roll", route="cuda", source="xritdemod_tpu_torch/csrc/roll.cu",
        replaces="tools/roll_probe.py:44", max_abs_err=0.0, tolerance="exact",
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        shape=[C, L],
    )


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def reset_counts() -> None:
    clock_cuda.out_of_ring_symbols(DEV, reset=True)
    timing.reset_launches()


read_counts = timing.launch_counts
FRONTEND_FORMS = timing.FRONTEND_FORMS


# Which kernels each path must launch, and none of the others.
MAIN_PATH_KERNELS = ("frontend", "clock", "viterbi", "ring_append", "ring_extract", "rs",
                     "acquire")
SPLIT_PATH_KERNELS = ("agc_block", "costas_block", "clock", "viterbi", "rs")
SINC_PATH_KERNELS = ("frontend", "clock_sinc", "viterbi", "ring_append", "ring_extract", "rs",
                     "acquire")


def check_counts(path: str, counts: dict, expected: tuple) -> None:
    for name, n in counts.items():
        if name in expected and n <= 0:
            fail(f"the {path} never launched the {name} kernel")
        if name not in expected and n != 0:
            fail(f"the {path} launched the {name} kernel {n} times; it is not on that path")


def quantize_block(x: CF32) -> np.ndarray:
    """`(C, T)` block -> `(C, 2T)` interleaved int8 I/Q, the wire format of
    `step_int8`, on the host and a slice of the channels at a time."""
    step = CHANNELS // 8
    return np.concatenate(
        [quantize_iq_s8(to_complex(x[c : c + step])) for c in range(0, CHANNELS, step)])


def clone_state(st):
    """A deep copy of a nested state (a step consumes its state's ring)."""
    if isinstance(st, torch.Tensor):
        return st.clone()
    return type(st)(*(clone_state(getattr(st, f)) for f in st._fields))


def same_state(a, b) -> bool:
    """Every tensor of two nested states (or FrameBatches) bit-equal."""
    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))
    kids = lambda t: [getattr(t, f) for f in t._fields] if hasattr(t, "_fields") else list(t)
    ka, kb = kids(a), kids(b)
    return len(ka) == len(kb) and all(same_state(x, y) for x, y in zip(ka, kb))


class no_host_sync:
    """Inside the block, a CUDA call that makes the host wait for the device
    (a read back, a copy from pageable memory, a synchronize) raises
    (`torch.cuda.set_sync_debug_mode("error")`); a raise fails `what`."""

    def __init__(self, what: str):
        self.what = what

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, kind, err, tb):
        torch.cuda.set_sync_debug_mode("default")
        if kind is RuntimeError and "synchroniz" in str(err):
            fail(f"{self.what}: a synchronising CUDA call in a steady step: {err}")
        return False


def main_path(rx: FusedReceiver, base: CF32, delays, vcdus, esn0_db: float,
              blocks: int = BLOCKS, int8_blocks: int = INT8_BLOCKS, label: str = "main_path",
              expected: tuple = MAIN_PATH_KERNELS, cl_block: int | None = None,
              per_block: list | None = None, fills: list | None = None):
    """`blocks` blocks through `step`, then `int8_blocks` through
    `step_int8` (its int8 block copied to the card before the step), every
    popped frame held against what was transmitted; the path must launch the
    `expected` kernels and no other.  Every block after the first (which
    copies the decoder's tables to the card) runs under `no_host_sync`: a
    steady step makes no synchronising call.  With `cl_block`, that block
    also goes through `step_cl`, as a transposed `(T, C)` copy from a copy of
    the same state, under `no_host_sync` too, which must give the same
    outputs and state as `step`, bit for bit.  A list passed as `per_block`
    receives the frames recovered in each block, one passed as `fills` the
    rings' fill counts after each block."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    by_counter = [
        {1000 * (s + 1) + i: v[i].tobytes() for i in range(len(v))}
        for s, v in enumerate(vcdus)
    ]
    sent = [set(d.values()) for d in by_counter]
    state = rx.init_state()
    frames = np.zeros(CHANNELS, np.int64)
    delivered = [set() for _ in range(STREAM_DECODERS)]   # counters, for split_path
    int8_frames = 0
    wrong = cold_wrong = partial = cold_partial = 0
    wrong_detail: list[dict] = []
    overflow = False
    ms = []                                  # per block, `step` and `step_int8` alike
    cl = None
    vit_err, rs_fixed = [], 0
    steady_checked: list = []                # steps run under `no_host_sync`
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for b in range(blocks + int8_blocks):
        int8 = b >= blocks
        x = make_block(base, delays, b, gen)
        if int8:
            x = torch.from_numpy(quantize_block(x)).to(DEV)
        was_locked = state.locked.cpu().numpy()
        if b == cl_block:
            x_cl, xT, st_cl = x, CF32(x.re.t().contiguous(), x.im.t().contiguous()), \
                clone_state(state)
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        if b:
            with no_host_sync(f"{label}: {'step_int8' if int8 else 'step'}, block {b}"):
                batch, ok, ovf, state = rx.step_int8(x, state) if int8 else rx.step(x, state)
            steady_checked.append("step_int8" if int8 else "step")
        else:
            batch, ok, ovf, state = rx.step(x, state)
        e.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(e))
        del x
        if b == cl_block:
            a.record()
            with no_host_sync(f"{label}: step_cl, block {b}"):
                out_cl = rx.step_cl(xT, st_cl)
            steady_checked.append("step_cl")
            e.record()
            torch.cuda.synchronize()
            cl = dict(block=b, ms=a.elapsed_time(e), step_ms=ms[-1],
                      equal=same_state(out_cl[0], batch) and same_state(out_cl[1:3], (ok, ovf))
                      and same_state(out_cl[3], state),
                      frames=int(out_cl[0].frame_ok.sum()))
            del out_cl
        overflow |= bool(ovf.any())
        if fills is not None:
            fills.append(state.fill.clone())
        fok = batch.frame_ok.cpu().numpy()
        vcid, ctr = batch.vcid.cpu().numpy(), batch.counter.cpu().numpy()
        vc = batch.vcdu.cpu().numpy()
        if vc.shape != (CHANNELS, rx.k, K.VCDU_SIZE) or ok.shape != (CHANNELS, rx.k):
            fail(f"step returned shapes {vc.shape}, {tuple(ok.shape)}")
        vit_err.append(float(batch.vit_errors[batch.frame_ok].float().mean()) if fok.any() else 0.0)
        rs_fixed += int(batch.rs_errors[batch.frame_ok].clamp(min=0).sum())
        # `frame_ok` also admits a frame with a failed Reed-Solomon block (the
        # reference's rule), whose bytes may be wrong.  Such a frame is not
        # compared; it is counted, allowed only while its channel acquires,
        # and bounded there together with the complemented frames below.
        whole = fok & (batch.rs_errors >= 0).all(-1).cpu().numpy()
        failed = fok & ~whole
        cold_partial += int((failed & ~was_locked[:, None]).sum())
        partial += int((failed & was_locked[:, None]).sum())
        if per_block is not None:
            per_block.append(int(whole.sum()))
        for c, i in zip(*np.nonzero(whole)):
            s = c % STREAMS
            want = by_counter[s].get(int(ctr[c, i]))
            if vcid[c, i] != s + 1 or want is None or want != vc[c, i].tobytes():
                # The frame a channel pops while it acquires from a cold start
                # can come out as the COMPLEMENT of what was sent: its sync
                # marker is read upright, the Costas loop then settles half a
                # cycle away, the code is transparent and the complement of a
                # Reed-Solomon codeword here is a codeword.  The reference
                # design has the same property (pinned on the CPU by
                # tests/test_torch_receiver.py).  Such frames are counted
                # apart and bounded; any other wrong frame, and any wrong
                # frame past acquisition, fails the run.
                inv = (~vc[c, i]).tobytes() in sent[s]
                if inv and not was_locked[c]:
                    cold_wrong += 1
                else:
                    wrong += 1
                if len(wrong_detail) < 12:
                    wrong_detail.append(dict(
                        block=b, channel=int(c), attempt=int(i), inverted=inv,
                        corr=float(batch.corr[c, i]), word=int(batch.word[c, i]),
                        sync_word=bytes(batch.sync_word[c, i].cpu().numpy()).hex(),
                        vit_errors=int(batch.vit_errors[c, i]),
                        rs_errors=batch.rs_errors[c, i].tolist(),
                        counter=int(ctr[c, i]), vcid=int(vcid[c, i]),
                    ))
            frames[c] += 1
            int8_frames += int8
            if c < STREAM_DECODERS and want is not None:
                delivered[c].add(int(ctr[c, i]))
    counts = read_counts()
    out_of_ring = clock_cuda.out_of_ring_symbols(DEV)
    peak = torch.cuda.max_memory_allocated()
    if cl is not None:
        # The demod half alone, device-bound, on the same block and state:
        # what channels-last ingest saves (the input transposes).  After the
        # counts: these launches only measure.
        dm, st0 = rx._demod, st_cl.demod
        cl["block_batch_ms"] = time_ms(lambda: dm.block_batch(x_cl, st0), 3)
        cl["block_batch_cl_ms"] = time_ms(lambda: dm.block_batch_cl(xT, st0), 3)
        del x_cl, xT, st_cl, st0
    locked = int(state.locked.sum())
    step_ms = float(np.mean(ms[1:blocks]))
    line = dict(
        config=f"DemodConfig.lrit(sample_rate=1250000, clock_interp="
               f"'{rx._demod.config.clock_interp}', frontend_block_update="
               f"{rx._demod.config.frontend_block_update}, frontend_precision="
               f"'{rx._demod.config.frontend_precision}') + DecoderConfig(mode='lrit'), "
               f"ring_dtype={str(rx.ring_dtype).replace('torch.', '')}",
        channels=CHANNELS, block_len=BLOCK_LEN, blocks=blocks, int8_blocks=int8_blocks,
        k=rx.k, ring_len=rx.ring_len, streams=STREAMS,
        noise_per_component=float(np.hypot(NOISE_STREAM, NOISE_CHANNEL)), esn0_db=esn0_db,
        frames_recovered=int(frames.sum()), frames_per_channel_min=int(frames.min()),
        frames_per_channel_max=int(frames.max()), frames_from_step_int8=int8_frames,
        wrong_frames=wrong,
        complemented_frames_during_acquisition=cold_wrong, wrong_detail=wrong_detail,
        frames_with_a_failed_rs_block=partial,
        frames_with_a_failed_rs_block_during_acquisition=cold_partial,
        mean_viterbi_corrections_per_frame=vit_err, rs_symbols_corrected=rs_fixed,
        locked_channels=locked, overflow=overflow,
        steady_blocks=blocks - 1, steady_ms_per_block=step_ms, ms_per_block=ms,
        msamples_per_s=CHANNELS * BLOCK_LEN / (step_ms * 1e-3) / 1e6,
        step_int8_ms_per_block=float(np.mean(ms[blocks:])) if int8_blocks else None,
        peak_memory_bytes=peak, launches=counts,
        clock_symbols_read_outside_the_ring=out_of_ring,
        step_cl=cl,
        steps_without_a_synchronising_call=sorted(set(steady_checked)),
    )
    say(label, **line)
    if cl_block is not None and not (cl and cl["equal"]):
        fail(f"{label}: step_cl on the transposed block {cl_block} differs from step")
    if wrong:
        fail(f"{label}: {wrong} recovered VCDUs differ from what was transmitted")
    if partial:
        fail(f"{label}: {partial} frames of locked channels passed sync with a failed "
             "Reed-Solomon block")
    if cold_wrong + cold_partial > CHANNELS // 100:
        fail(f"{label}: {cold_wrong} complemented and {cold_partial} partly decoded frames "
             f"during acquisition, more than {CHANNELS // 100}")
    if frames.min() < 3:
        fail(f"{label}: a channel recovered only {frames.min()} frames")
    if int8_blocks and int8_frames < CHANNELS // 2:
        fail(f"{label}: step_int8 recovered only {int8_frames} frames")
    if overflow:
        fail(f"{label}: a ring overflowed")
    if locked != CHANNELS:
        fail(f"{label}: only {locked} of {CHANNELS} channels locked at the end")
    if out_of_ring:
        fail(f"{label}: the clock kernel read {out_of_ring} symbols outside its ring")
    check_counts(label.replace("_", " "), counts, expected)
    return counts, state, ms, delivered



# --------------------------------------------------------------------------
# the split receive
# --------------------------------------------------------------------------

def split_path(cfg: DemodConfig, base: CF32, delays, vcdus, fused_delivered, smi: str,
               split_cfg: DemodConfig | None = None, label: str = "split_path",
               expected: tuple = SPLIT_PATH_KERNELS):
    """The capture's blocks through the split-path demodulator at full
    width, the first STREAM_DECODERS channels on through int8 symbols and a
    `StreamDecoder` each.  Held against the fused-path demodulator on the
    same blocks, against what was transmitted (every delivered VCDU bit for
    bit) and against what the fused receive delivered for the same channels.

    The two demodulators differ in the RRC's summation order only, by parts
    in 1e7; where a channel's clock phase sits on an edge of the 1/128
    interpolator table that picks the neighbouring tap row, and the lightly
    damped clock loop carries the offset for a while.  So the symbol STREAMS
    are held equal, not each block's cut of them: a symbol at a block's end
    may fall into the next block in one path (the running counts then differ
    by one until the other path does the same), and soft symbols are compared
    on the channels whose running counts agree before and after the block.

    With `split_cfg` (the block updates) the symbols are another function's,
    so they are not held against the fused path's; every other gate
    stands."""
    nblocks = BLOCKS + INT8_BLOCKS
    soft_tol = 1e-2
    compare = split_cfg is None
    if compare:
        split_cfg = DemodConfig.lrit(sample_rate=cfg.sample_rate, frontend_kernel="split")

    # The fused path's symbols first, parked on the host, so that the split
    # path below runs alone between the reset and the read of the counts.
    fused_out = []
    if compare:
        fused = Demodulator(cfg, BLOCK_LEN)
        fst = fused.init_state_batch(CHANNELS)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
        for b in range(nblocks):
            soft, valid, fst = fused.block_batch(make_block(base, delays, b, gen), fst)
            fused_out.append((soft.cpu(), valid.sum(-1).cpu()))
        del fused, fst, soft, valid
        torch.cuda.empty_cache()

    by_counter = [
        {1000 * (s + 1) + i: v[i].tobytes() for i in range(len(v))}
        for s, v in enumerate(vcdus)
    ]
    sent = [set(d.values()) for d in by_counter]
    demod = Demodulator(split_cfg, BLOCK_LEN)
    state = demod.init_state_batch(CHANNELS)
    decoders = [StreamDecoder(DecoderConfig(mode="lrit")) for _ in range(STREAM_DECODERS)]
    warm_s = decoders[0].warm_jit()
    got = [[] for _ in decoders]          # per stream: (counter, whole, bytes, vcid)
    batch_sizes: dict[int, int] = {}

    def collect(c: int, batches) -> None:
        for bt in batches:
            fok, rs = bt.frame_ok.cpu().numpy(), bt.rs_errors.cpu().numpy()
            ctr, vcid, vc = (a.cpu().numpy() for a in (bt.counter, bt.vcid, bt.vcdu))
            batch_sizes[len(fok)] = batch_sizes.get(len(fok), 0) + 1
            for i in np.nonzero(fok)[0]:
                got[c].append((int(ctr[i]), bool((rs[i] >= 0).all()), vc[i].tobytes(),
                               int(vcid[i])))

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    first_ms = steady_ms = decode_s = 0.0
    soft_err, soft_far, count_diff, shifted, max_lead = [], [], 0, 0, 0
    lead = torch.zeros(CHANNELS, dtype=torch.int64, device=DEV)   # split minus fused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for b in range(nblocks):
        x = make_block(base, delays, b, gen)
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        soft, valid, state = demod.block_batch(x, state)
        e.record()
        torch.cuda.synchronize()
        if b == 0:
            first_ms = a.elapsed_time(e)
        else:
            steady_ms += a.elapsed_time(e)
        del x
        n = valid.sum(-1)
        if compare:
            fsoft, fn = fused_out[b]
            fn = fn.to(DEV)
            count_diff += int((n != fn).sum())
            aligned = (lead == 0) & (n == fn)
            lead += n - fn
            max_lead = max(max_lead, int(lead.abs().max()))
            shifted += int((~aligned).sum())
            d = (soft - fsoft.to(DEV)).abs()[aligned]
            soft_err.append(float(d.max()))
            soft_far.append(float((d > 1e-5).float().mean()))
            del d
        q = quantize_symbols(soft[:STREAM_DECODERS]).cpu().numpy()
        v_host = valid[:STREAM_DECODERS].cpu().numpy()
        t0 = time.perf_counter()
        for c, sd in enumerate(decoders):
            collect(c, sd.push(q[c][v_host[c]]))
        decode_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    for c, sd in enumerate(decoders):
        collect(c, sd.flush())
    decode_s += time.perf_counter() - t0
    counts = read_counts()
    out_of_ring = clock_cuda.out_of_ring_symbols(DEV)
    peak = torch.cuda.max_memory_allocated()

    wrong = cold_wrong = partial = cold_partial = 0
    edge_start = edge_end = interior = 0
    frames = []
    for c, rows in enumerate(got):
        s = c % STREAMS
        good = set()
        for k, (ctr, whole, vc, vcid) in enumerate(rows):
            first = k == 0                 # the frame decoded before any verified
            if not whole:
                cold_partial += first
                partial += not first
                continue
            if vcid == s + 1 and by_counter[s].get(ctr) == vc:
                good.add(ctr)
            elif first and bytes(255 - v for v in vc) in sent[s]:
                cold_wrong += 1            # the cold-start complement, as in main_path
            else:
                wrong += 1
        frames.append(len(good))
        # Against the fused receive: equal inside the span both delivered;
        # they may differ at the ends (the first frame of a cold start, and
        # what the ring still held when the fused run stopped: the flush
        # decodes it).
        f = fused_delivered[c]
        if not f or not good:
            fail(f"stream {c}: nothing to compare with the fused receive")
        lo, hi = max(min(f), min(good)), min(max(f), max(good))
        diff = f ^ good
        edge_start = max(edge_start, sum(ctr < lo for ctr in diff))
        edge_end = max(edge_end, sum(ctr > hi for ctr in diff))
        interior += sum(lo <= ctr <= hi for ctr in diff)
    unlocked = sum(not sd._locked for sd in decoders)
    steady = steady_ms / (nblocks - 1)
    c = split_cfg
    say(label, card=smi,
        config=f"DemodConfig.lrit(sample_rate=1250000, frontend_kernel='split', "
               f"frontend_block_update={c.frontend_block_update}, clock_block_update="
               f"{c.clock_block_update}) -> quantize_symbols -> "
               "StreamDecoder(DecoderConfig(mode='lrit'))",
        channels=CHANNELS, block_len=BLOCK_LEN, blocks=nblocks,
        first_block_ms=first_ms, steady_ms_per_block=steady,
        msamples_per_s=CHANNELS * BLOCK_LEN / (steady * 1e-3) / 1e6,
        peak_memory_bytes=peak, launches=counts,
        clock_symbols_read_outside_the_ring=out_of_ring,
        channel_blocks=CHANNELS * nblocks,
        channel_blocks_whose_symbol_count_differs_from_the_fused_path=count_diff,
        channel_blocks_left_out_of_the_soft_comparison=shifted,
        largest_running_count_difference=max_lead,
        channels_whose_running_counts_differ_at_the_end=int((lead != 0).sum()),
        soft_tolerance=f"atol {soft_tol} against the fused path, on channels whose "
                       "running symbol counts agree" if compare else "not compared: "
                       "the block updates compute another function than the fused path",
        soft_max_abs_diff_per_block=soft_err, soft_share_beyond_1e_5_per_block=soft_far,
        stream_decoders=STREAM_DECODERS, frames_per_block=decoders[0].config.frames_per_block,
        warm_up_seconds=warm_s, decode_seconds=decode_s, batches_by_size=batch_sizes,
        frames_per_stream=frames, wrong_frames=wrong,
        complemented_first_frames=cold_wrong, frames_with_a_failed_rs_block=partial,
        first_frames_with_a_failed_rs_block=cold_partial,
        counters_differing_from_the_fused_receive=dict(
            most_before_the_common_span_in_a_stream=edge_start,
            most_after_it_in_a_stream=edge_end, inside_it_in_all=interior),
        resyncs=[sd.stats.resyncs for sd in decoders], streams_unlocked_at_the_end=unlocked)
    what = label.replace("_", " ")
    if compare and (max_lead > 1 or shifted > CHANNELS * nblocks // 1000):
        fail(f"split path: symbol counts stray from the fused path's: running difference "
             f"up to {max_lead}, {shifted} channel-blocks out of step")
    if compare and not max(soft_err) <= soft_tol:
        fail(f"split path: soft symbols differ from the fused path's by {max(soft_err)}")
    if wrong:
        fail(f"{what}: {wrong} delivered VCDUs differ from what was transmitted")
    if partial:
        fail(f"{what}: {partial} frames past a stream's first passed sync with a "
             "failed Reed-Solomon block")
    if cold_wrong + cold_partial > 1:
        fail(f"{what}: {cold_wrong} complemented and {cold_partial} partly decoded "
             "first frames, more than 1")
    if min(frames) < 8:
        fail(f"{what}: a stream delivered only {min(frames)} frames")
    if interior or edge_start > 1 or edge_end > 2:
        fail(f"{what}: delivered counters differ from the fused receive's: at most "
             f"{edge_start} before, {interior} inside, at most {edge_end} after the "
             "span both delivered")
    if unlocked:
        fail(f"{what}: {unlocked} streams ended unlocked")
    if out_of_ring:
        fail(f"{what}: the clock kernel read {out_of_ring} symbols outside its ring")
    check_counts(what, counts, expected)
    return counts, demod, state, steady

# --------------------------------------------------------------------------
# the JAX package's on-chip configuration: the block-update and bf16 forms
# --------------------------------------------------------------------------

ONCHIP_BLOCKS = 5          # `step`: one warm-up and four steady blocks; then one `step_int8`
ONCHIP_K = 8               # frontend_block_update, the JAX package's on-chip K
ONCHIP_CLOCK_K = 16        # clock_block_update of the split path's run
ONCHIP_FUSED_KERNELS = ("frontend_bk8_bf16", "clock", "viterbi", "ring_append_bf16",
                        "ring_extract_bf16", "rs", "acquire")
ONCHIP_SPLIT_KERNELS = ("agc_block", "costas_slab", "clock_bu", "viterbi", "rs")
ONCHIP_FORMS_KERNELS = ("frontend_bk8", "frontend_bf16", "clock", "clock_bu_sinc")
ONCHIP_FORMS_BLOCKS = 2
RAGGED_K_FRONT = (1, 4, 8, 16, 64)     # K1's and K6's slabs on the ragged shapes
RAGGED_K_STAGES = (1, 8, 64)           # K1's slab on one loop, float32 (bf16: ONCHIP_K)
RAGGED_K_COSTAS = RAGGED_K_FRONT + (3,)  # K6: and a slab that runs across its 128-sample tiles
# The slab kernels' shapes beyond RAGGED_SHAPES: one channel, 17 (neither a
# multiple of K1-slab's 16 channels a block nor of 32), 48 channels.
SLAB_SHAPES = RAGGED_SHAPES + ((1, 1000), (17, 480), (48, 96))
# K1's forms timed in turns on one input (the float32 forms of `block_k` 8:
# the exact form, the slab on both loops, on the AGC alone, on the Costas
# loop alone), and the rounds; the bf16 one-loop forms are launched beside.
K1_STAGE_FORMS = ("frontend", "frontend_bk8", "frontend_bk8_agc", "frontend_bk8_costas")
K1_STAGE_KERNELS = K1_STAGE_FORMS + ("frontend_bk8_agc_bf16", "frontend_bk8_costas_bf16")
K1_STAGE_ROUNDS = 5
# K2's chunks; the mmse block update's ring of 1024 rows holds a chunk's
# windows at each, so even 64, `clock_bench`'s largest (a chunk spans ~K x
# 4.3 rows), reads no symbol from device memory from ordinary states.
RAGGED_K_CLOCK = (1, 4, 16, 64)


def forms_path(cfg: DemodConfig, base: CF32, delays) -> dict:
    """The forms a user may select beside the on-chip configuration, through
    `Demodulator.block_batch` on the fused path: `frontend_block_update=8`
    in float32 with the sinc block-update clock, and `frontend_precision=
    "bf16"` with the exact front-end recursions, ONCHIP_FORMS_BLOCKS blocks
    each from a cold start.  Every channel's symbol count must lie within the
    clock's range of the block's length, every symbol finite."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    blocks = [make_block(base, delays, b, gen) for b in range(ONCHIP_FORMS_BLOCKS)]
    variants = {
        "bk8_f32_sinc_bu16": dataclasses.replace(
            cfg, frontend_block_update=ONCHIP_K, clock_block_update=ONCHIP_CLOCK_K,
            clock_interp="sinc"),
        "bf16": dataclasses.replace(cfg, frontend_precision="bf16"),
    }
    lo = BLOCK_LEN / cfg.sps * (1 - cfg.clock_omega_limit) - 8
    hi = BLOCK_LEN / cfg.sps * (1 + cfg.clock_omega_limit) + 8
    out = {}
    reset_counts()
    for name, c in variants.items():
        demod = Demodulator(c, BLOCK_LEN)
        st = demod.init_state_batch(CHANNELS)
        counts = []
        for x in blocks:
            soft, valid, st = demod.block_batch(x, st)
            n = valid.sum(-1)
            counts.append([int(n.min()), int(n.max())])
            if not bool(torch.isfinite(soft).all()):
                fail(f"onchip forms ({name}): a symbol is not finite")
        if counts[-1][0] < lo or counts[-1][1] > hi:
            fail(f"onchip forms ({name}): symbol counts {counts[-1]} outside [{lo}, {hi}]")
        out[name] = dict(symbols_per_channel_min_max=counts)
    out["launches"] = read_counts()
    check_counts("onchip forms path", out["launches"], ONCHIP_FORMS_KERNELS)
    return out


def ragged_len(T: int, K: int) -> int:
    """The longest multiple of K not past T (slab forms need whole slabs)."""
    return T - T % K


# Costas states at the edges the slab walks' fast paths rely on (loops.cuh):
# the wrap bounds +-2 pi and the floats just past them, +-0, freq at and past
# the clip bounds (with inputs of |x| ~ 1.2 the errors push it either way,
# so the clip binds), phases above the large-argument threshold 105615
# and between the slab walk's guard (65536) and it, and freq large enough
# that phase + k * freq leaves the guard within a slab.
EDGE_PHASE = (2 * np.pi, -2 * np.pi, np.nextafter(np.float32(2 * np.pi), np.float32(9)),
              -np.nextafter(np.float32(2 * np.pi), np.float32(9)), 0.0, -0.0, 3.0, 2e5, -2e5,
              105615.0, 7e4, 6.5e4, 12.0, -12.5, 1.0, 2.0)
EDGE_FREQ_SCALE = (1.0, -1.0, 1.5, -1.5, 0.0, 0.01, -0.01)   # of freq_max; then absolute:
EDGE_FREQ_ABS = (600.0, -600.0, 4096.0, 0.3, -0.3, 1e-3, 0.05, -0.05, 0.2)
EDGE_K = (1, 4, 8, 16, 64)
EDGE_MAX_GAIN = (0.0, 2.5, 4000.0)


def check_slab_edges(demod: Demodulator) -> dict:
    """K6's and K1's slab forms from edge states (EDGE_PHASE, the freqs
    above), two chained blocks each, against their plain versions; K1 also
    with the AGC's max-gain clamp binding in a slab's first row (gains
    starting at a max_gain of 2.5) and in mid-slab (gains climbing on
    small inputs), and with max_gain 0.  Every form at every EDGE_K, bit for
    bit (`max_abs_err` 0.0)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    rnd = lambda *shape, scale=0.3: scale * torch.randn(shape, generator=g, device=DEV)
    cp = demod._costas
    freq = [f * cp.freq_max for f in EDGE_FREQ_SCALE] + list(EDGE_FREQ_ABS)
    C = len(EDGE_PHASE)
    ph0 = torch.tensor([float(v) for v in EDGE_PHASE], dtype=torch.float32, device=DEV)
    fr0 = torch.tensor(freq[:C], dtype=torch.float32, device=DEV)
    out = {"costas_slab": 0.0, "frontend_forms": 0.0}
    for K in EDGE_K:
        kc = pc = costas_op.CostasState(ph0, fr0)
        for _ in range(2):
            xc = CF32(rnd(C, 1024, scale=1.2), rnd(C, 1024, scale=1.2))
            ky, kc2 = stream_cuda.costas_block_kernel(xc, kc, cp, K)
            py, pc2 = costas_op.costas_block_update(xc, pc, cp, K)
            out["costas_slab"] = max(out["costas_slab"], max_err(ky.re, py.re),
                                     max_err(ky.im, py.im), max_err(kc2.phase, pc2.phase),
                                     max_err(kc2.freq, pc2.freq))
            kc, pc = kc2, pc2
    for K in EDGE_K:
        T = 384 if 48 % K == 0 else 256
        for stages in ("both", "costas", "agc"):
            for mg in EDGE_MAX_GAIN:
                agc = demod._agc._replace(max_gain=mg)
                gain0 = torch.linspace(0.5, 3.0, C, device=DEV)
                gain0[:4] = 2.5                  # at the clamp (2.5) in a slab's first row
                kfe = pfe = (gain0, CF32(rnd(C, 62), rnd(C, 62)),
                             costas_op.CostasState(ph0, fr0))
                for _ in range(2):
                    x = CF32(rnd(T, C, scale=1e-3), rnd(T, C, scale=1e-3))
                    k = frontend_cuda.demod_frontend(x, *kfe, agc, demod._rrc_taps, cp,
                                                     block_k=K, block_stages=stages)
                    p = frontend_cuda.demod_frontend_plain(x, *pfe, agc, demod._rrc_taps, cp,
                                                           block_k=K, block_stages=stages)
                    out["frontend_forms"] = max(out["frontend_forms"], *frontend_errs(k, p))
                    kfe, pfe = k[1:], p[1:]
    if not max(out.values()) <= 0.0:
        fail(f"onchip: a slab form disagrees with its plain version from edge states: {out}")
    return out


# --------------------------------------------------------------------------
# every multi-warp kernel under load, and the paths
# --------------------------------------------------------------------------

# Every kernel of xritdemod_tpu_torch/csrc/ whose warps or blocks hand work
# to each other (mbarrier rings, cp.async loaders, named and cluster
# barriers, flags in shared memory) is held under load by the case families
# of tools/hazard_check.py (its FAMILIES: family -> kernel).  The kernels
# that need no load case, and why:
HAZARD_EXEMPT = {
    "viterbi_kernel": "one warp of 32 threads a block (__launch_bounds__(32)): no hand-off "
                      "between warps or blocks; `check_paths_under_load` runs it on both paths",
    "trig_check_kernel": "a check of the Costas step's sine and cosine, not a stage",
    "large_trig_check_kernel": "a check of the slab walks' large-argument sine, not a stage",
    "sinc_tap_check_kernel": "a check of the sinc clock's branch-free taps, not a stage",
    "probe": "sched_probe.cu: a probe of the warp schedulers, built by no path",
}
LOADS = ("compute", "memory")
LOAD_REPS = 24             # launches of a case under each load
LOAD_COPY_FLOATS = 1 << 28   # the memory-bound load copies a buffer of 1 GiB


class SideLoad:
    """Work on a side stream of the card while the block runs: `compute`,
    4096^2 float32 products (the SMs and their schedulers busy), or
    `memory`, repeated `copy_` of a 1 GiB buffer (device memory's
    bandwidth busy: the cp.async loaders then race its latency).  The
    block starts once the first batch is queued."""

    def __init__(self, kind: str):
        self.kind, self.stop, self.started = kind, threading.Event(), threading.Event()
        self.worker = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            if self.kind == "compute":
                a = torch.rand(4096, 4096, device=DEV)
                work = lambda: torch.tanh(a @ a, out=a)
            else:
                src = torch.ones(LOAD_COPY_FLOATS, device=DEV)
                dst = torch.empty_like(src)
                work = lambda: dst.copy_(src)
            while not self.stop.is_set():
                for _ in range(4):
                    work()
                self.started.set()
                side.synchronize()

    def __enter__(self):
        self.worker.start()
        if not self.started.wait(60):
            fail(f"the {self.kind} side load did not start")
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.worker.join(60)
        if exc[0] is None:
            torch.cuda.synchronize()


def check_under_load(cases: list) -> dict:
    """Each `(name, launch, plain)` case of `tools/hazard_check.cases`,
    launched LOAD_REPS times beside each of the LOADS, against one run of
    its plain version, bit for bit (every output and every carried state).
    A hazard between a block's warps shows only when their timing varies:
    an unordered write to K1's FIR ring changed 29 of 336 such launches on
    an H100 where the ragged checks on an idle card mostly passed.
    Every launch must be a kernel's (the wrappers' counts rise by one a
    launch); a launch that raises (a wait that never returns traps after 4 s,
    csrc/sync.cuh) fails the run like one that differs.  Returns, per case
    and load, the launches, those that differ, the index of the first
    differing output and the seconds."""
    t0 = time.perf_counter()
    families = {name.split("/")[0] for name, _, _ in cases}
    if families != set(hazard_check.FAMILIES):
        fail(f"under load: case families {sorted(families)} are not hazard_check.FAMILIES "
             f"{sorted(hazard_check.FAMILIES)}")
    # The plain versions first: their recurrences are captured as CUDA
    # graphs, which another stream's work would invalidate.
    plains = [plain() for _, _, plain in cases]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rows = {name: {} for name, _, _ in cases}
    launches = differing = 0
    for kind in LOADS:
        with SideLoad(kind):
            for (name, launch, _), want in zip(cases, plains):
                tc = time.perf_counter()
                before = sum(read_counts().values())
                bad, first = 0, None
                for _ in range(LOAD_REPS):
                    try:
                        got = launch()
                        i = hazard_check.first_difference(got, want)
                    except Exception as e:
                        fail(f"under load ({kind}): {name} raised {e!r}")
                    if i is not None:
                        bad += 1
                        first = i if first is None else first
                kernels = sum(read_counts().values()) - before
                if kernels != LOAD_REPS:
                    fail(f"under load ({kind}): {name} launched {kernels} kernels in "
                         f"{LOAD_REPS} runs, not one a run")
                rows[name][kind] = dict(launches=LOAD_REPS, differing=bad, first_output=first,
                                        seconds=round(time.perf_counter() - tc, 4))
                launches += LOAD_REPS
                differing += bad
    out = dict(cases=len(cases), families={f: sum(n.startswith(f + "/") for n in rows)
                                            for f in sorted(families)},
               reps=LOAD_REPS, loads=LOADS, launches=launches, differing=differing,
               plain_seconds=plain_s, seconds=time.perf_counter() - t0, by_case=rows)
    worst = [f"{n} ({k}: {r['differing']} of {r['launches']}, output {r['first_output']})"
             for n, row in rows.items() for k, r in row.items() if r["differing"]]
    if worst:
        say("under_load_failed", kernels=out)       # every case's counts, then the failure
        fail(f"under load: {differing} of {launches} launches differ from their plain "
             f"versions: {worst[:8]}")
    return out


PATH_LOAD_C = 64
PATH_LOAD_T = 1 << 15
PATH_LOAD_STEPS = 3
PATH_LOAD_DECODERS = 8


def check_paths_under_load(cfg: DemodConfig, dcfg: DecoderConfig, base: CF32, delays) -> dict:
    """The whole receive, kernels and the host logic between them, idle and
    beside each of the LOADS, bit for bit: PATH_LOAD_STEPS blocks of
    `FusedReceiver.step` at C = 64 x 2^15 from one state (every FrameBatch
    field, ok, overflow and every leaf of the final RxState), and the same
    blocks through the split `block_batch` with PATH_LOAD_DECODERS channels
    on through `StreamDecoder`s (soft symbols, valid, every FrameBatch and
    the final state).  Covers K3 and the library calls too."""
    t0 = time.perf_counter()
    C, T = PATH_LOAD_C, PATH_LOAD_T
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    blocks = [make_block(base, delays[:C], b, gen, length=T) for b in range(PATH_LOAD_STEPS)]
    rx = FusedReceiver(cfg, dcfg, channels=C, block_len=T)
    rx_st = rx.init_state()
    demod = Demodulator(dataclasses.replace(cfg, frontend_kernel="split"), T)
    split_st = demod.init_state_batch(C)

    frames = []

    def fused() -> list:
        st, out, n = clone_state(rx_st), [], 0
        for x in blocks:
            batch, ok, ovf, st = rx.step(x, st)
            out += hazard_check.flat((batch, ok, ovf))
            n += int(ok.sum())
        frames.append(n)
        return out + hazard_check.flat(st)

    def split() -> list:
        st, out = clone_state(split_st), []
        decoders = [StreamDecoder(DecoderConfig(mode="lrit")) for _ in range(PATH_LOAD_DECODERS)]
        for x in blocks:
            soft, valid, st = demod.block_batch(x, st)
            out += [soft, valid]
            q = quantize_symbols(soft[:PATH_LOAD_DECODERS]).cpu().numpy()
            v = valid[:PATH_LOAD_DECODERS].cpu().numpy()
            for c, sd in enumerate(decoders):
                out += hazard_check.flat(sd.push(q[c][v[c]]))
        for sd in decoders:
            out += hazard_check.flat(sd.flush())
        return out + hazard_check.flat(st)

    out = {}
    for name, run in (("fused_step", fused), ("split_block_batch", split)):
        idle = run()
        torch.cuda.synchronize()
        row = dict(outputs=len(idle))
        for kind in LOADS:
            with SideLoad(kind):
                i = hazard_check.first_difference(run(), idle)
            row[kind] = dict(first_differing_output=i)
            if i is not None:
                fail(f"paths under load: {name} beside the {kind} load differs from its idle "
                     f"run at output {i} of {len(idle)}")
        out[name] = row
    out["fused_step"]["frames_each_run"] = frames
    return dict(shape=[C, T], steps=PATH_LOAD_STEPS, seconds=time.perf_counter() - t0, **out)


def under_load_phase(cfg: DemodConfig, dcfg: DecoderConfig, base: CF32, delays) -> dict:
    """`check_under_load` over every case of `tools/hazard_check`, then
    `check_paths_under_load`."""
    t0 = time.perf_counter()
    kernels = check_under_load(hazard_check.cases())
    torch.cuda.empty_cache()
    paths = check_paths_under_load(cfg, dcfg, base, delays)
    torch.cuda.empty_cache()
    return dict(kernels=kernels, paths=paths, seconds=time.perf_counter() - t0)


def check_onchip_ragged(demod: Demodulator) -> dict:
    """The new instances against their plain versions on RAGGED_SHAPES (each
    block length cut to a whole number of slabs for K1 and K6), two chained
    blocks, each version with its own state: K1 with the slabs of
    RAGGED_K_FRONT (float32, and bf16 at K = 8) and bf16 at K = 0; K6 with
    RAGGED_K_FRONT; K2's block update at RAGGED_K_CLOCK, both interpolators
    (the mmse one through both entries, `(T, C)` and `(C, T)`, and from
    these ordinary states with no symbol read from device memory); the bf16
    rings.  At K = 1 K6 and K2 must equal their exact instances bit for
    bit."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rnd = lambda *shape, scale=0.3: scale * torch.randn(shape, generator=g, device=DEV)
    fe = (demod._agc, demod._rrc_taps, demod._costas)
    out = {"frontend_forms": 0.0, "frontend_stage_forms": 0.0, "costas_slab": 0.0,
           "clock_bu": 0.0, "clock_bu_sinc": 0.0, "k1_equal_to_exact": True}
    from_memory = {"clock_bu": 0, "clock_bu_sinc": 0}
    forms = [(bk, "both", "highest") for bk in RAGGED_K_FRONT] + [
        (ONCHIP_K, "both", "bf16"), (0, "both", "bf16")] + [
        (bk, stages, prec) for stages in ("agc", "costas")
        for bk, prec in [(k, "highest") for k in RAGGED_K_STAGES] + [(ONCHIP_K, "bf16")]]
    stage_s = 0.0
    for C, T in SLAB_SHAPES:
        st = demod.init_state_batch(C)
        for bk, stages, prec in forms:
            Tk = ragged_len(T, max(bk, 1))
            if Tk < max(bk, 1):
                continue
            key = "frontend_forms" if stages == "both" else "frontend_stage_forms"
            t0 = time.perf_counter()
            kfe = pfe = (st.agc_gain + rnd(C).abs(), CF32(rnd(C, 62), rnd(C, 62)), st.costas)
            for _ in range(2):
                x = ragged_signal(Tk, C, rnd)
                k = frontend_cuda.demod_frontend(x, *kfe, *fe, block_k=bk, precision=prec,
                                                 block_stages=stages)
                p = frontend_cuda.demod_frontend_plain(x, *pfe, *fe, block_k=bk, precision=prec,
                                                       block_stages=stages)
                out[key] = max(out[key], *frontend_errs(k, p))
                if bk == 1 and stages == "costas":
                    # The Costas slab at K = 1 is the exact loop: the exact instance.
                    e = frontend_cuda.demod_frontend(x, *kfe, *fe, precision=prec)
                    out["k1_equal_to_exact"] &= all(
                        torch.equal(a, b) for a, b in zip(hazard_check.flat(e), hazard_check.flat(k)))
                kfe, pfe = k[1:], p[1:]
            if stages != "both":
                stage_s += time.perf_counter() - t0
        for K in RAGGED_K_COSTAS:
            Tk = ragged_len(T, K)
            if Tk < K:
                continue
            kc = pc = costas_op.CostasState(rnd(C, scale=2.0), rnd(C, scale=0.01))
            for _ in range(2):
                x = ragged_signal(Tk, C, rnd)
                xc = CF32(x.re.t().contiguous(), x.im.t().contiguous())
                ky, kc2 = stream_cuda.costas_block_kernel(xc, kc, demod._costas, K)
                py, pc2 = costas_op.costas_block_update(xc, pc, demod._costas, K)
                out["costas_slab"] = max(out["costas_slab"], max_err(ky.re, py.re),
                                         max_err(ky.im, py.im), max_err(kc2.phase, pc2.phase),
                                         max_err(kc2.freq, pc2.freq))
                if K == 1:
                    ey, ec = stream_cuda.costas_block_kernel(xc, kc, demod._costas)
                    out["k1_equal_to_exact"] &= bool(
                        torch.equal(ey.re, ky.re) and torch.equal(ey.im, ky.im)
                        and torch.equal(ec.phase, kc2.phase) and torch.equal(ec.freq, kc2.freq))
                kc, pc = kc2, pc2
        S = T // 4 + 20
        for interp, key in (("mmse", "clock_bu"), ("sinc", "clock_bu_sinc")):
            for K in RAGGED_K_CLOCK:
                kc = ct = pc = st.clock
                for _ in range(2):
                    y = ragged_signal(T, C, rnd)
                    clock_cuda.out_of_ring_symbols(DEV, reset=True)
                    k = clock_cuda.clock_recovery_block_kernel_batch_cl(
                        y, kc, demod._clock, S, interp, K)
                    runs = [(k, kc, "(T, C)")]
                    if interp == "mmse":
                        yc = CF32(y.re.t().contiguous(), y.im.t().contiguous())
                        runs.append((clock_cuda.clock_recovery_block_kernel_batch(
                            yc, ct, demod._clock, S, interp, K), ct, "(C, T)"))
                    from_memory[key] += clock_cuda.out_of_ring_symbols(DEV, reset=True)
                    p = clock_cuda.clock_recovery_block_plain_cl(y, pc, demod._clock, S, interp, K)
                    for r, r_st, entry in runs:
                        out[key] = max(out[key], *clock_errs(
                            r, p, f"ragged {key} K={K} {C} x {T}, {entry}"))
                        if K == 1:
                            e = clock_cuda.clock_recovery_block_kernel_batch_cl(
                                y, r_st, demod._clock, S, interp)
                            out["k1_equal_to_exact"] &= bool(
                                torch.equal(e[0].re, r[0].re) and torch.equal(e[1], r[1])
                                and same_state(e[2], r[2]))
                    kc, pc = k[2], p[2]
                    ct = runs[-1][0][2]
    Cr, L, Sr, E = 5, 300, 77, 64
    fill = torch.tensor([0, 10, 150, 223, 290], dtype=torch.int32, device=DEV)
    ring = torch.where(torch.arange(L, device=DEV)[None, :] < fill[:, None], rnd(Cr, L),
                       0.0).to(torch.bfloat16)
    new = rnd(Cr, Sr)
    n_new = torch.tensor([77, 0, 33, 77, 5], dtype=torch.int32, device=DEV)
    ka = ring_cuda.ring_append(ring.clone(), fill, new, n_new)
    pa = ring_cuda.ring_append_plain(ring.clone(), fill, new, n_new)
    pos = torch.tensor([3, 0, 17, 40, 2], dtype=torch.int32, device=DEV)
    ke = ring_cuda.ring_extract(ka[0].clone(), ka[1], pos, E)
    pe = ring_cuda.ring_extract_plain(pa[0].clone(), pa[1], pos, E)
    if not all(torch.equal(a, b) for a, b in zip(ka + ke, pa + pe)):
        fail("onchip: the ragged bf16 ring differs from its plain version")
    out["ring_bf16"] = check_ring_edges(torch.bfloat16)
    worst = max(v for k, v in out.items() if k != "k1_equal_to_exact")
    out["frontend_stage_forms_seconds"] = stage_s
    out["clock_symbols_from_device_memory"] = from_memory
    if not worst <= 0.0 or not out["k1_equal_to_exact"]:
        fail(f"onchip ragged shapes: a new instance disagrees with its plain version or, at "
             f"K = 1, with its exact instance: {out}")
    if from_memory["clock_bu"]:
        fail(f"onchip ragged shapes: the mmse block update read {from_memory['clock_bu']} "
             f"symbols from device memory at K in {RAGGED_K_CLOCK}; its ring holds them all")
    return out


def k1_stage_path(demod: Demodulator, x: CF32) -> tuple[dict, dict]:
    """K1's forms as a user calls them (`frontend_cuda.demod_frontend(...,
    block_k=8, block_stages=...)`, as the JAX package's own probe of the
    one-loop forms does), on one full-size block from the initial state:
    the four float32 forms of K1_STAGE_FORMS timed in turns, one launch
    each, K1_STAGE_ROUNDS rounds (the order rotated each round), then the
    bf16 one-loop forms once.  The launches are counted apart from every
    other run: this is the path of the one-loop forms.  Returns (the ms of
    every round and the median of each form, the launches)."""
    C, T = x.re.shape
    xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    st = demod.init_state_batch(C)
    args = (xT, st.agc_gain, st.rrc_hist, st.costas, demod._agc, demod._rrc_taps,
            demod._costas)
    forms = {name: dict(block_k=bk, block_stages=stages, precision=prec)
             for name, (bk, stages, prec) in FRONTEND_FORMS.items()}
    forms["frontend"] = dict(block_k=0, block_stages="both", precision="highest")
    torch.cuda.synchronize()
    reset_counts()
    ms = {name: [] for name in K1_STAGE_FORMS}
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(K1_STAGE_ROUNDS):
        order = K1_STAGE_FORMS[r % 4:] + K1_STAGE_FORMS[:r % 4]
        for name in order:
            a.record()
            frontend_cuda.demod_frontend(*args, **forms[name])
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b))
    for name in K1_STAGE_KERNELS[len(K1_STAGE_FORMS):]:
        frontend_cuda.demod_frontend(*args, **forms[name])
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("K1 one-loop forms' path", counts, K1_STAGE_KERNELS)
    # The first round also loads each instance: the medians leave it out.
    med = {name: float(np.median(v[1:])) for name, v in ms.items()}
    return dict(shape=[C, T], rounds=K1_STAGE_ROUNDS, ms_each_round=ms, median_ms=med,
                both_minus_exact_ms=med["frontend_bk8"] - med["frontend"],
                agc_slab_minus_exact_ms=med["frontend_bk8_agc"] - med["frontend"],
                costas_slab_minus_exact_ms=med["frontend_bk8_costas"] - med["frontend"],
                launches=counts), counts


def check_onchip_kernels(rx: FusedReceiver, x0: CF32, x1: CF32, exact: dict) -> list[dict]:
    """Each new instance against its plain version at its path's shapes
    (C = 2048, T = 131072), over the capture's first two blocks chained, each
    version carrying its own state; `exact` holds the exact instances' rows
    of `check_kernels`, whose times stand beside the new ones'.  K1's forms
    through the channels-last entry (bk8-bf16 is (a)'s, bk8 and bf16 on the
    same inputs); K2's block update at K = 16 through the channels-last entry
    on K1-bk8-bf16's output ((a)'s shape) and through the `(C, T)` entry on
    K6-bk8's ((b)'s shape; sinc on the same); K6-bk8 on the split path's
    filter output (K5, then the RRC); the bf16 rings at (a)'s ring length.
    At the path's shape K6 and K2 at K = 1 equal their exact instances."""
    demod = rx._demod
    C, T = x0.re.shape
    st = demod.init_state_batch(C)
    fe = (demod._agc, demod._rrc_taps, demod._costas)
    N = int(demod._rrc_taps.shape[0])
    S = demod.num_slots
    rows = []
    xT = [CF32(x.re.t().contiguous(), x.im.t().contiguous()) for x in (x0, x1)]
    fe_bound = bound(4 * (4 * T * C + 4 * C * (N - 1) + 6 * C), T * C * (4 * N + 40))
    y_bk8_bf16 = None
    for name, (bk, stages, prec) in FRONTEND_FORMS.items():
        kst = pst = (st.agc_gain, st.rrc_hist, st.costas)
        errs, plain_ms = [], None
        form = dict(block_k=bk, precision=prec, block_stages=stages)
        for b, x in enumerate(xT):
            k = frontend_cuda.demod_frontend(x, *kst, *fe, **form)
            torch.cuda.synchronize()
            p, pms = once_ms(lambda: frontend_cuda.demod_frontend_plain(x, *pst, *fe, **form))
            errs += frontend_errs(k, p)
            if b == 1:
                args = (x, *kst, *fe)
                ms = time_ms(lambda: frontend_cuda.demod_frontend(*args, **form), 3)
                if PROFILE and prec == "highest":
                    stage_clocks("frontend", frontend_cuda.roles(bk, stages), lambda: frontend_cuda.
                                 demod_frontend(*args, **form), name)
                plain_ms = pms
            if name == "frontend_bk8_bf16":
                y_bk8_bf16 = (y_bk8_bf16 or []) + [p[0]]
            kst, pst = k[1:], p[1:]
        if not max(errs) <= 0.0:
            fail(f"onchip: {name} disagrees with its plain version: {errs}")
        lines = {"both": "87-145, 166-237", "agc": "87-145, 166-192, 238-258",
                 "costas": "146-237"}[stages]
        rows.append(dict(
            name=name, route="cuda", source="xritdemod_tpu_torch/csrc/frontend.cu",
            replaces="xritdemod_tpu/ops/frontend_pallas.py:335",
            form=f"block_k={bk}, block_stages='{stages}', precision='{prec}' "
                 f"(frontend_pallas.py:{lines})",
            max_abs_err=max(errs), tolerance="exact, two chained blocks", ms=ms,
            exact_ms=exact["frontend"]["ms"], plain_ms=plain_ms, bound_ms=fe_bound[0],
            bound_by=fe_bound[1], library_ms=None))
        del k, p, kst, pst

    def clock_row(name, ys, entry, interp, chunk, plain_entry, form):
        kc = pc = st.clock
        errs = []
        for b, y in enumerate(ys):
            k = entry(y, kc, demod._clock, S, interp, chunk)
            torch.cuda.synchronize()
            p, pms = once_ms(lambda: plain_entry(y, pc, demod._clock, S, interp, chunk))
            errs += clock_errs(k, p, f"onchip: {name}, block {b}")
            if b == 1:
                args = (y, kc, demod._clock, S, interp, chunk)
                ms = time_ms(lambda: entry(*args), 3)
                if PROFILE:
                    stage_clocks("clock", clock_cuda.ROLES[name], lambda: entry(*args),
                                 f"{name} {form}")
                e = entry(y, kc, demod._clock, S, interp, 1)
                one = entry(y, kc, demod._clock, S, interp)
                if not (torch.equal(e[0].re, one[0].re) and torch.equal(e[1], one[1])
                        and same_state(e[2], one[2])):
                    fail(f"onchip: {name} at K = 1 differs from the exact instance")
                nsym = int(k[1].sum())
            kc, pc = k[2], p[2]
        if not max(errs) <= 0.0:
            fail(f"onchip: {name} disagrees with its plain version: {errs}")
        per = 70.0 if interp == "mmse" else 190.0
        bms, by = bound(4 * (2 * (T + NTAIL) * C + 2 * C * S + 30 * C) + C * S, nsym * per)
        return dict(name=name, route="cuda", source="xritdemod_tpu_torch/csrc/clock.cu",
                    replaces="xritdemod_tpu/ops/clock_pallas.py:539", form=form,
                    max_abs_err=max(errs), tolerance="exact, equal valid masks and positions, "
                    "two chained blocks; K = 1 equal to the exact instance", ms=ms,
                    exact_ms=exact["clock" if interp == "mmse" else "clock_sinc"]["ms"],
                    plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None, symbols=nsym)

    cl_row = clock_row("clock_bu", y_bk8_bf16, clock_cuda.clock_recovery_block_kernel_batch_cl,
                       "mmse", ONCHIP_CLOCK_K, clock_cuda.clock_recovery_block_plain_cl,
                       f"block_update=True, chunk={ONCHIP_CLOCK_K}, mmse, channels-last "
                       "(clock_pallas.py:232-335)")
    del y_bk8_bf16

    # K6-bk8 on the split path's filter output: K5, then the RRC.
    g, h = st.agc_gain, st.rrc_hist
    fir_out = []
    for x in (x0, x1):
        a, g = stream_cuda.agc_block_kernel(x, g, demod._agc)
        f, h = fir.fir_block(a, demod._rrc_taps, h)
        fir_out.append(f)
        del a
    kc = pc = st.costas
    errs, ys = [], []
    for b, f in enumerate(fir_out):
        ky, kc2 = stream_cuda.costas_block_kernel(f, kc, demod._costas, ONCHIP_K)
        torch.cuda.synchronize()
        (py, pc2), pms = once_ms(lambda: costas_op.costas_block_update(
            f, pc, demod._costas, ONCHIP_K))
        errs += [max_err(ky.re, py.re), max_err(ky.im, py.im), max_err(kc2.phase, pc2.phase),
                 max_err(kc2.freq, pc2.freq)]
        if b == 1:
            args = (f, kc, demod._costas)
            ms = time_ms(lambda: stream_cuda.costas_block_kernel(*args, ONCHIP_K), 3)
            if PROFILE:
                stage_clocks("stream", stream_cuda.ROLES["costas_slab"],
                             lambda: stream_cuda.costas_block_kernel(*args, ONCHIP_K),
                             "costas_slab")
            e1 = stream_cuda.costas_block_kernel(*args, 1)
            ex = stream_cuda.costas_block_kernel(*args)
            if not (torch.equal(e1[0].re, ex[0].re) and torch.equal(e1[0].im, ex[0].im)
                    and same_state(e1[1], ex[1])):
                fail("onchip: costas_slab at K = 1 differs from the exact instance")
            plain_ms = pms
        # Contiguous (C, T), as K6 leaves it for the clock (the plain loop
        # returns a view of its time-major buffers).
        ys.append(CF32(py.re.contiguous(), py.im.contiguous()))
        kc, pc = kc2, pc2
    if not max(errs) <= 0.0:
        fail(f"onchip: costas_slab disagrees with its plain version: {errs}")
    bms, by = bound(4 * (4 * T * C + 4 * C), T * C * 40.0)
    rows.append(dict(
        name="costas_slab", route="cuda", source="xritdemod_tpu_torch/csrc/stream.cu",
        replaces="xritdemod_tpu/ops/stream_pallas.py:187",
        form=f"the slab update, chunk={ONCHIP_K} (costas.py:114-186; the fused kernel's "
             "block_k, frontend_pallas.py:193-225), (C, T)",
        max_abs_err=max(errs), tolerance="exact, phase and freq included, two chained "
        "blocks; K = 1 equal to the exact instance", ms=ms,
        exact_ms=exact["costas_block"]["ms"], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None))
    del fir_out
    rows.append(cl_row)
    # The (C, T) entry's plain version.
    def ct_plain(y, st_, prm, slots, interp, chunk):
        return clock_recovery.clock_recovery_block_update_batch(y, st_, prm, slots, chunk, interp)

    # The sinc block update's (C, T) entry transposes its input: on views of
    # time-major copies, made here, that copy costs nothing in its time.
    ys_tm = [CF32(y.re.t().contiguous().t(), y.im.t().contiguous().t()) for y in ys]
    rows.append(clock_row(
        "clock_bu_sinc", ys_tm, clock_cuda.clock_recovery_block_kernel_batch, "sinc",
        ONCHIP_CLOCK_K, ct_plain,
        f"block_update=True, chunk={ONCHIP_CLOCK_K}, interp_mode='sinc', (C, T)"))
    ct_mmse = clock_row(
        "clock_bu", ys, clock_cuda.clock_recovery_block_kernel_batch, "mmse", ONCHIP_CLOCK_K,
        ct_plain, "(C, T)")
    cl_row["split_shape"] = dict(entry="(C, T)", max_abs_err=ct_mmse["max_abs_err"],
                                 ms=ct_mmse["ms"], symbols=ct_mmse["symbols"])
    del ys, ys_tm

    # The bf16 rings at (a)'s length: the clock's symbols onto rings with
    # random fills, a few set to overflow; then pops at random positions.
    gcpu = torch.Generator(device="cpu").manual_seed(SEED)
    L = rx.ring_len
    ks, kv, _ = clock_cuda.clock_recovery_block_kernel_batch_cl(
        xT[0], st.clock, demod._clock, S)
    n_new = kv.sum(-1).to(torch.int32)
    fill = torch.randint(0, L - S, (C,), generator=gcpu).to(torch.int32)
    fill[::97] = L - 100
    fill = fill.to(DEV)
    ring0 = torch.randn((C, L), generator=gcpu).to(DEV)
    ring0 = torch.where(torch.arange(L, device=DEV)[None, :] < fill[:, None], ring0,
                        0.0).to(torch.bfloat16)
    kr, kf, ko = ring_cuda.ring_append(ring0.clone(), fill, ks.re, n_new)
    (pr, pf, po), plain_ms = once_ms(
        lambda: ring_cuda.ring_append_plain(ring0.clone(), fill, ks.re, n_new))
    if not (torch.equal(kr, pr) and torch.equal(kf, pf) and torch.equal(ko, po)):
        fail("onchip: ring_append on a bf16 ring differs from its plain version")
    scratch = ring0.clone()
    ms = time_ms(lambda: ring_cuda.ring_append(scratch, fill, ks.re, n_new), 10)
    moved = int(n_new[~ko].sum())
    bms, by = bound(6 * moved + 16 * C, 0.0)
    rows.append(dict(
        name="ring_append_bf16", route="cuda", source="xritdemod_tpu_torch/csrc/ring.cu",
        replaces="xritdemod_tpu/ops/ring_pallas.py:114", form="bfloat16 ring (ring_pallas.py:56-95)",
        max_abs_err=0.0, tolerance="exact", ms=ms, exact_ms=exact["ring_append"]["ms"],
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    E = K.CODED_FRAME_SIZE
    kf[1::61] = E // 2
    kr[1::61, E // 2:] = 0
    pos = torch.randint(0, E, (C,), generator=gcpu).to(torch.int32).to(DEV)
    kin, pin = kr.clone(), kr.clone()      # in place: each version on its own copy
    kout = ring_cuda.ring_extract(kin, kf, pos, E)
    pout, plain_ms = once_ms(lambda: ring_cuda.ring_extract_plain(pin, kf, pos, E))
    if kout[0].data_ptr() != kin.data_ptr():
        fail("onchip: ring_extract did not hand back the bf16 ring it was given")
    if not all(torch.equal(a, b) for a, b in zip(kout, pout)):
        fail("onchip: ring_extract on a bf16 ring differs from its plain version")
    if bool(kout[3].all()) or not bool(kout[3].any()):
        fail("onchip: ring_extract check: wanted both ok and not-ok channels")
    del kin, pin
    scratch = kr.clone()
    ms = time_ms(lambda: ring_cuda.ring_extract(scratch, kf, pos, E), 10)
    okc = kout[3]
    kept = int(kout[1][okc].sum())
    bms, by = bound(2 * (kept + int(kf[okc].sum())) + 6 * C * E + 16 * C, 0.0)
    rows.append(dict(
        name="ring_extract_bf16", route="cuda", source="xritdemod_tpu_torch/csrc/ring.cu",
        replaces="xritdemod_tpu/ops/ring_pallas.py:145", form="bfloat16 ring (ring_pallas.py:56-95)",
        max_abs_err=0.0, tolerance="exact", ms=ms, exact_ms=exact["ring_extract"]["ms"],
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    return rows


RING_STEADY_BLOCK = 3      # the main path's block after which the steady rows take its fills


def ring_steady(rows: list, fill: torch.Tensor, L: int, S: int, n: int) -> dict:
    """K4a and K4b, float32 and bf16, at the main path's steady state: its
    rings' fills after block RING_STEADY_BLOCK; the append of n symbols a
    channel there (the clock's count a block), then the extract the next
    block's first pop makes, at pos 0 from fill + n.  Each against its plain
    version (`torch.equal` on ring, fill, flags and pop), then timed as the
    kernel rows are; adds `steady` (ms, bound; for the extract also what a
    call allocates, its `out` and no second ring) to the four rows.  Launches
    here come after every path's counts were read."""
    gen = torch.Generator().manual_seed(SEED + 8)
    C, E = fill.shape[0], K.CODED_FRAME_SIZE
    new = torch.randn((C, S), generator=gen).to(DEV)
    n_new = torch.full((C,), n, dtype=torch.int32, device=DEV)
    pos = torch.zeros_like(fill)
    lane = torch.arange(L, device=DEV)[None, :]
    vals = torch.randn((C, L), generator=gen).to(DEV)
    by_name = {r["name"]: r for r in rows}
    out = dict(fills_min=int(fill.min()), fills_max=int(fill.max()),
               fills_mean=float(fill.float().mean()), n_new=n)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        width = 4 if dtype == torch.float32 else 2
        ring = torch.where(lane < fill[:, None], vals, 0.0).to(dtype)
        ka = ring_cuda.ring_append(ring.clone(), fill, new, n_new)
        pa = ring_cuda.ring_append_plain(ring.clone(), fill, new, n_new)
        if not all(torch.equal(a, b) for a, b in zip(ka, pa)):
            fail(f"ring_append{suffix} at the steady fills differs from its plain version")
        scratch = ring.clone()
        ms = time_ms(lambda: ring_cuda.ring_append(scratch, fill, new, n_new), 10)
        moved = int(n_new[~ka[2]].sum())
        bms, _ = bound((4 + width) * moved + 16 * C, 0.0)
        by_name["ring_append" + suffix]["steady"] = dict(ms=ms, bound_ms=bms)
        f2, base = ka[1], ka[0]
        kin = base.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        ke = ring_cuda.ring_extract(kin, f2, pos, E)
        allocated = torch.cuda.max_memory_allocated() - m0     # `out` only: no second ring
        pe = ring_cuda.ring_extract_plain(base.clone(), f2, pos, E)
        if ke[0].data_ptr() != kin.data_ptr() or not all(
                torch.equal(a, b) for a, b in zip(ke, pe)):
            fail(f"ring_extract{suffix} at the steady fills differs from its plain version")
        del kin, ke, pe, scratch
        scratch = base.clone()
        ms = time_ms(lambda: ring_cuda.ring_extract(scratch, f2, pos, E), 10)
        pok = f2 >= E
        bms, _ = bound(width * (int((f2 - E)[pok].sum()) + int(f2[pok].sum()))
                       + (width + 4) * C * E + 16 * C, 0.0)
        by_name["ring_extract" + suffix]["steady"] = dict(
            ms=ms, bound_ms=bms, ok_channels=int(pok.sum()), allocated_bytes=allocated)
        out[f"ring_append{suffix}"] = by_name["ring_append" + suffix]["steady"]
        out[f"ring_extract{suffix}"] = by_name["ring_extract" + suffix]["steady"]
        del ring, ka, pa, base, scratch
    return out


def onchip_phase(cfg: DemodConfig, dcfg: DecoderConfig, base: CF32, delays, vcdus,
                 esn0_db: float, main: dict, split: dict, exact_rows: list, smi: str):
    """The JAX package's own configuration on its chip, at full width, and
    the other block-update and bf16 forms, on the same captures as
    `main_path`:

    (a) `FusedReceiver(DemodConfig.lrit(sample_rate=1_250_000,
        frontend_block_update=8, frontend_precision="bf16"), ...,
        ring_dtype="bfloat16")` at C = 2048 x 131072: a warm-up and four
        steady `step`s and one `step_int8` under `main_path`'s gates; its
        delivered frames within 1 % of `main_path`'s exact receive on the
        same blocks.
    (b) The split path with `frontend_block_update=8, clock_block_update=16`
        (K5, cuDNN RRC, K6-bk8, K2-bu16) at C = 2048, 16 channels on through
        `StreamDecoder`s, under `split_path`'s gates.
    (forms) `block_batch` with the forms no run above selects (K1-bk8 in
        float32 with the sinc block-update clock; K1-bf16).
    (c) Every new instance against its plain version at its path's shape
        and on RAGGED_SHAPES (`check_onchip_kernels`, `check_onchip_ragged`).
    (d) The times beside the exact forms': ms per steady step and the
        device's busy ms of (a) against `main_path`'s, ms per block of (b)
        against `split_path`'s, each new instance's kernel ms against its
        exact instance's.

    `main` holds `main_path`'s receiver, state, step times and frames per
    block; `split` `split_path`'s steady ms.  Returns the new rows of the
    kernels line, and the launches of each path by name."""
    t0 = time.perf_counter()
    ocfg = dataclasses.replace(cfg, frontend_block_update=ONCHIP_K, frontend_precision="bf16")
    rx = FusedReceiver(ocfg, dcfg, channels=CHANNELS, block_len=BLOCK_LEN,
                       ring_dtype="bfloat16")
    per_block: list = []
    fused_counts, ostate, oms, delivered = main_path(
        rx, base, delays, vcdus, esn0_db, blocks=ONCHIP_BLOCKS, int8_blocks=INT8_BLOCKS,
        label="onchip_fused", expected=ONCHIP_FUSED_KERNELS, per_block=per_block)
    exact_frames = sum(main["per_block"][:ONCHIP_BLOCKS])
    got = sum(per_block[:ONCHIP_BLOCKS])
    if abs(got - exact_frames) > 0.01 * exact_frames:
        fail(f"onchip fused: {got} frames in the first {ONCHIP_BLOCKS} blocks where the exact "
             f"receive delivered {exact_frames}")
    # Device-busy ms of one steady step of each receiver, each on the
    # capture's block after the last it took, its state carried on.
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    xo = make_block(base, delays, ONCHIP_BLOCKS + INT8_BLOCKS, gen)
    xm = make_block(base, delays, BLOCKS + INT8_BLOCKS, gen)
    mst = clone_state(main["state"])
    busy = dict(
        onchip=device_busy_ms(lambda: rx.step(xo, ostate)),
        exact=device_busy_ms(lambda: main["rx"].step(xm, mst)))
    del xo, xm, rx, ostate, mst
    torch.cuda.empty_cache()
    a_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    bcfg = DemodConfig.lrit(sample_rate=cfg.sample_rate, frontend_kernel="split",
                            frontend_block_update=ONCHIP_K, clock_block_update=ONCHIP_CLOCK_K)
    split_counts, demod, dstate, bms = split_path(
        cfg, base, delays, vcdus, main["delivered"], smi, split_cfg=bcfg,
        label="onchip_split", expected=ONCHIP_SPLIT_KERNELS)
    del demod, dstate
    torch.cuda.empty_cache()
    forms = forms_path(cfg, base, delays)
    b_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    x0, x1 = (make_block(base, delays, b, gen) for b in (0, 1))
    exact = {r["name"]: r for r in exact_rows}
    rows = check_onchip_kernels(main["rx"], x0, x1, exact)
    k1_forms, stage_counts = k1_stage_path(main["rx"]._demod, x1)
    del x0, x1
    torch.cuda.empty_cache()
    ragged = check_onchip_ragged(main["rx"]._demod)
    edges = check_slab_edges(main["rx"]._demod)
    c_s = time.perf_counter() - t2

    steady = float(np.mean(oms[1:ONCHIP_BLOCKS]))
    exact_steady = float(np.mean(main["ms"][1:ONCHIP_BLOCKS]))
    say("onchip", card=smi,
        fused=dict(config="DemodConfig.lrit(sample_rate=1250000, frontend_block_update=8, "
                          "frontend_precision='bf16'), ring_dtype='bfloat16'",
                   frames_first_blocks=got, exact_frames_first_blocks=exact_frames,
                   frames_per_block=per_block, exact_frames_per_block=main["per_block"],
                   steady_ms_per_step=steady, exact_steady_ms_per_step=exact_steady,
                   steady_blocks=list(range(1, ONCHIP_BLOCKS)),
                   device_busy_ms_one_step=busy, seconds=a_s),
        split=dict(steady_ms_per_block=bms, exact_steady_ms_per_block=split["ms"],
                   launches=split_counts),
        forms=forms, forms_and_split_seconds=b_s,
        kernels=[dict(name=r["name"], ms=r["ms"], exact_ms=r["exact_ms"],
                      plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                      max_abs_err=r["max_abs_err"]) for r in rows],
        ragged_shapes_max_abs_err=ragged, slab_edge_states_max_abs_err=edges,
        checks_seconds=c_s,
        seconds=time.perf_counter() - t0)
    say("k1_forms", card=smi, **k1_forms)
    return rows, dict(fused=fused_counts, split=split_counts, forms=forms["launches"],
                      stages=stage_counts)


# --------------------------------------------------------------------------
# DemodConfig.clock_max_block: the clock's segments
# --------------------------------------------------------------------------

CMB_CAP = 1 << 15            # the JAX package's own segmented drive's cap


def clock_max_block_phase(cfg: DemodConfig, base: CF32, delays, smi: str) -> dict:
    """One `Demodulator.block_batch` at C = 2048 x 131072 with
    `clock_max_block=2^15` (four segments), exact and with
    `clock_block_update=16`, on the capture's first block from a cold
    start.  `num_slots` must be the reference's (4 x `max_symbols(2^15)`),
    and the output's shape `(C, num_slots)`; the front end is run again on
    the same block and the plain clock over the same segments (the block
    update's chunk grid starting again at each) must give the
    `block_batch`'s soft symbols and `valid` bit for bit; K2 against that
    plain clock at those segments, every output and carry (the block update
    through both of its entries).  The block updates' launches are counted
    in the `block_batch` calls alone."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    x = make_block(base, delays, 0, gen)
    xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    out = dict(shape=[CHANNELS, BLOCK_LEN], clock_max_block=CMB_CAP)
    for K in (0, ONCHIP_CLOCK_K):
        c = dataclasses.replace(cfg, clock_max_block=CMB_CAP, clock_block_update=K)
        d = Demodulator(c, BLOCK_LEN)
        segs = d.clock_segments
        want_slots = segs * clock_recovery.max_symbols(BLOCK_LEN // segs, d._clock)
        st = d.init_state_batch(CHANNELS)
        reset_counts()
        (soft, valid, _), ms = once_ms(lambda: d.block_batch(x, st))
        counts = read_counts()
        check_counts(f"clock_max_block block_batch (K = {K})", counts,
                     ("frontend", "clock_bu" if K else "clock"))
        if segs != 4 or d.num_slots != want_slots:
            fail(f"clock_max_block: {segs} segments and {d.num_slots} slots, not 4 and "
                 f"{want_slots}")
        if soft.shape != (CHANNELS, d.num_slots) or valid.shape != soft.shape:
            fail(f"clock_max_block: outputs {tuple(soft.shape)}, not "
                 f"{(CHANNELS, d.num_slots)}")
        yT = frontend_cuda.demod_frontend(xT, st.agc_gain, st.rrc_hist, st.costas,
                                          d._agc, d._rrc_taps, d._costas)[0]
        args = (yT, st.clock, d._clock, d.num_slots, cfg.clock_interp, K, segs)
        k = clock_cuda.clock_recovery_block_kernel_batch_cl(*args)
        p, pms = once_ms(lambda: clock_cuda.clock_recovery_block_plain_cl(*args))
        errs = clock_errs(k, p, f"clock_max_block K={K}")
        if K:
            # The block update's (C, T) entry, which reads the block as it is.
            yC = CF32(yT.re.t().contiguous(), yT.im.t().contiguous())
            errs += clock_errs(clock_cuda.clock_recovery_block_kernel_batch(yC, *args[1:]), p,
                               f"clock_max_block K={K}, (C, T)")
            del yC
        if not (torch.equal(valid, p[1]) and torch.equal(soft, p[0].re)):
            fail(f"clock_max_block (K = {K}): block_batch's symbols or valid differ from the "
                 "plain chain's")
        if not max(errs) <= 0.0:
            fail(f"clock_max_block (K = {K}): K2 differs from its plain version: {errs}")
        n = valid.sum(-1)
        out["block_update_16" if K else "exact"] = dict(
            segments=segs, num_slots=d.num_slots,
            num_slots_default_cap=Demodulator(dataclasses.replace(c, clock_max_block=0),
                                              BLOCK_LEN).num_slots,
            symbols_per_channel_min_max=[int(n.min()), int(n.max())],
            max_abs_err=max(errs), block_batch_ms=ms, plain_clock_ms=pms, launches=counts)
        del soft, valid, yT, k, p
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# the reference's frozen answers, the serial receive, decode_multi
# --------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"


def frozen(name: str, digest: str) -> bytes:
    data = (FIXTURES / name).read_bytes()
    if hashlib.sha256(data).hexdigest() != digest:
        fail(f"tests/fixtures/{name} does not match its pinned SHA-256")
    return data


def kat_phase(smi: str) -> dict:
    """The reference's independent checks on the card.  The two SHA-pinned
    int8 streams through `StreamDecoder` (K3 at 16 windows while it
    acquires, 128 once a frame verified): VCDUs byte-equal to the frozen
    payloads.  The raw-IQ fixture of `tests/test_demod_kat.py` through
    `process` (K5, K6, K2) and through `block_batch` at 4 channels, fused
    (K1, K2) and split (K5, K6, K2), for both interpolators, against that
    file's scalar GNU Radio transcription at its tolerances: the same symbol
    count, atol 2e-3, hard decisions equal away from the threshold."""
    sys.path.insert(0, str(FIXTURES.parent))
    import test_demod_kat as kat                # numpy only at import time

    meta = json.loads((FIXTURES / "meta.json").read_text())
    out = {"streams": {}, "demod": {}}
    reset_counts()
    for mode in ("lrit", "hrit"):
        m = meta[mode]
        wire = np.frombuffer(frozen(f"{mode}_soft_int8.bin", m["soft_sha256"]), np.int8)
        want = np.frombuffer(frozen(f"{mode}_vcdus.bin", m["vcdu_sha256"]), np.uint8).reshape(
            m["n_vcdus"], K.VCDU_SIZE)
        sd = StreamDecoder(DecoderConfig(mode=mode, frames_per_block=8))
        batches = []
        for i in range(0, wire.size, 16384):
            batches += sd.push(wire[i : i + 16384].astype(np.float32))
        batches += sd.flush()
        ok = np.concatenate([b.frame_ok.cpu().numpy() for b in batches])
        got = np.concatenate([b.vcdu.cpu().numpy() for b in batches])[ok]
        ctr = np.concatenate([b.counter.cpu().numpy() for b in batches])[ok]
        if got.shape != want.shape or not np.array_equal(got, want) or ctr.tolist() != list(
                range(m["counter0"], m["counter0"] + m["n_vcdus"])):
            fail(f"kat: the frozen {mode} stream did not decode to its frozen VCDUs")
        out["streams"][mode] = dict(vcdus=int(ok.sum()), batches_by_size=sorted(
            {len(b.frame_ok) for b in batches}))
    x = kat.load_fixture()
    block = 32768
    for interp in ("mmse", "sinc"):
        ref = kat.chain_cached(interp)[0].real
        strong = np.abs(ref) > 2e-2
        cfg = DemodConfig.lrit(sample_rate=int(kat.FS), clock_interp=interp)
        for form in ("process", "fused", "split"):
            if form == "process":
                demod = Demodulator(cfg, block)
                st = demod.init_state()
                parts = []
                for i in range(0, x.shape[0], block):
                    soft, valid, st = demod.process(x[i : i + block], st)
                    parts.append(soft[valid].cpu().numpy())
                chans = [np.concatenate(parts)]
            else:
                demod = Demodulator(dataclasses.replace(cfg, frontend_kernel=form), block)
                st = demod.init_state_batch(4)
                parts = []
                for i in range(0, x.shape[0], block):
                    soft, valid, st = demod.block_batch(np.tile(x[i : i + block], (4, 1)), st)
                    parts.append((soft.cpu().numpy(), valid.cpu().numpy()))
                chans = [np.concatenate([s_[c][v[c]] for s_, v in parts]) for c in range(4)]
            errs = []
            for got in chans:
                if got.shape != ref.shape:
                    fail(f"kat: {form} ({interp}) gave {got.shape[0]} symbols, the scalar chain "
                         f"{ref.shape[0]}")
                errs.append(float(np.abs(got - ref).max()))
                if not np.array_equal(np.sign(got[strong]), np.sign(ref[strong])):
                    fail(f"kat: {form} ({interp}): a hard decision differs from the scalar chain")
            if not max(errs) <= 2e-3:
                fail(f"kat: {form} ({interp}) differs from the scalar chain by {max(errs)}")
            out["demod"][f"{form}_{interp}"] = dict(symbols=int(ref.shape[0]),
                                                    max_abs_err=max(errs))
    counts = read_counts()
    check_counts("kat phase", counts, ("frontend", "clock", "clock_sinc", "agc_block",
                                       "costas_block", "viterbi", "rs"))
    return dict(card=smi, tolerance="as tests/test_demod_kat.py: equal symbol counts, atol "
                "2e-3, hard decisions equal where |soft| > 2e-2", launches=counts, **out)


# The stream starts with the loops cold, and the first frame-length window
# of symbols then holds no true sync word: `StreamDecoder` can lock on a
# noise peak there (as the reference's does), commit an 8-frame batch at the
# wrong place and resync, which costs ~9 frames.  16 blocks carry ~30 frames.
SERIAL_BLOCKS = 16


@torch.inference_mode()    # no autograd bookkeeping in the plain loops' steps
def check_serial_kernels(demod: Demodulator, x: np.ndarray, where: str = "serial path",
                         interps=("mmse", "sinc")) -> dict:
    """The kernels `process` (one channel, `x` of shape `(T,)`) or the split
    `block_batch` (`(C, T)`) launches, each against its plain version at
    that shape, from the cold state: on the serial path one channel of
    131072 samples, the stream's first block.  K5 on the block; K6 on the
    plain AGC's output after the RRC; K2, each instance of `interps`, on the
    plain Costas loop's output, through the `(C, T)` entry that both call.
    Returns the largest differences; fails `where` above 1e-4."""
    x = from_complex(x if x.ndim == 2 else x[None, :], DEV)
    st = demod.init_state_batch(x.re.shape[0])
    out = {}
    ka, kg = stream_cuda.agc_block_kernel(x, st.agc_gain, demod._agc)
    pa, pg = agc_op.agc_block(x, st.agc_gain, demod._agc)
    out["agc_block"] = max(max_err(ka.re, pa.re), max_err(ka.im, pa.im), max_err(kg, pg))
    y, _ = fir.fir_block(pa, demod._rrc_taps, st.rrc_hist)
    ky, kc = stream_cuda.costas_block_kernel(y, st.costas, demod._costas)
    py, pc = costas_op.costas_block(y, st.costas, demod._costas)
    out["costas_block"] = max(max_err(ky.re, py.re), max_err(ky.im, py.im),
                              max_err(kc.phase, pc.phase), max_err(kc.freq, pc.freq))
    yT = CF32(py.re.t().contiguous(), py.im.t().contiguous())
    for interp in interps:
        name = "clock" if interp == "mmse" else "clock_sinc"
        k = clock_cuda.clock_recovery_block_kernel_batch(
            py, st.clock, demod._clock, demod.num_slots, interp)
        p = clock_cuda.clock_recovery_block_plain_cl(
            yT, st.clock, demod._clock, demod.num_slots, interp)
        out[name] = max(clock_errs(k, p, f"{where} {name}"))
    if not max(out.values()) <= 1e-4:
        fail(f"{where}: a kernel disagrees with its plain version at "
             f"{tuple(x.re.shape)}: {out}")
    return out


def serial_path(smi: str) -> None:
    """One LRIT stream as `DemodulatorApp` runs it: `Demodulator.process` on
    blocks of 131072 samples, `snr_estimate` beside it, `quantize_symbols`,
    one `StreamDecoder`; once per interpolator.  Every delivered VCDU must be
    one that was sent (the stream's first frame may be its complement,
    ROADMAP §C), at least 10 frames each.  The line reports each block's
    time (synchronised, `process` alone) and SNR estimate, and the
    decoder's statistics."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    n = SERIAL_BLOCKS * BLOCK_LEN
    v = tx.make_vcdus(int(n / cfg.sps / K.CODED_FRAME_SIZE) + 2, scid=13, vcid=7,
                      counter0=500, rng=np.random.default_rng(SEED + 40))
    sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(SEED + 41))
    iq = tx.modulate(sym, cfg, np.random.default_rng(SEED + 42), freq_offset=1.5e-4,
                     phase=1.1, amp=0.3, noise=0.05)[:n]
    sent = {x.tobytes() for x in v}
    checked = check_serial_kernels(Demodulator(cfg, BLOCK_LEN), iq[:BLOCK_LEN])
    out = {}
    for interp in ("mmse", "sinc"):
        demod = Demodulator(dataclasses.replace(cfg, clock_interp=interp), BLOCK_LEN)
        sd = StreamDecoder(DecoderConfig(mode="lrit"))
        sd.warm_jit()
        st = demod.init_state()
        demod.process(iq[:BLOCK_LEN], st)                    # builds and warms the kernels
        torch.cuda.synchronize()
        reset_counts()
        ms, snr, got = [], [], []
        for b in range(SERIAL_BLOCKS):
            x = iq[b * BLOCK_LEN : (b + 1) * BLOCK_LEN]
            snr.append(float(demod.snr_estimate(x, st)))
            (soft, valid, st), t = once_ms(lambda: demod.process(x, st))
            ms.append(t)
            q = quantize_symbols(soft[valid]).cpu().numpy()
            for bt in sd.push(q):
                got += [bt.vcdu[i].cpu().numpy().tobytes()
                        for i in np.nonzero(bt.frame_ok.cpu().numpy())[0]]
        for bt in sd.flush():
            got += [bt.vcdu[i].cpu().numpy().tobytes()
                    for i in np.nonzero(bt.frame_ok.cpu().numpy())[0]]
        counts = read_counts()
        wrong = [k for k, g in enumerate(got) if g not in sent]
        first_complement = wrong == [0] and bytes(255 - c for c in got[0]) in sent
        out[interp] = dict(blocks=SERIAL_BLOCKS, ms_per_block=ms,
                           steady_ms_per_block=float(np.mean(ms[1:])),
                           realtime_ms_per_block=BLOCK_LEN / cfg.sample_rate * 1e3,
                           snr_estimate_db=snr, frames=len(got), wrong_frames=len(wrong),
                           first_frame_complemented=first_complement,
                           decoder_stats=dataclasses.asdict(sd.stats), launches=counts)
    line = dict(card=smi, config="DemodConfig.lrit(sample_rate=1250000) -> process -> "
                "quantize_symbols -> StreamDecoder(DecoderConfig(mode='lrit'))",
                block_len=BLOCK_LEN, first_block_kernels_max_abs_err=checked,
                tolerance="atol 1e-4, equal symbol counts and positions", **out)
    say("serial_path", **line)
    for interp, r in out.items():
        if r["wrong_frames"] and not r["first_frame_complemented"]:
            fail(f"serial path ({interp}): {r['wrong_frames']} delivered VCDUs were never sent")
        if r["frames"] - r["wrong_frames"] < 10:
            fail(f"serial path ({interp}): only {r['frames'] - r['wrong_frames']} frames "
                 "delivered")
        check_counts(f"serial path ({interp})", r["launches"],
                     ("agc_block", "costas_block", "clock" if interp == "mmse" else "clock_sinc",
                      "viterbi", "rs"))


# --------------------------------------------------------------------------
# the apps: the entry points a user starts
# --------------------------------------------------------------------------

APPS_INTEROP_S = 30.0    # LRIT at 1.25 Msps through the two CLI processes
APPS_RX_S = 10.0         # each of LRIT and HRIT at 3 Msps through ReceiverApp
APPS_PAD_BLOCKS = 8      # DemodulatorApp blocks, batch_pad 128 against 0
APPS_PAD = 128
APPS_PAD_ORDER = (0, APPS_PAD, APPS_PAD, 0, 0, APPS_PAD)   # alternated, against warm-up
APPS_KERNELS = ("agc_block", "costas_block", "clock", "viterbi", "rs")


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for so in socks:
        so.bind(("127.0.0.1", 0))
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    return ports


def symbol_sink():
    """A TCP server that keeps what one client sends: (port, thread, chunks)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    chunks: list[bytes] = []

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(120)
        with conn:
            while d := conn.recv(1 << 16):
                chunks.append(d)
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], t, chunks


def rx_run(cfg: DemodConfig, mode: str, path: str, vcdus) -> dict:
    """`ReceiverApp` on a capture file in this process, its VCDUs collected
    from its vchannel port and checked against what was sent."""
    p1, p2 = free_ports(2)
    app = ReceiverApp(cfg, DecoderConfig(mode=mode), CFileFrontend(path),
                      vchannel_port=p1, statistics_port=p2)
    col = interop_run.Collector(p1, "vcdu", connect_s=30)
    col.start()
    if not col.connected.wait(30):
        fail(f"apps rx ({mode}): no connection to the vchannel port")
    t0 = time.perf_counter()
    app.run()
    wall = time.perf_counter() - t0
    deadline = time.monotonic() + 30
    while len(col.data) < app.decoder_app.stats.total_packets * K.VCDU_SIZE and \
            time.monotonic() < deadline:
        time.sleep(0.1)
    time.sleep(0.5)
    col.stop()
    col.join(5)
    want = {(6, i): v.tobytes() for i, v in enumerate(vcdus)}
    got = interop_run.check_vcdus(col.data, want)
    demod = app.demod_app
    nsamples = os.path.getsize(path) // 8
    seconds = nsamples / cfg.sample_rate
    whole = interop_run.frames_demodulated(len(vcdus), cfg.sps, nsamples, BLOCK_LEN)
    st = app.decoder_app.stats
    return dict(
        mode=mode, seconds_of_signal=seconds, frames_sent=len(vcdus),
        frames_exact=got["exact"], frames_missing=len(got["missing"]),
        frames_past_the_last_whole_block=len(vcdus) - whole,
        missing_counters=[k[1] for k in got["missing"]][:16],
        frames_wrong_payload=got["wrong"], duplicate_mismatches=got["duplicate_mismatches"],
        blocks=demod.blocks, ms_per_block=1e3 * demod.block_seconds / demod.blocks,
        realtime_ms_per_block=BLOCK_LEN / cfg.sample_rate * 1e3, wall_s=wall,
        x_realtime=seconds / wall, sample_ring=demod.ring_kind,
        stats=dict(total=st.total_packets, dropped=st.dropped_packets, lost=st.lost_packets),
        failures=interop_run.frame_failures(got, whole),
    )


def pad_run(cfg: DemodConfig, path: str, pad: int) -> tuple[np.ndarray, float]:
    """APPS_PAD_BLOCKS blocks of `DemodulatorApp` with `batch_pad=pad` into
    a symbol sink, the constellation tap on as the default config has it
    (`snr_estimate` on block 0): (the int8 symbols sent, ms per block)."""
    port, t, chunks = symbol_sink()
    app = DemodulatorApp(cfg, CFileFrontend(path), decoder_port=port, batch_pad=pad,
                         send_constellation=True)
    app.run(max_blocks=APPS_PAD_BLOCKS)
    t.join(60)
    return np.frombuffer(b"".join(chunks), np.int8), 1e3 * app.block_seconds / app.blocks


def pad_compare(cfg: DemodConfig, path: str) -> dict:
    """`batch_pad` 128 against 0 on the same capture: `pad_run` in the
    order APPS_PAD_ORDER, each run's int8 symbols against the first serial
    run's; ms per block of every run, the median and range of each side;
    then one block of each side's `step` under torch.profiler (device busy
    ms and its largest kernels), to say whether a gap is the device's."""
    runs = {0: [], APPS_PAD: []}
    ref, equal, sizes = None, True, set()
    for pad in APPS_PAD_ORDER:
        sym, ms = pad_run(cfg, path, pad)
        runs[pad].append(ms)
        sizes.add(len(sym))
        ref = sym if ref is None else ref
        equal = equal and np.array_equal(sym, ref)
    x = np.fromfile(path, np.complex64, count=BLOCK_LEN)
    device = {}
    for pad in runs:
        app = DemodulatorApp(cfg, CFileFrontend(path), batch_pad=pad)
        st = app.init_state()
        app.step(x, st)
        busy, rows = device_kernels(lambda: app.step(x, st))
        device[pad] = dict(busy_ms=busy, top=[dict(name=k[:60], ms=ms) for k, ms, _ in rows[:6]])
    side = lambda pad: dict(ms_per_block=runs[pad], median_ms=float(np.median(runs[pad])),
                            min_ms=min(runs[pad]), max_ms=max(runs[pad]),
                            device_one_block=device[pad])
    return dict(blocks=APPS_PAD_BLOCKS, batch_pad=APPS_PAD, order=list(APPS_PAD_ORDER),
                symbols=sorted(sizes), equal=equal and len(sizes) == 1,
                serial=side(0), padded=side(APPS_PAD),
                padded_minus_serial_median_ms=float(np.median(runs[APPS_PAD])
                                                    - np.median(runs[0])))


def start_app_captures() -> dict:
    """The `apps` phase's config and captures for (b) and (c): the config
    loader's default file written into a temporary directory (removed at
    exit), then two spawned workers synthesising 10 s of LRIT and of HRIT at
    its 3 Msps.  Started right after the build, so that the synthesis
    overlaps the kernel checks' plain loops and nothing competes with the
    apps' timed runs for the host."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    cfg_path = os.path.join(tmp, "xritdemod.cfg")
    lrit_cfg, parser = demod_config_from_file(cfg_path)
    defaults = dict(sample_rate=lrit_cfg.sample_rate, decimation=lrit_cfg.decimation,
                    mode=parser.get("mode"), send_constellation=parser.get("sendConstellation"))
    if defaults != dict(sample_rate=3_000_000, decimation=1, mode="lrit",
                        send_constellation="true"):
        fail(f"apps: the loader's default config is {defaults}")
    with open(cfg_path) as f:
        text = f.read()
    with open(cfg_path, "w") as f:
        f.write(text.replace("mode=lrit", "mode=hrit"))
    hrit_cfg, _ = demod_config_from_file(cfg_path)
    if hrit_cfg.symbol_rate != K.HRIT_SYMBOL_RATE or hrit_cfg.sample_rate != 3_000_000:
        fail(f"apps: mode=hrit gave {hrit_cfg}")
    cfgs = {"lrit": lrit_cfg, "hrit": hrit_cfg}
    caps = {m: os.path.join(tmp, f"{m}.c64") for m in cfgs}
    # Worker processes are joined at exit whatever happens in between.
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    jobs = {m: pool.submit(interop_run.synthesize, c, m == "lrit", APPS_RX_S, caps[m],
                           SEED + 60 + i, vcid=6)
            for i, (m, c) in enumerate(cfgs.items())}
    return dict(cfgs=cfgs, caps=caps, jobs=jobs, pool=pool)


def apps_phase(smi: str, prep: dict) -> dict:
    """The entry points a user starts, on the card.

    (a) The two-process interop (`tools/interop_run.py`): `cli decode` and
        `cli demod` over loopback on 30 s of LRIT at 1.25 Msps; every frame
        after the cold-start head bit-exact on the vchannel port, the
        statistics stream sane, at least real time without the warm-up.
    (b) `ReceiverApp` at the loader's own default config (a missing
        `xritdemod.cfg` written by `demod_config_from_file`: LRIT at
        3 Msps), 10 s of LRIT, then the same file with `mode=hrit`, 10 s of
        HRIT; frames checked as in (a).  Its kernel launches are counted.
    (c) `DemodulatorApp` with `batch_pad=128` against the serial path on the
        first blocks of (b)'s LRIT capture, three runs a side in alternated
        order: the same int8 symbols.
    First, the kernels (b) launches (K5, K6, K2) against their plain
    versions on each capture's first block at (b)'s config: the shapes of
    this path, ~13k symbols a block for LRIT and ~41k for HRIT at 3 Msps.
    `prep` is `start_app_captures()`'s."""
    cfgs, caps = prep["cfgs"], prep["caps"]
    sent = {m: j.result() for m, j in prep["jobs"].items()}
    prep["pool"].shutdown()
    t0 = time.perf_counter()
    checked = {m: check_serial_kernels(Demodulator(dataclasses.replace(c, frontend_kernel="split"),
                                                   BLOCK_LEN),
                                       np.fromfile(caps[m], np.complex64, count=BLOCK_LEN),
                                       f"apps rx ({m})", interps=(c.clock_interp,))
               for m, c in cfgs.items()}
    check_s = time.perf_counter() - t0
    ports = free_ports(3)
    interop = interop_run.main([str(APPS_INTEROP_S), "--ports", ",".join(map(str, ports)),
                                "--timeout", "300"])

    reset_counts()
    rx = {m: rx_run(c, m, caps[m], sent[m]) for m, c in cfgs.items()}
    counts = read_counts()

    pad = pad_compare(cfgs["lrit"], caps["lrit"])
    for path in caps.values():
        os.unlink(path)
    line = dict(card=smi, interop=interop, rx=rx, launches=counts, batch_pad=pad,
                sample_ring=dict(native=native.available(), error=native.last_error()),
                first_block_kernels_max_abs_err=checked, first_block_kernels_s=check_s,
                tolerance="kernels: atol 1e-4, equal symbol counts and positions")
    say("apps", **line)
    if not interop["ok"]:
        fail(f"apps interop: {interop['failures']}")
    for m, r in rx.items():
        if r["failures"]:
            fail(f"apps rx ({m}): {r['failures']}: {r}")
    if not pad["equal"]:
        fail(f"apps batch_pad: the padded symbols differ from the serial path's: {pad}")
    check_counts("apps rx path", counts, APPS_KERNELS)
    return counts


def decode_multi_phase(vcdus, smi: str) -> dict:
    """`CaduDecoder.decode_multi` at (B, F) = (2048, 8), 16384 frames in one
    call (one K3 launch of 16384 windows), against 8 sequential
    `decode_frames` calls chained by their tails, field for field, with
    `forensics=True`; and the time of both with the shipped config.  The
    comparison decodes every frame as one Viterbi window
    (`viterbi_segments=0`): with the shipped config the sequential calls
    (2048 frames) take 4 overlapped windows a frame, a different decoder
    that agrees with the exact one only as far as the signal allows.
    The one K3 launch of `decode_multi` (16384 windows of 8224 steps, LPW 4)
    is held against the plain Viterbi decoder on the windows it was given,
    bit for bit."""
    B, F = CHANNELS, 8
    base = []
    for s in range(STREAMS):
        sym = tx.encode_stream(vcdus[s][:F], lrit=True, noise=0.0,
                               rng=np.random.default_rng(SEED + 50 + s))
        base.append(sym[: F * K.CODED_FRAME_SIZE].reshape(F, K.CODED_FRAME_SIZE))
    base = torch.from_numpy(np.stack(base)).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 51)
    frames = base.repeat(B // STREAMS, 1, 1)
    frames = frames * torch.where(torch.arange(B, device=DEV) % 3 == 1, -1.0, 1.0)[:, None, None]
    frames += 0.5 * torch.randn(frames.shape, generator=gen, device=DEV)
    tails = torch.zeros((B, 64), device=DEV)
    out = {}
    dec = CaduDecoder(DecoderConfig(mode="lrit", forensics=True, viterbi_segments=0))
    seen = []
    launch = viterbi_cuda.decode_bits

    def spy(soft, lanes=None):
        bits = launch(soft, lanes)
        seen.append((soft, bits))
        return bits

    reset_counts()
    viterbi_cuda.decode_bits = spy
    try:
        mb, mt = dec.decode_multi(frames, tails)
    finally:
        viterbi_cuda.decode_bits = launch
    counts = read_counts()
    if len(seen) != 1:
        fail(f"decode_multi called the Viterbi kernel {len(seen)} times, not once")
    wins, kbits = seen[0]
    pbits, vit_plain_ms = once_ms(lambda: viterbi_cuda.decode_bits_plain(wins))
    nbad = int((kbits != pbits).sum())
    if nbad:
        fail(f"decode_multi: its Viterbi launch differs from the plain decoder in {nbad} bits")
    out["viterbi_windows"] = [wins.shape[0], wins.shape[1] // 2]
    out["viterbi_max_abs_err"] = 0.0
    out["viterbi_plain_ms"] = vit_plain_ms
    del seen, wins, kbits, pbits
    t, seq = tails, []
    for f in range(F):
        b1, t = dec.decode_frames(frames[:, f], t)
        seq.append(b1)
    for name in mb._fields:
        want = torch.stack([getattr(b1, name) for b1 in seq], dim=1)
        if not torch.equal(getattr(mb, name), want):
            fail(f"decode_multi differs from sequential decode_frames in {name}")
    if not torch.equal(mt[:, -1], t):
        fail("decode_multi's last tails differ from the sequential calls' carried tails")
    ok = int(mb.frame_ok.sum())
    if ok < B * F * 99 // 100:
        fail(f"decode_multi: only {ok} of {B * F} frames decoded")
    del mb, mt, seq, b1
    plain = CaduDecoder(DecoderConfig(mode="lrit"))

    def multi():
        plain.decode_multi(frames, tails)

    def sequential():
        t = tails
        for f in range(F):
            t = plain.decode_frames(frames[:, f], t)[1]

    out["decode_multi_ms"] = time_ms(multi, 3)
    out["sequential_decode_frames_ms"] = time_ms(sequential, 3)
    out["decode_multi_device_busy_ms"] = device_busy_ms(multi)
    out["sequential_decode_frames_device_busy_ms"] = device_busy_ms(sequential)
    check_counts("decode_multi", counts, ("viterbi", "rs"))
    if counts["viterbi"] != 1:
        fail(f"decode_multi launched the Viterbi kernel {counts['viterbi']} times, not once")
    return dict(card=smi, streams=B, frames_per_stream=F, frames=B * F, frames_ok=ok,
                viterbi_launches=counts["viterbi"],
                viterbi_lanes=viterbi_cuda.lanes_per_window(B * F),
                equal_to_sequential_decode_frames="every field, forensics on",
                frames_per_s=B * F / (out["decode_multi_ms"] * 1e-3), **out,
                timing="ms: CUDA events around whole calls, 3 calls after one warm-up (the "
                       "calls read the device from the host); device_busy_ms: the kernels' "
                       "time under torch.profiler, one call")




RS_FEW, RS_MANY = 16, 256    # frames with an error burst: 4 codewords each


def rs_sparse_phase(vcdus, smi: str) -> dict:
    """The RS decoder inside `CaduDecoder.decode_frames` at B = 2048 frames
    (8192 codewords, the automatic Kmax 512): the same frames with an error
    burst (600 coded symbols of noise) in RS_FEW frames (at most Kmax
    codewords in error: the plain route's sparse branch) and in RS_MANY
    (more than Kmax: its full branch), each decoded through the kernel (K8's
    frame entry) and through the plain frame route (`rs_decode_frame_plain`)
    with the automatic Kmax and with XRIT_RS_SPARSE=0 (its errored rows,
    found by a variable-length read).  Every `FrameBatch` field must be
    equal between the three; each case's errored codewords must fall on its
    side of Kmax; the plain route must take its branch.  Prints the times of
    `decode_frames` and, counted with CUDA's synchronisation debug mode, the
    host reads of each `rs_decode_frame` call: the kernel's route must make
    none."""
    B = CHANNELS
    per = []
    for s in range(STREAMS):
        sym = tx.encode_stream(vcdus[s][:8], lrit=True, noise=0.0,
                               rng=np.random.default_rng(SEED + 60 + s))
        per.append(sym[: 8 * K.CODED_FRAME_SIZE].reshape(8, K.CODED_FRAME_SIZE))
    base = torch.from_numpy(np.concatenate(per)).to(DEV).repeat(B // (8 * STREAMS), 1)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 61)
    clean = base + 0.3 * torch.randn(base.shape, generator=gen, device=DEV)
    tails = torch.zeros((B, 64), device=DEV)
    dec = CaduDecoder(DecoderConfig(mode="lrit"))
    kmax = reed_solomon._default_sparse_max(4 * B)
    rs_call = reed_solomon.rs_decode_frame
    reads: list = []

    def counted(frames, call):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = call(frames)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        reads.append(sum("called a synchronizing CUDA operation" in str(m.message) for m in w))
        return out

    out = dict(frames=B, codewords=4 * B, kmax=kmax)
    dec.decode_frames(clean, tails)            # tables and kernels loaded
    for name, nburst in (("few", RS_FEW), ("many", RS_MANY)):
        frames = clean.clone()
        hit = torch.randperm(B, generator=gen, device=DEV)[:nburst]
        frames[hit, 2000:2600] = torch.randn((nburst, 600), generator=gen, device=DEV)
        res = {}
        for mode in ("kernel", "auto", "off"):
            os.environ["XRIT_RS_SPARSE"] = "0" if mode == "off" else "1"
            call = rs_call if mode == "kernel" else reed_solomon.rs_decode_frame_plain
            before = dict(reed_solomon.branches)
            launched = rs_cuda.launches
            reed_solomon.rs_decode_frame, reads[:] = (lambda f: counted(f, call)), []
            try:
                batch, _ = dec.decode_frames(frames, tails)
                took = {k: v - before[k] for k, v in reed_solomon.branches.items()
                        if v != before[k]}
                reed_solomon.rs_decode_frame = call
                ms = time_ms(lambda: dec.decode_frames(frames, tails), 5)
            finally:
                reed_solomon.rs_decode_frame = rs_call
            res[mode] = dict(batch=batch, ms=ms, host_reads_per_rs_call=reads[:1],
                             branch=took, kernel_launches=rs_cuda.launches - launched)
        os.environ.pop("XRIT_RS_SPARSE", None)
        a = res["kernel"]["batch"]
        for mode in ("auto", "off"):
            b = res[mode]["batch"]
            for f in a._fields:
                if not same_state(getattr(a, f), getattr(b, f)):
                    fail(f"rs sparse ({name}): FrameBatch.{f} of the kernel differs from the "
                         f"plain route's ({mode})")
        errored = int((a.rs_errors != 0).sum())
        if (name == "few") != (0 < errored <= kmax) or errored == 0:
            fail(f"rs sparse ({name}): {errored} errored codewords against Kmax {kmax}")
        want = "sparse" if name == "few" else "full"
        if res["kernel"]["branch"] or res["auto"]["branch"] != {want: 1} \
                or res["off"]["branch"] != {"rows": 1}:
            fail(f"rs sparse ({name}): branches {res['kernel']['branch']}, "
                 f"{res['auto']['branch']} and {res['off']['branch']}")
        if res["kernel"]["host_reads_per_rs_call"] != [0] or res["kernel"]["kernel_launches"] < 1:
            fail(f"rs sparse ({name}): the kernel's route made "
                 f"{res['kernel']['host_reads_per_rs_call']} host reads in one rs_decode_frame call "
                 f"(wanted none) and {res['kernel']['kernel_launches']} launches")
        out[name] = dict(
            burst_frames=nburst, errored_codewords=errored,
            frames_ok=int(a.frame_ok.sum()),
            **{f"{m}_{k}": res[m][k] for m in res for k in ("ms", "host_reads_per_rs_call",
                                                            "branch")})
        del frames, res, a, b
    return out
# --------------------------------------------------------------------------
# the parallel layer: fold-parallel reprocess at full width, the three axes
# --------------------------------------------------------------------------

SOAK_S = 60.0            # LRIT at 1.25 Msps: the reference's soak, 1075 frames
SOAK_HRIT_S = 10.0       # HRIT at 3 Msps: NRZ-M across the fold seams
FOLDS = 128
MESH_ENTRIES = 4         # repeated cuda:0 entries: a mesh on one card
MESH_CPD = 128           # channels a slab (channel axis, sharded fused)
MESH_FUSED_BLOCKS = 4
# Samples a time block.  The reference's default is 2^20; the script runs
# 2^19 (still past 2^17: a segmented slot budget) to stay in its time budget.
TB_BLOCK = 1 << 19
TB_BLOCKS = 4
TB_LANE_TOL = 5e-4        # batched time-block rows against one-lane `process`: the serial tolerance
PARALLEL_KERNELS = ("frontend", "clock", "viterbi", "ring_append", "ring_extract",
                    "agc_block", "costas_block", "rs", "acquire")


def start_parallel_captures() -> dict:
    """The soak's captures for the `parallel` phase, on the s8 wire, made by
    two spawned workers started right after the build (`long_soak.py`'s
    synthesis: 60 s of LRIT at 1.25 Msps, 10 s of HRIT at 3 Msps, 100 ppm
    clock drift, 2e-5 carrier drift) into a temporary directory removed at
    exit, beside each capture the config file `cli reprocess` reads."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    caps, cfgs = {}, {}
    for mode, rate in (("lrit", 1_250_000), ("hrit", 3_000_000)):
        caps[mode] = os.path.join(tmp, f"{mode}.s8")
        cfgs[mode] = os.path.join(tmp, f"{mode}.cfg")
        with open(cfgs[mode], "w") as f:
            f.write(f"mode={mode}\nsampleRate={rate}\ndecimation=1\n")
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    jobs = {m: pool.submit(long_soak.write_capture, caps[m], s, m)
            for m, s in (("lrit", SOAK_S), ("hrit", SOAK_HRIT_S))}
    return dict(tmp=tmp, caps=caps, cfgs=cfgs, jobs=jobs, pool=pool)


class _Counted:
    """Sums the kernel launch counts of the runs made inside `with` blocks
    (the paths driven), leaving out what runs between them (the runs they
    are compared with)."""

    def __init__(self):
        self.total = {k: 0 for k in read_counts()}

    def __enter__(self):
        reset_counts()

    def __exit__(self, *exc):
        for k, n in read_counts().items():
            self.total[k] += n


def check_fold_kernels(rx: FoldedCaptureReceiver, cap: np.ndarray, streams) -> dict:
    """The fold path's kernels (K1, K2, K4a, K4b, K3; and K2-sinc, K5, K6
    on the same inputs) against their plain versions at its shapes:
    `check_kernels` through the receiver's `FusedReceiver(channels=FOLDS)`
    on the capture's first two fold blocks, dequantized on the card as
    `step_int8` does.  `streams` are the per-stream VCDUs that K3's frames
    are encoded from."""
    t0 = time.perf_counter()
    starts, nblocks = rx._fold_starts(len(cap) // 2)
    buf, noise = np.zeros((FOLDS, 2 * BLOCK_LEN), np.int8), rx._noise(True)
    x = [dequantize_iq_s8(torch.from_numpy(rx._block(cap, starts, j, nblocks, buf, noise, 2))
                          .to(DEV)) for j in (0, 1)]
    rows = check_kernels(rx._get_rx(), *x, streams, where="parallel fold path")
    return dict(shape=[FOLDS, BLOCK_LEN], seconds=time.perf_counter() - t0, kernels={
        r["name"]: dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"]) for r in rows})


def soak_run(mode: str, prep: dict, vcdus, counted: _Counted, streams=None) -> dict:
    """(a) One capture through `long_soak.run` (`FoldedCaptureReceiver`, 128
    folds, `step_int8`) and through `cli reprocess` in its own process.
    With `streams` (`check_fold_kernels`), the fold path's kernels are then
    held against their plain versions on the capture's first two blocks."""
    cfg = long_soak.soak_config(mode)
    cap = np.fromfile(prep["caps"][mode], np.int8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted:
        res = long_soak.run(cfg, cap, vcdus, folds=FOLDS, block_len=BLOCK_LEN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rx, frames = res.pop("receiver"), res.pop("frames")
    # Each fold step again, synchronised, and one under torch.profiler.
    frx = rx._get_rx()
    starts, nblocks = rx._fold_starts(len(cap) // 2)
    buf, noise = np.zeros((FOLDS, 2 * BLOCK_LEN), np.int8), rx._noise(True)
    stepper = _Stepper(frx.step_int8, frx.init_state())
    step_ms = []
    for j in range(nblocks + 2):
        rx._block(cap, starts, j, nblocks, buf, noise, 2)
        step_ms.append(once_ms(lambda: stepper(buf))[1])
    rx._block(cap, starts, 1, nblocks, buf, noise, 2)
    busy, rows = device_kernels(lambda: stepper(buf))
    # `cli reprocess` on the same file, as a user runs it.
    out_dir = os.path.join(prep["tmp"], f"channels_{mode}")
    t0 = time.perf_counter()
    cli_run = subprocess.run(
        [sys.executable, "-m", "xritdemod_tpu_torch.cli", "reprocess", prep["caps"][mode],
         "--format", "s8", "--config", prep["cfgs"][mode], "--out", out_dir],
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    chan = os.path.join(out_dir, f"channel_{long_soak.VCID}.bin")
    chan_bytes = open(chan, "rb").read() if os.path.exists(chan) else b""
    seconds = res["samples"] / cfg.sample_rate
    r = dict(
        mode=mode, seconds_of_signal=seconds, sample_rate=cfg.sample_rate,
        capture_mb=len(cap) / 1e6, **res, wall_s_incl_warmup=wall,
        fold_step_ms=step_ms, device_busy_ms_one_step=busy,
        device_top=[dict(name=k[:60], ms=ms) for k, ms, _ in rows[:6]],
        peak_memory_gb=peak / 1e9,
        cli=dict(rc=cli_run.returncode, seconds=cli_s, x_realtime=seconds / cli_s,
                 stdout=cli_run.stdout.strip().splitlines()[-2:],
                 channel_file_bytes=len(chan_bytes),
                 channel_file_equals_sent=chan_bytes == b"".join(v.tobytes() for v in vcdus)),
    )
    problems = []
    if r["frames_missing"] or r["payload_mismatches"] or r["unexplained"] or r["duplicates"]:
        problems.append("frames lost, corrupted, unexplained or duplicated: "
                        f"{r['missing_counters']} {r['unexplained_frames']}")
    if not r["counters_ascending"]:
        problems.append("counters out of order")
    if cli_run.returncode or not r["cli"]["channel_file_equals_sent"]:
        problems.append(f"cli reprocess: rc {cli_run.returncode}, channel file "
                        f"{len(chan_bytes)} bytes: {cli_run.stderr[-2000:]}")
    r["failures"] = problems
    if streams is not None:
        r["fold_kernels"] = check_fold_kernels(rx, cap, streams)
    return r


def first_difference(names, got, want) -> str | None:
    """The first of the named tensors that differ, with its first index."""
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            idx = (a != b).nonzero()[0].tolist() if a.shape == b.shape else "shape"
            return f"{name} at {idx} (chip_smoke.py mesh_axes)"
    return None


def fused_frames(batch, ok) -> list:
    fok = (batch.frame_ok & ok).cpu().numpy()
    ctr, vcid, vc = batch.counter.cpu().numpy(), batch.vcid.cpu().numpy(), batch.vcdu.cpu().numpy()
    return [(int(c), int(vcid[c, j]), int(ctr[c, j]), vc[c, j].tobytes())
            for c, j in zip(*np.nonzero(fok))]


def mesh_axes(base: CF32, delays, vcdus, counted: _Counted) -> dict:
    """(b) The three axes on a mesh of MESH_ENTRIES repeated `cuda:0`
    entries, each against its unsharded counterpart."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    mesh = pdist.make_host_mesh([DEV] * MESH_ENTRIES)
    C = MESH_CPD * MESH_ENTRIES
    gen = torch.Generator(device=DEV).manual_seed(SEED + 70)
    out = {}

    # Channel axis: demod bit-equal to one unsharded batch; one real coded
    # frame per channel decoded bit-exact.
    x = make_block(base, delays[:C], 0, gen)
    drx = pdist.DistributedChannelReceiver(
        cfg, DecoderConfig(mode="lrit", frames_per_block=1), channels_per_device=MESH_CPD,
        block_len=BLOCK_LEN, mesh=mesh)
    with counted:
        (soft, valid, _), ms = once_ms(lambda: drx.demod_block(x, drx.init_demod_state()))
    ref = Demodulator(cfg, BLOCK_LEN)
    (rs, rv, _), ref_ms = once_ms(lambda: ref.block_batch(x, ref.init_state_batch(C)))
    diff = first_difference(("valid", "soft"), (valid, soft), (rv, rs))
    sym = np.stack([tx.encode_stream(vcdus[s][:1], lrit=True, noise=0.0,
                                     rng=np.random.default_rng(SEED + 71 + s))
                    for s in range(STREAMS)])
    frames = torch.from_numpy(sym).to(DEV).repeat(C // STREAMS, 1)
    frames *= torch.where(torch.arange(C, device=DEV) % 3 == 1, -1.0, 1.0)[:, None]
    frames += 0.3 * torch.randn(frames.shape, generator=gen, device=DEV)
    with counted:
        batch, _ = drx.decode_block(frames, drx.init_tails())
    want = torch.from_numpy(np.stack([vcdus[c % STREAMS][0] for c in range(C)])).to(DEV)
    dec_ok = bool(batch.frame_ok.all()) and torch.equal(batch.vcdu[:, 0], want)
    out["channel_axis"] = dict(
        mesh=mesh.shape, channels=C, block_len=BLOCK_LEN, bit_equal_to_unsharded=diff is None,
        first_difference=diff, ms=ms, unsharded_ms=ref_ms, symbols=int(valid.sum()),
        decode_frames=C, decode_bit_exact=dec_ok, decode_ok=int(batch.frame_ok.sum()))
    del x, soft, valid, rs, rv, frames, batch

    # Time-block axis: D blocks of TB_BLOCK (+ halo) as the rows of one batched
    # split-path launch, frames through a StreamDecoder per block; the rows
    # against one-lane `process` calls on the same extended blocks.
    tcfg = cfg
    dec_ov = dist_worker.tb_decode_overlap(tcfg)
    sig, tbv = dist_worker.timeblock_capture(tcfg, TB_BLOCKS, TB_BLOCK)
    tb = TimeBlockDemodulator(tcfg, make_channel_mesh([DEV] * TB_BLOCKS, "t"),
                              block_len=TB_BLOCK, warmup=dist_worker.TB_WARMUP,
                              decode_overlap=dec_ov)
    xs = from_complex(sig, DEV)
    with counted:
        (tsoft, tvalid), tb_ms = once_ms(lambda: tb.process(xs))
        rows = dist_worker.timeblock_frames(tsoft, tvalid, DEV)
    lane = Demodulator(dataclasses.replace(tcfg, frontend_kernel="split"), tb.halo + TB_BLOCK)
    H, lane_err, lane_over = tb.halo, 0.0, 0
    for d in range(TB_BLOCKS):
        lo = d * TB_BLOCK
        ext = CF32(*(torch.cat([p.new_zeros(H) if d == 0 else p[lo - H : lo],
                                p[lo : lo + TB_BLOCK]]) for p in (xs.re, xs.im)))
        s1, v1, _ = lane.process(ext, lane.init_state())
        v1 = v1 & (torch.arange(v1.shape[0], device=DEV) >= tb.nwarm)
        if not torch.equal(v1, tvalid[d]):
            fail(f"parallel time blocks: block {d}'s valid differs from one-lane process")
        e = (tsoft[d][v1] - s1[v1]).abs()
        lane_err = max(lane_err, float(e.max()))
        lane_over += int((e > 5e-4).sum())
    span = K.CODED_FRAME_SIZE * tcfg.sps
    total = TB_BLOCKS * TB_BLOCK
    sent = {(dist_worker.TB_VCID, dist_worker.TB_COUNTER0 + i): v.tobytes().hex()
            for i, v in enumerate(tbv)}
    got = {(v, c): h for row in rows for v, c, h in row}
    owed = {(dist_worker.TB_VCID, dist_worker.TB_COUNTER0 + i) for i in range(len(tbv))
            if i * span >= 12000 and (i + 1) * span + 1000 <= total}
    seams = [d * TB_BLOCK for d in range(1, TB_BLOCKS)]
    across = sum(1 for _, c in owed
                 if any((c - dist_worker.TB_COUNTER0) * span < s < (c - dist_worker.TB_COUNTER0
                                                                     + 1) * span for s in seams))
    out["timeblock_axis"] = dict(
        blocks=TB_BLOCKS, block_len=TB_BLOCK, halo=H, decode_overlap=dec_ov, num_slots=tb.num_slots,
        frames_sent=len(tbv), frames_owed=len(owed), frames_across_seams=across,
        frames_missing=sorted(c for _, c in owed - set(got))[:8],
        frames_wrong=sum(1 for k, h in got.items() if sent.get(k) != h),
        ms=tb_ms, one_lane_max_abs_err=lane_err, one_lane_symbols_over_5e_4=lane_over)
    out["timeblock_frames"] = rows
    del xs, tsoft, tvalid
    # The split path's kernels against their plain versions on the rows
    # the batched launch was given (halo + block, past 2^17 samples: the
    # slot budget is segmented).
    t0 = time.perf_counter()
    rows_x = np.stack([np.concatenate([np.zeros(H, np.complex64) if d == 0 else
                                       sig[d * TB_BLOCK - H : d * TB_BLOCK],
                                       sig[d * TB_BLOCK : (d + 1) * TB_BLOCK]])
                       for d in range(TB_BLOCKS)])
    errs = check_serial_kernels(tb._demods[tb.mesh.devices[0]], rows_x, "parallel time-block rows",
                                (tcfg.clock_interp,))
    out["timeblock_axis"]["rows_kernels"] = dict(
        shape=list(rows_x.shape), num_slots=tb.num_slots, max_abs_err=errs,
        seconds=time.perf_counter() - t0)

    # Sharded fused: MESH_ENTRIES FusedReceivers of MESH_CPD channels against
    # one FusedReceiver(channels=C), on the same blocks.
    frx = pdist.DistributedFusedReceiver(cfg, DecoderConfig(mode="lrit"),
                                         channels_per_device=MESH_CPD, block_len=BLOCK_LEN,
                                         mesh=mesh)
    urx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=C, block_len=BLOCK_LEN)
    dst, ust = frx.init_state(), urx.init_state()
    got_d, got_u, d_ms, u_ms = [], [], [], []
    for b in range(MESH_FUSED_BLOCKS):
        x = make_block(base, delays[:C], b, gen)
        with counted:
            (db, dok, _, dst), t = once_ms(lambda: frx.step(x, dst))
        d_ms.append(t)
        (ub, uok, _, ust), t = once_ms(lambda: urx.step(x, ust))
        u_ms.append(t)
        got_d += fused_frames(db, dok)
        got_u += fused_frames(ub, uok)
    sentv = {(s + 1, 1000 * (s + 1) + i): v.tobytes() for s in range(STREAMS)
             for i, v in enumerate(vcdus[s])}
    comp = {bytes(255 - x for x in v) for v in sentv.values()}
    exact = sum(1 for _, v, c, b in got_d if sentv.get((v, c)) == b)
    complements = sum(1 for _, v, c, b in got_d if sentv.get((v, c)) != b and b in comp)
    out["sharded_fused"] = dict(
        mesh=mesh.shape, channels=C, blocks=MESH_FUSED_BLOCKS, frames=len(got_d),
        frames_equal_to_unsharded=got_d == got_u, frames_exact=exact,
        frames_complement=complements, frames_wrong=len(got_d) - exact - complements,
        ms_per_step=d_ms, unsharded_ms_per_step=u_ms)
    return out


def two_process_run(prep: dict, tb_rows) -> dict:
    """(c) Two `tools/dist_worker.py` ranks on this card (gloo, a `file://`
    store, 2 entries each); their time-block frames against (b)'s."""
    store = os.path.join(prep["tmp"], "store")
    outs = [os.path.join(prep["tmp"], f"tb{r}.json") for r in range(2)]
    cmd = lambda r: [
        sys.executable, "-m", "xritdemod_tpu_torch.tools.dist_worker", str(r), "2",
        f"file://{store}", "gloo", "cuda:0", "2", "--rate", "1250000",
        "--tb-block", str(TB_BLOCK), "--channels-per-device", str(MESH_CPD),
        "--channel-block", str(BLOCK_LEN), "--fused-block", str(1 << 15), "--tb-out", outs[r]]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    got = {}
    for path in outs:
        if os.path.exists(path):
            got.update(json.load(open(path)))
    return dict(
        ranks=2, backend="gloo", device="cuda:0", entries_per_rank=2, seconds=seconds,
        rcs=[p.returncode for p in procs], all_ok=["ALL OK" in log for log in logs],
        timeblock_frames_equal=[got.get(str(d)) for d in range(TB_BLOCKS)] == tb_rows,
        log=[log.strip().splitlines()[-6:] for log in logs])


def parallel_phase(smi: str, prep: dict, base: CF32, delays, vcdus) -> dict:
    """The parallel layer on the card.

    (a) The soak at full width: 60 s of LRIT at 1.25 Msps (100 ppm clock
        drift, 2e-5 carrier drift, s8 wire) through `long_soak.run`
        (`FoldedCaptureReceiver`, 128 folds: 6 blocks and 2 flush steps of
        `step_int8` at C = 128) and through `cli reprocess` as a process;
        then 10 s of HRIT at 3 Msps the same way.  Every sent frame
        bit-exact, counters ascending, no duplicate; a frame not sent only
        as the exact complement of a sent one (counted apart); the channel
        file equal to the sent VCDUs.
    (b) `mesh_axes`: the channel axis, the time-block axis and the sharded
        fused receive on a mesh of 4 `cuda:0` entries.
    (c) `two_process_run`: two ranks of `tools/dist_worker.py`.
    The launches of the paths (not of their references) are counted.  The
    fold path's kernels (`check_fold_kernels`, C = 128) and the split
    path's on the time-block rows (past 2^17 samples: a segmented slot
    budget) are held against their plain versions."""
    sent = {m: j.result() for m, j in prep["jobs"].items()}
    prep["pool"].shutdown()
    counted = _Counted()
    soak = {m: soak_run(m, prep, sent[m], counted, vcdus if m == "lrit" else None)
            for m in ("lrit", "hrit")}
    axes = mesh_axes(base, delays, vcdus, counted)
    tb_rows = axes.pop("timeblock_frames")
    two = two_process_run(prep, tb_rows)
    say("parallel", card=smi, soak=soak, **axes, two_process=two, launches=counted.total,
        tolerance=f"bit-equal; one-lane process against the batched time-block rows: "
                  f"valid equal, soft within {TB_LANE_TOL}, frames bit-exact; the fold path's "
                  f"and the segmented budget's kernels against their plain versions: 1e-4")
    for m, r in soak.items():
        if r["failures"]:
            fail(f"parallel soak ({m}): {r['failures']}")
    ca, tb, sf = axes["channel_axis"], axes["timeblock_axis"], axes["sharded_fused"]
    if not ca["bit_equal_to_unsharded"] or not ca["decode_bit_exact"]:
        fail(f"parallel channel axis: {ca}")
    if tb["frames_missing"] or tb["frames_wrong"] or not tb["frames_across_seams"] \
            or not tb["one_lane_max_abs_err"] <= TB_LANE_TOL:
        fail(f"parallel time blocks: {tb}")
    if not sf["frames_equal_to_unsharded"] or sf["frames_wrong"] \
            or sf["frames_complement"] > max(1, sf["channels"] // 100) \
            or sf["frames_exact"] < 2 * sf["channels"]:
        fail(f"parallel sharded fused: {sf}")
    if any(two["rcs"]) or not all(two["all_ok"]) or not two["timeblock_frames_equal"]:
        fail(f"parallel two processes: {two}")
    check_counts("parallel path", counted.total, PARALLEL_KERNELS)
    return counted.total


# --------------------------------------------------------------------------
# the measuring tools
# --------------------------------------------------------------------------

BER_SNRS = [-2.0, -1.0, 0.0, 1.0, 2.0, 4.0, 8.0]    # BER_SWEEP_r05's points
BER_FRAMES, BER_HRIT_FRAMES = 64, 32
BER_HRIT_SNRS = [-1.0, 0.0, 4.0]
# HRIT's differential decoding doubles the Viterbi's bit errors, so its
# margin lies above LRIT's: on these draws the JAX package's own tool
# (`tools/ber_sweep.py --mode hrit --frames 32 --snrs -1,0,4`, on the CPU)
# recovers 25 and 31 of 32 frames at -1 and 0 dB (BER_SWEEP_r02, on its
# TPU: 11 of 12 at -1 dB).  Below 4 dB the port must recover exactly those.
BER_HRIT_REFERENCE = {-1.0: 25, 0.0: 31}
MARGIN_SNRS = [-1.0, 0.0, 1.0, 2.0, 3.0, 5.0]        # VITERBI_MARGIN_r04's grid
MARGIN_SEGMENTS, MARGIN_OVERLAPS = [4, 8, 16], [64, 128, 256]
INTERP_SIGMAS = [0.01, 0.05, 0.08]
SCALING_CHANNELS = [128, 512, 1024, 2048]
SCALING_MESH = [1, 2, 4]
DECODE_B = 256
# The kernels each tool must launch (on the card, never their plain versions).
TOOL_KERNELS = {
    "ber_sweep": ("viterbi",),
    "viterbi_margin_sweep": ("viterbi",),
    "interp_margin": ("frontend", "clock", "clock_sinc", "ring_append", "ring_extract",
                      "viterbi"),
    "scaling_sweep": ("frontend", "clock"),
    "rx_profile": ("frontend", "clock", "ring_append", "ring_extract", "viterbi", "rs",
                   "acquire"),
    "decode_profile": ("viterbi", "rs"),
    "decode_bench": ("viterbi",),
    "chain_bench": ("agc_block", "costas_block", "clock"),
    "stage_profile": ("frontend", "clock_sinc"),
    "clock_bench": ("clock", "clock_sinc", "clock_bu"),
    "frontend_bench": ("frontend", "clock", "agc_block", "costas_block", *FRONTEND_FORMS),
    "host_budget_profile": ("frontend", "clock"),
    "drive_demod": ("frontend", "clock"),
}


def _repo_json(name: str):
    path = Path(__file__).resolve().parent / name
    return json.loads(path.read_text()) if path.exists() else None


def first_point_apart(got: list, want: list | None, keys: tuple):
    """None when the rows agree on `keys` point for point, else the first
    pair that differs (or why they cannot be compared)."""
    if want is None:
        return "reference file missing"
    if len(got) != len(want):
        return f"{len(got)} points against {len(want)}"
    for g, w in zip(got, want):
        if any(g.get(k) != w.get(k) for k in keys):
            return dict(port={k: g.get(k) for k in keys}, reference={k: w.get(k) for k in keys})
    return None


def stage_split(res: dict) -> dict:
    """Each component's ms with the sum of the components beside the whole."""
    return dict(ms=res["ms"], whole=res["whole"], whole_ms=res["whole_ms"],
                stages_of_whole=res.get("stages_of_whole"), stage_sum_ms=res["stage_sum_ms"])


def tools_phase(smi: str) -> dict:
    """The repo's measuring tools, ported (`xritdemod_tpu_torch/tools/`),
    each run in this process through its own function at the sizes below,
    one line a tool; the launches of each counted apart.  Gates: the BER
    sweep decodes every frame bit-exact from -1 dB (LRIT in both of
    BER_SWEEP_r05's variants, which must agree point for point; HRIT at
    4 dB, and below it exactly the frames the JAX package's tool recovers);
    the segmented Viterbi equals the exact one bit for bit on
    VITERBI_MARGIN_r04's whole grid; the interpolators' full channels within
    the JAX tool's rule and 128 of 128 at sigma 0.01; every profiler runs,
    its numbers finite, its kernels launched."""
    from xritdemod_tpu_torch.tools import (
        ber_sweep, chain_bench, clock_bench, decode_bench, decode_profile, drive_demod,
        frontend_bench, host_budget_profile, interp_margin, rx_profile, scaling_sweep,
        stage_profile, viterbi_margin_sweep,
    )

    launches: dict = {}
    seconds: dict = {}

    def run(tool: str, fn):
        counted = _Counted()
        t0 = time.perf_counter()
        with counted:
            out = fn()
        torch.cuda.synchronize()
        seconds[tool] = time.perf_counter() - t0
        launches[tool] = {k: n for k, n in counted.total.items() if n}
        missing = [k for k in TOOL_KERNELS[tool] if not counted.total.get(k)]
        if missing:
            fail(f"tools: {tool} never launched {missing}")
        torch.cuda.empty_cache()
        return out

    def line(tool: str, **kw):
        say("tools", tool=tool, card=smi, seconds=seconds[tool], launches=launches[tool], **kw)

    # BER and frame success through StreamDecoder (BER_SWEEP_r05's protocol).
    r05 = _repo_json("BER_SWEEP_r05.json")
    ber = run("ber_sweep", lambda: dict(
        lrit_a=ber_sweep.run_sweep("lrit", BER_FRAMES, BER_SNRS, device=DEV),
        lrit_b=ber_sweep.run_sweep("lrit", BER_FRAMES, BER_SNRS, frames_per_block=64,
                                   segments=8, device=DEV),
        hrit=ber_sweep.run_sweep("hrit", BER_HRIT_FRAMES, BER_HRIT_SNRS, device=DEV)))
    keys = ("snr_db", "frames_ok", "frame_success", "post_fec_ber", "avg_vit_corrections")
    line("ber_sweep", variants=dict(a=dict(fpb=4, segments=-1), b=dict(fpb=64, segments=8)),
         **ber, variants_identical=ber["lrit_a"] == ber["lrit_b"],
         equal_to_r05=[all(g[k] == w[k] for k in keys) for g, w in zip(
             ber["lrit_a"], r05["points"] if r05 else [])],
         first_point_apart_from_r05=first_point_apart(
             ber["lrit_a"], r05 and r05["points"], keys))
    bad = [(v, r["snr_db"]) for v in ber for r in ber[v]
           if (v, r["snr_db"]) not in {("hrit", s) for s in BER_HRIT_REFERENCE}
           and r["snr_db"] >= -1.0 and (r["frame_success"] != 1.0 or r["post_fec_ber"] != 0.0)]
    bad += [("hrit", r["snr_db"], r["frames_ok"]) for r in ber["hrit"]
            if r["snr_db"] in BER_HRIT_REFERENCE
            and r["frames_ok"] != BER_HRIT_REFERENCE[r["snr_db"]]]
    if bad or ber["lrit_a"] != ber["lrit_b"]:
        fail(f"tools: ber_sweep below its margin at {bad}, or the variants differ")

    r04 = _repo_json("VITERBI_MARGIN_r04.json")
    margin = run("viterbi_margin_sweep", lambda: viterbi_margin_sweep.run(
        BER_FRAMES, MARGIN_SNRS, MARGIN_SEGMENTS, MARGIN_OVERLAPS, device=DEV, log=None))
    line("viterbi_margin_sweep", frames_per_point=BER_FRAMES, rows=margin,
         first_point_apart_from_r04=first_point_apart(
             margin, r04 and r04["results"], ("snr_db", "segments", "overlap", "bit_mismatch",
                                              "frame_success_exact", "frame_success_seg",
                                              "frames_diverged")))
    bad = [r for r in margin if r["bit_mismatch"] != 0.0 or r["frames_diverged"]]
    if bad:
        fail(f"tools: the segmented Viterbi differs from the exact one: {bad}")

    rm = _repo_json("INTERP_MARGIN_r05.json")
    im = run("interp_margin", lambda: interp_margin.sweep(INTERP_SIGMAS, 128, 4, device=DEV))
    ref = {(p["interp"], p["sigma"]): p for p in (rm["points"] if rm else [])}
    line("interp_margin", capture_frames=im["capture_frames"], points=im["points"],
         r05_channels_full={f"{p['interp']} {p['sigma']}": ref.get(
             (p["interp"], p["sigma"]), {}).get("channels_full") for p in im["points"]},
         r05_frames_recovered={f"{p['interp']} {p['sigma']}": ref.get(
             (p["interp"], p["sigma"]), {}).get("frames_recovered") for p in im["points"]})
    full = {(p["interp"], p["sigma"]): p["channels_full"] for p in im["points"]}
    if interp_margin.margin_failures(im["points"], 128) \
            or full["mmse", 0.01] != 128 or full["sinc", 0.01] != 128:
        fail(f"tools: interp_margin: {full}")

    sc = run("scaling_sweep", lambda: dict(
        channels=scaling_sweep.sweep_channels(SCALING_CHANNELS, device=DEV),
        mesh=scaling_sweep.sweep_mesh(SCALING_MESH, device=DEV)))
    line("scaling_sweep", **sc, note=scaling_sweep.MESH_NOTE)
    if not all(r["soft_finite"] for r in sc["channels"] + sc["mesh"]):
        fail(f"tools: scaling_sweep gave soft symbols that are not finite: {sc}")

    profiles = [
        ("rx_profile", lambda: rx_profile.profile(1024, 1 << 17, 6, device=DEV)),
        ("decode_profile", lambda: decode_profile.profile(DECODE_B, 6, DEV)),
        ("decode_bench", lambda: decode_bench.bench(DECODE_B, 5, DEV)),
        ("chain_bench", lambda: chain_bench.bench(512, 1 << 18, 5, 2, DEV)),
        ("stage_profile", lambda: stage_profile.profile(512, 1 << 17, 8, "sinc", DEV)),
        ("clock_bench", lambda: clock_bench.bench(device=DEV)),
        ("frontend_bench", lambda: dict(
            both=frontend_bench.bench("both", device=DEV),
            split=frontend_bench.bench("split", device=DEV))),
        ("host_budget_profile", lambda: host_budget_profile.profile(device=DEV)),
    ]
    for tool, fn in profiles:
        res = run(tool, fn)
        parts = res.values() if tool == "frontend_bench" else [res]
        if not all(p["all_finite"] for p in parts):
            fail(f"tools: {tool} gave numbers that are not finite: {res}")
        per_call = res.pop("launches", None)
        extra = stage_split(res) if "stage_sum_ms" in res else {}
        line(tool, **{k: v for k, v in res.items() if k not in extra}, **extra,
             launches_per_call=per_call)

    dd = run("drive_demod", lambda: drive_demod.drive(512, 3, device=DEV))
    line("drive_demod", **dd)
    if not dd["ok"]:
        fail(f"tools: drive_demod failed its checks: {dd}")
    return launches


device_kernels = timing.device_kernels
device_busy_ms = timing.device_busy_ms


def profile_steps(step, base: CF32, delays, step_ms: float,
                  first: int = BLOCKS + INT8_BLOCKS) -> dict:
    """`--profile`: the capture's blocks from `first` on through `step(x)` under
    torch.profiler: where a step's device time goes, by kernel name, and an
    ESTIMATE of the device's idle share of a step: device busy time under the
    profiler against the step time measured without it (`step_ms`).  The two
    come from different runs of the step because the profiler slows the host
    many times over, so its own wall time says nothing."""
    steps = PROFILE_STEPS
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    blocks = [make_block(base, delays, first + i, gen) for i in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy_ms, rows = device_kernels(lambda: [step(x) for x in blocks])
    wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(
        steps=steps, wall_ms_per_step_under_profiler=wall_ms / steps,
        step_ms_without_profiler=step_ms, device_busy_ms_per_step=busy_ms / steps,
        device_idle_share_estimate=max(0.0, 1.0 - busy_ms / steps / step_ms),
        device_kernels_per_step=sum(r[2] for r in rows) / steps,
        top=[dict(name=k[:60], ms_per_step=ms / steps, calls_per_step=n / steps)
             for k, ms, n in rows[:14]],
    )


class _Stepper:
    """Carries a path's state from one profiled step to the next."""

    def __init__(self, fn, state):
        self.fn, self.state = fn, state

    def __call__(self, x) -> None:
        self.state = self.fn(x, self.state)[-1]


def kernel_frames(log: str, mangled: str, param: str = "i") -> dict:
    """`ptxas -v`'s stack frame, spill stores and spill loads (bytes) of
    every instance `<N>` of the kernel template `mangled`, by N (`param`:
    the template parameter's mangled type, "i" int, "b" bool)."""
    out = {}
    for n, frame, stores, loads in re.findall(
            rf"Function properties for {mangled}IL{param}(\d+)EEv\S*\s+"
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log):
        out[n] = [int(frame), int(stores), int(loads)]
    return out


# The slab kernels' instances (K1's `frontend_slab_kernel`, K6's
# `costas_spread_kernel` and `stream_kernel<CostasSlabOp>`), by mangled name.
SLAB_KERNEL_NAMES = re.compile(
    r"_Z20frontend_slab_kernel\S*|_Z20costas_spread_kernel\S*|_Z13stream_kernelI12CostasSlabOp\S*")


def slab_frames(log: str) -> dict:
    """`ptxas -v`'s stack frame, spill stores and spill loads (bytes) of
    every slab kernel instance, by mangled name."""
    return {name: [int(frame), int(stores), int(loads)] for name, frame, stores, loads in re.findall(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads", log) if SLAB_KERNEL_NAMES.fullmatch(name)}


def main() -> None:
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = smi[0] if smi else "unknown"
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    built = _build.build_all(verbose=True, force=True)
    for name in _build.KERNELS:
        _build.load(name)
    k3 = kernel_frames(built["log"], "_Z14viterbi_kernel")
    # K2 by instance: `clock_kernel` 0 mmse, `clock_bu_kernel` its block
    # update on (T, C) (0) and (C, T) (1), `clock_sinc_kernel` 1 sinc and 3
    # its block update.  The sinc instances' stack frame is the
    # large-argument path of `sinf` and `sincos_exact` in their checked
    # steps: no spill.
    k2 = kernel_frames(built["log"], "_Z12clock_kernel")
    k2b = kernel_frames(built["log"], "_Z15clock_bu_kernel", "b")
    k2s = kernel_frames(built["log"], "_Z17clock_sinc_kernel")
    slabs = slab_frames(built["log"])
    k8 = kernel_frames(built["log"], "_Z16rs_decode_kernel")
    # The host library of the apps' sample ring, built here, in this
    # process: the apps line reports which ring they got, and why.
    t_native = time.perf_counter()
    native_ok = native.available()
    say("build", seconds=built["seconds"], built=built["built"],
        directory=str(_build.build_dir()), ptxas=[
            ln for ln in built["log"].splitlines() if "registers" in ln or "spill" in ln],
        viterbi_instances=k3, clock_instances=k2, clock_bu_instances=k2b,
        clock_sinc_instances=k2s,
        slab_instances=slabs, rs_instances=k8,
        native_library=dict(loaded=native_ok, path=str(native.library_path()),
                            error=native.last_error(),
                            seconds=time.perf_counter() - t_native))
    if len(k3) != len(viterbi_cuda.LANES) or any(any(v) for v in k3.values()):
        fail(f"viterbi: every instance must build without stack frame or spill: {k3}")
    if sorted(k2) != ["0"] or sorted(k2b) != ["0", "1"] or sorted(k2s) != ["1", "3"] \
            or any(v[1] or v[2] for v in [*k2.values(), *k2s.values()]) \
            or any(any(v) for v in [*k2.values(), *k2b.values()]):
        fail(f"clock: every instance must build without spill, mmse without stack frame: "
             f"{k2}, {k2b}, {k2s}")
    # K1's 16 slab instances, K6's three spread instances and its lane-a-channel one.
    if len(slabs) != 20 or any(any(v) for v in slabs.values()):
        fail(f"slab kernels: every instance must build without stack frame or spill: {slabs}")
    # K8's two entries (G = 1 codewords, G = 4 frames) within their 64 registers.
    if sorted(k8) != ["1", "4"] or any(any(v) for v in k8.values()):
        fail(f"rs: both instances must build without stack frame or spill: {k8}")

    if UNDER_LOAD_ONLY:
        cfg = DemodConfig.lrit(sample_rate=1_250_000)
        _, _, base = make_streams(cfg)
        say("under_load", card=smi, **under_load_phase(cfg, DecoderConfig(mode="lrit"), base,
                                                       channel_delays()))
        say("total", seconds=time.perf_counter() - t_start, seconds_up_to_each_line=PHASE_S)
        print(smi, flush=True)
        return

    say("fir", card=smi, **check_fir())
    say("fir_matmul", card=smi, **check_fir_matmul())
    torch.cuda.empty_cache()
    say("scan", card=smi, **check_scan())
    app_captures = start_app_captures()
    parallel_captures = start_parallel_captures()

    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    dcfg = DecoderConfig(mode="lrit")
    rx = FusedReceiver(cfg, dcfg, channels=CHANNELS, block_len=BLOCK_LEN)
    vcdus, esn0_db, base = make_streams(cfg)
    delays = channel_delays()

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    x0, x1 = (make_block(base, delays, b, gen) for b in (0, 1))
    rows = check_kernels(rx, x0, x1, vcdus)
    del x0, x1
    # Decisions written once and read back once, 8 B a window-step: computed,
    # not measured, so on a line of its own.
    k3 = next(r for r in rows if r["name"] == "viterbi")
    say("viterbi", windows=k3["windows"], steps=k3["steps"], lanes=k3["lanes"],
        decision_traffic_floor_ms=2 * 8.0 * k3["windows"] * k3["steps"] / PEAK_BYTES * 1e3)
    torch.cuda.empty_cache()
    rows.append(check_rs())
    rows.append(check_acquire(rx))
    # K8's and K9's cases, each with its device time beside its eager time.
    say("decisions", card=smi, **{r["name"]: {k: v for k, v in r.items() if k != "name"}
                                  for r in rows[-2:]})
    torch.cuda.empty_cache()
    rows.append(check_roll())
    say("kernels", card=smi, ragged_shapes_max_abs_err=check_ragged(rx), kernels=[
        dict(name=r["name"], max_abs_err=r["max_abs_err"], tolerance=r["tolerance"],
             kernel_ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
             **({"nearest_library_call": r["nearest_library_call"]}
                if "nearest_library_call" in r else {}))
        for r in rows])

    main_blocks: list = []
    main_fills: list = []
    counts, state, main_ms, delivered = main_path(rx, base, delays, vcdus, esn0_db, cl_block=2,
                                                  per_block=main_blocks, fills=main_fills)
    if PROFILE:
        say("profile", card=smi, path="main_path", **profile_steps(
            _Stepper(rx.step, clone_state(state)), base, delays,
            float(np.mean(main_ms[1:BLOCKS]))))

    split_counts, demod, dstate, split_ms = split_path(cfg, base, delays, vcdus, delivered, smi)
    if PROFILE:
        say("profile", card=smi, path="split_path (block_batch only)", **profile_steps(
            _Stepper(demod.block_batch, dstate), base, delays, split_ms))
    del demod, dstate
    torch.cuda.empty_cache()

    onchip_rows, onchip_counts = onchip_phase(
        cfg, dcfg, base, delays, vcdus, esn0_db,
        dict(rx=rx, state=state, ms=main_ms, per_block=main_blocks, delivered=delivered),
        dict(ms=split_ms), rows, smi)
    say("ring_steady", card=smi, block=RING_STEADY_BLOCK, **ring_steady(
        rows + onchip_rows, main_fills[RING_STEADY_BLOCK], rx.ring_len, rx._demod.num_slots,
        int(BLOCK_LEN / cfg.decimation / cfg.sps)))
    del rx, state, main_fills
    torch.cuda.empty_cache()
    say("under_load", card=smi, **under_load_phase(cfg, dcfg, base, delays))
    say("clock_max_block", card=smi, **clock_max_block_phase(cfg, base, delays, smi))
    torch.cuda.empty_cache()

    # The fused receive with the sinc interpolator: K2's other instance on
    # the main path's shapes, under the same gate, a warm-up and 3 steady
    # blocks.
    rx = FusedReceiver(dataclasses.replace(cfg, clock_interp="sinc"), dcfg, channels=CHANNELS,
                       block_len=BLOCK_LEN)
    sinc_counts, state, sinc_ms, _ = main_path(rx, base, delays, vcdus, esn0_db,
                                               blocks=SINC_BLOCKS, int8_blocks=0,
                                               label="sinc_path", expected=SINC_PATH_KERNELS)
    # The two interpolators on the same blocks of the same capture (blocks
    # 1 .. SINC_BLOCKS - 1: channels still acquire in both).
    same = slice(1, SINC_BLOCKS)
    say("sinc_vs_mmse", card=smi, blocks=list(range(1, SINC_BLOCKS)),
        mmse_ms=main_ms[same], sinc_ms=sinc_ms[same],
        sinc_minus_mmse_ms=float(np.mean(sinc_ms[same]) - np.mean(main_ms[same])))
    if PROFILE:
        say("profile", card=smi, path="sinc_path", **profile_steps(
            _Stepper(rx.step, state), base, delays, float(np.mean(sinc_ms[same])),
            first=SINC_BLOCKS))
    del rx, state
    torch.cuda.empty_cache()

    say("kat", **kat_phase(smi))
    serial_path(smi)
    torch.cuda.empty_cache()
    apps_counts = apps_phase(smi, app_captures)
    say("decode_multi", **decode_multi_phase(vcdus, smi))
    torch.cuda.empty_cache()
    say("rs_sparse", card=smi, **rs_sparse_phase(vcdus, smi))
    torch.cuda.empty_cache()
    parallel_counts = parallel_phase(smi, parallel_captures, base, delays, vcdus)
    torch.cuda.empty_cache()
    tools_counts = tools_phase(smi)

    # The roll probe is a tool, not a stage of either receive path: its path
    # is its own entry point.
    reset_counts()
    probe = roll_probe.main()
    roll_counts = read_counts()
    say("roll_probe", card=smi, dtypes=probe, launches=roll_counts)
    check_counts("roll probe", roll_counts, ("roll",))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # The new instances: launches from the path that runs each (the on-chip
    # fused receive, the block-update split path, the forms' block_batch, or
    # K1's one-loop forms called as their op).
    for r in onchip_rows:
        for path in ("fused", "split", "forms", "stages"):
            n = onchip_counts[path].get(r["name"], 0)
            if n and "launches" not in r:
                r["launches"], r["path"] = n, f"onchip_{path}"
        if not r.get("launches"):
            fail(f"onchip: no path launched {r['name']}")
    for r in rows:
        name = r["name"]
        if name in MAIN_PATH_KERNELS:
            r["launches"] = counts[name]
            if name in SPLIT_PATH_KERNELS:
                r["launches_split_path"] = split_counts[name]
        elif name in SPLIT_PATH_KERNELS:
            r["launches"] = split_counts[name]
        elif name in SINC_PATH_KERNELS:
            r["launches"] = sinc_counts[name]
        else:
            r["launches"] = roll_counts[name]
        if name in APPS_KERNELS:
            r["launches_apps"] = apps_counts[name]
        if name in PARALLEL_KERNELS:
            r["launches_parallel"] = parallel_counts[name]
    for r in rows + onchip_rows:
        r["launches_tools"] = {t: c[r["name"]] for t, c in tools_counts.items()
                               if c.get(r["name"])}
    say("total", seconds=time.perf_counter() - t_start, seconds_up_to_each_line=PHASE_S)
    print(smi, flush=True)
    extra = ("launches_split_path", "launches_apps", "launches_parallel", "launches_tools",
             "lanes", "split_shapes", "form", "path", "exact_ms", "split_shape", "steady",
             "replaces_kind", "clean_ms", "clean_bound_ms", "errored_rows", "steady_ms",
             "ms_is", "device_ms", "device_ms_is", "clean_device_ms", "steady_device_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows + onchip_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
