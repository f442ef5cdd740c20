"""Probe: what sets the time of the hand-written kernels: the front end
(K1; its slab forms at block_k 8 on both loops, `frontend_bk8` and
`frontend_bk8_bf16`, and on one loop, `frontend_bk8_agc` and
`frontend_bk8_costas`), the clock (K2: its mmse instance `clock`, its sinc
instance `clock_sinc`, and their block updates at K = 16, `clock_bu` and
`clock_bu_sinc`), the Viterbi decoder (K3), the symbol ring (K4, `ring`),
the standalone AGC (K5) and Costas loop (K6; its slab form at K = 8,
`costas_slab`), the RS decoder (K8, `rs`) and the acquisition (K9,
`acquire`).

    python -m xritdemod_tpu_torch.tools.kernel_probe            # needs a GPU and nvcc
    python -m xritdemod_tpu_torch.tools.kernel_probe agc_block costas_block
    python -m xritdemod_tpu_torch.tools.kernel_probe clock clock_sinc clock_bu clock_bu_sinc \
        [--rounds N] [--baseline OTHER/clock.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe frontend_bk8 frontend_bk8_bf16 \
        frontend_bk8_agc frontend_bk8_costas [--rounds N] [--baseline OTHER/frontend.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe costas_slab [--rounds N] \
        [--baseline OTHER/stream.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe viterbi [--rounds N] [--baseline OTHER/viterbi.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe ring [--rounds N] [--baseline OTHER/ring.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe rs acquire [--rounds N] \
        [--baseline OTHER/rs.cu] [--baseline OTHER/acquire.cu]
    python -m xritdemod_tpu_torch.tools.kernel_probe clock_sinc --variant tails \
        [--baseline OTHER/clock.cu]      # as shipped and only the variants named so

Times the kernels named on the command line (all by default) at the
shipped LRIT shape (2048 channels x 131072 samples, a synthetic BPSK-like
block) as they are, and then variants of their sources that change one
thing each (`VARIANTS`: a stage's work taken out, a loop unrolled further or
less, a sleep in the barrier wait, channels per block, tile stages, warps
of a stage), built by `_build.build_variant` from edited copies of `csrc/`.
A variant that removes work computes something else: its time says what
that work costs beside the kernel's dependent chain, nothing more.  Last, it
builds and runs `csrc/sched_probe.cu`, which shows which warps of a block
share a scheduler.  One JSON line per measurement, the card's name and power
limit on each.  `--rounds N` times every variant N times, in turn and in
reverse order every other round, and ends with each one's median, least and
most.

K2's instances run at C = 2048 and at one channel (the serial path's and
the apps' count), each variant at both; the mmse block update (`clock_bu`)
also through its `(C, T)` entry and at C = 512 with K 16 and 64.  Every
variant's outputs are held against the shipped build's (`bits_equal`;
false for a cost probe).  A clock source whose mmse block update has no
`(C, T)` entry (`xrit_clock_bu_ct`) takes the `(C, T)` run as the older
wrapper made it: the block's two transposes, then the `(T, C)` entry.
`--baseline PATH` with a clock, front-end or stream source (the entries of
`csrc/clock.cu`, `csrc/frontend.cu` or `csrc/stream.cu` of another commit,
e.g. that commit's `csrc/` saved under `build/`: its own headers beside it
are the ones it includes) times that source's build as one more variant of
each instance of that library named, through the same wrapper, in the same
rounds; `--baseline` may be given once for each library.

K3 runs on the windows the decoder makes of 2048 frames (8192 windows of
2312 steps, the fused step's shape) and of 8 (128 of 770, a `StreamDecoder`
block), every variant at every lanes-per-window instance
(`viterbi_cuda.LANES`); one variant builds the other candidate for
the many-windows instance (LPW 4 or 8) in its slot.  Then the shipped kernel
and that candidate sweep the window counts `CaduDecoder` gives 1 to 16384
frames (`SWEEP_FRAMES`: 16 windows of 770 steps to 16384 of 8224): their
times there set `viterbi_cuda._LANES_RULE`.  `--rounds N` repeats both N
times (one build) and ends with each time's median, least and most over
the rounds, so two instances are told apart only beyond their spread.
`--baseline PATH` adds, at each count, the time of another Viterbi source
with the six-argument entry of the one-warp-per-window kernel
(`xrit_viterbi(soft, dec, bits, NW, T, stream)`, decisions `(NW, T, 2)`
u32), for instance that file of an earlier commit.

K4 (`ring`): the append and the in-place extract, on a float32 and on a
bfloat16 ring of the fused receive's length (C = 2048, L = 72064), at
`chip_smoke.py`'s inputs (random fills, every 97th channel set to
overflow, the clock's count of symbols a block; pops at random positions,
every 61st channel half a frame short) and at the steady state of a
locked receive (pos 0; the fills a receive's bookkeeping reaches after
four blocks from acquisition lags uniform in one frame).  Each row holds
its time beside its bound (`bound_ms`: the bytes the function must move
over 3.35 TB/s, as `chip_smoke.py` counts them) and, in round 0, whether
its ring, fill, flags and pop equal the plain version's (`bits_equal`) and
what one call allocates (`allocated_bytes`).  Each round also times one
`Tensor.copy_` of a float32 ring: the share of the card's peak rate a
plain device copy reaches (a yardstick; the port calls no such copy).  The
variants change the step (vectors a thread, threads a block), the blocks
of a channel's extract (a cluster), where the sources are realigned
(shared memory) and how the append loads them (one bulk copy, TMA).
`--baseline PATH` with another `ring.cu` that keeps the out-of-place
extract (`xrit_ring_extract(ring, fill, pos, ring_out, out, fill_out, ok,
C, L, E, stream)`, e.g. an earlier commit's) times it as one more
variant, its extract writing a ring of its own.

K8 (`rs`) and K9 (`acquire`) are timed by their device time apart from
their wrappers' host time (`timing.graph_ms`: 20 calls captured as a CUDA
graph, replayed between two events) beside the eager time (20 calls
between two events, which a short kernel's host time sets).  K8 runs the
fused step's 8192 codewords on noise (every one errored), clean and with
1 % of them errored (1 to 16 symbol errors), and 32 codewords (a
`decode_block` of 8 frames) clean, on noise and with 4 errored, through
`rs_cuda.rs_decode_kernel`; then the same words as frames (2048 and 8 of
them) through `reed_solomon.rs_decode_frame`, whose kernels a call are
counted under `torch.profiler` (`kernels_per_call`: the copies around the
decoder).  K9 runs the fused receive's rings (C = 2048, its ring length,
`tools/edge_cases.py::acquire_ring`) on float32 and bf16 with all, half and
no channels unlocked.  Their variants (`VARIANTS["rs"]`,
`VARIANTS["acquire"]`: warps and channels a block, blocks an SM, loads in
flight, and cost probes that leave the counting, the loads or the
corrections out) run in the same rounds.  Each row holds its bound (`bound_ms`, as
`chip_smoke.py` counts it: `rs_cuda.bound_work`, `acquire_cuda.bound_work`;
K8's also `table_bound_ms`, the one-warp table algorithm's count,
`rs_cuda.table_work`, the yardstick the parent is read against) and, in round 0, whether its outputs equal the plain version's
(`bits_equal`).  `--baseline PATH` with another `rs.cu` or `acquire.cu`
that keeps the earlier one-warp entries (`xrit_rs_decode(in, out, nerr,
tables, B, stream)` with the 1280-byte tables, its frames de-interleaved
and re-interleaved by copies as that wrapper did; `xrit_acquire(ring,
locked, templates, pos, C, L, P, W, thresh, stream)`), e.g. `git show
d6fe24d:xritdemod_tpu_torch/csrc/rs.cu`, times it in the same rounds, in
turns.

This is how the kernels' layouts were found (PERF.md has the figures); run
it again when a kernel, or the card, changes.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import itertools
import json
import subprocess
import sys

import numpy as np
import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch import constants as K
from xritdemod_tpu_torch.models.decoder import CaduDecoder, DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.ops import (
    acquire_cuda, clock_cuda, correlator, frontend_cuda, reed_solomon, ring_cuda, rs_cuda,
    stream_cuda, viterbi_cuda,
)
from xritdemod_tpu_torch.tools import edge_cases, timing
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["VARIANTS", "LIBRARY", "main"]

CHANNELS, BLOCK_LEN = 2048, 1 << 17

# kernel -> variant name -> text edits (old, new) on the sources under csrc/.
VARIANTS = {
    "frontend": {
        "as shipped": (),
        "FIR products taken out (one block of ring rows per tile)":
            (("for (int jb = 0; jb < blocks; ++jb) {", "for (int jb = 0; jb < 1; ++jb) {"),),
        "chain warps hold 2 samples in registers": (("#define CHAIN 4", "#define CHAIN 2"),),
        "chain warps hold 8 samples in registers": (("#define CHAIN 4", "#define CHAIN 8"),),
        "4 tile stages instead of 3":
            (("#define NX 3 ", "#define NX 4 "), ("#define NF 3 ", "#define NF 4 ")),
        "100 ns sleep between polls of a barrier":
            (("    while (!mbar_try_wait(bar, parity)) {\n        if ((++spins",
              "    while (!mbar_try_wait(bar, parity)) {\n        __nanosleep(100);\n"
              "        if ((++spins"),),
        "large-argument sine/cosine inlined":
            (("__device__ __noinline__ void sincos_large",
              "__device__ __forceinline__ void sincos_large"),),
    },
    "clock": {
        "as shipped": (),
        "1 symbol per turn of the loop":
            (("constexpr int UNROLL = 2;", "constexpr int UNROLL = 1;"),),
        "4 symbols per turn of the loop":
            (("constexpr int UNROLL = 2;", "constexpr int UNROLL = 4;"),),
        "8 symbols per turn of the loop":
            (("constexpr int UNROLL = 2;", "constexpr int UNROLL = 8;"),),
        "symbols not staged for the store warp":
            (("                    sts_f32<0>(out, p0r);\n"
              "                    sts_f32<OUT_PLANE>(out, p0i);\n", ""),),
    },
    "agc_block": {
        "as shipped": (),
        "32 channels per block, 64-sample tiles (the same shared memory)":
            (("#define CPB 16", "#define CPB 32"), ("#define TS 128 ", "#define TS 64 ")),
        "5 tile stages": (("#define NS 6 ", "#define NS 5 "),),
        "7 tile stages": (("#define NS 6 ", "#define NS 7 "),),
        "64-sample tiles": (("#define TS 128 ", "#define TS 64 "),),
        "chain holds 2 samples in registers": (("#define CHAIN 4 ", "#define CHAIN 2 "),),
        "chain holds 8 samples in registers": (("#define CHAIN 4 ", "#define CHAIN 8 "),),
        "1 magnitude warp": (("#define MAG_WARPS 3", "#define MAG_WARPS 1"),),
        "2 magnitude warps": (("#define MAG_WARPS 3", "#define MAG_WARPS 2"),),
        "max-gain clamp tested in the chain's loop":
            (("        if constexpr (CLAMP) __builtin_assume(max_gain > 0.0f);\n", ""),),
    },
    "costas_block": {
        "as shipped": (),
        "32 channels per block, 64-sample tiles (the same shared memory)":
            (("#define CPB 16", "#define CPB 32"), ("#define TS 128 ", "#define TS 64 ")),
        "5 tile stages": (("#define NS 6 ", "#define NS 5 "),),
        "7 tile stages": (("#define NS 6 ", "#define NS 7 "),),
        "64-sample tiles": (("#define TS 128 ", "#define TS 64 "),),
        "chain holds 2 samples in registers": (("#define CHAIN 4 ", "#define CHAIN 2 "),),
        "chain holds 8 samples in registers": (("#define CHAIN 4 ", "#define CHAIN 8 "),),
    },
}

# K2's sinc instances (`clock_sinc_kernel`): lanes a channel, channels a
# block (with 32, two chain warps share each scheduler), the branch-free
# sines and quotients of the unchecked steps; for the exact form also the
# unchecked loop's unroll and the group between two looks at the ring
# (which must hold a group's reach); for the block update the slots
# interpolated together and the ring's size.
_SINC_LAYOUT = {
    "1 lane a channel (32 channels a block, 1 chain warp)":
        (("#define SINC_LPC 8", "#define SINC_LPC 1"),
         ("#define SINC_CPB 16", "#define SINC_CPB 32")),
    "4 lanes a channel (2 chain warps a block)": (("#define SINC_LPC 8", "#define SINC_LPC 4"),),
    "2 lanes a channel (1 chain warp a block)": (("#define SINC_LPC 8", "#define SINC_LPC 2"),),
    "8 channels a block (2 chain warps)": (("#define SINC_CPB 16", "#define SINC_CPB 8"),),
    "32 channels a block (8 chain warps, 2 a scheduler)":
        (("#define SINC_CPB 16", "#define SINC_CPB 32"),),
    "sines and quotients with their branches (sinf, sincos_exact, a / b)":
        (("#define SINC_BRANCH_FREE 1", "#define SINC_BRANCH_FREE 0"),),
}
VARIANTS["clock_sinc"] = {
    "as shipped": (),
    **_SINC_LAYOUT,
    "1 symbol per turn of the loop":
        (("constexpr int SINC_UNROLL = 2;", "constexpr int SINC_UNROLL = 1;"),),
    "4 symbols per turn of the loop":
        (("constexpr int SINC_UNROLL = 2;", "constexpr int SINC_UNROLL = 4;"),),
    "8 symbols between looks at the ring":
        (("constexpr int SINC_GROUP = 32;", "constexpr int SINC_GROUP = 8;"),),
    "16 symbols between looks at the ring":
        (("constexpr int SINC_GROUP = 32;", "constexpr int SINC_GROUP = 16;"),),
    "8 symbols between looks at a ring of 8 chunks":
        (("constexpr int SINC_GROUP = 32;", "constexpr int SINC_GROUP = 8;"),
         ("constexpr int SINC_NCHUNK = 16;", "constexpr int SINC_NCHUNK = 8;")),
}
# How often a sinc chain warp publishes its tail for the others' bound on
# their waits (csrc/clock.cu, sinc_bounds): at every chunk it frees, or at
# every fourth (the others then bound their waits up to 3 chunks lower).
_SINC_TAILS = {
    "tails published every 4th chunk":
        (("if (lane == 0 && tail != tail0) s.tails[warp] = tail;",
          "if (lane == 0 && (tail >> 2) != (tail0 >> 2)) s.tails[warp] = tail;"),),
}
VARIANTS["clock_sinc"].update(_SINC_TAILS)
VARIANTS["clock_bu_sinc"] = {
    "as shipped": (),
    **_SINC_LAYOUT,
    **_SINC_TAILS,
    "2 slots interpolated together":
        (("constexpr int SINC_BU_BATCH = 4;", "constexpr int SINC_BU_BATCH = 2;"),),
    "8 slots interpolated together":
        (("constexpr int SINC_BU_BATCH = 4;", "constexpr int SINC_BU_BATCH = 8;"),),
    "a ring of 8 chunks (256 rows)":
        (("constexpr int SINC_NCHUNK = 16;", "constexpr int SINC_NCHUNK = 8;"),),
}
# K2's mmse block update (`clock_bu_kernel`): lanes a channel and slots a
# lane, channels a block (with 32, two chain warps share each scheduler on
# half the SMs, and a ring of 1024 rows does not fit in shared memory), how
# often the ring's chunks are freed, the ring's rows (with 512, K = 64
# reads device memory), the loader's copy width.
VARIANTS["clock_bu"] = {
    "as shipped": (),
    "16 lanes a channel, 1 slot a lane (2 chain warps a scheduler)":
        (("#define BU_LPC 8", "#define BU_LPC 16"), ("#define BU_SPL 2", "#define BU_SPL 1")),
    "4 slots a lane (passes of 32 slots)": (("#define BU_SPL 2", "#define BU_SPL 4"),),
    "32 channels a block (8 chain warps, 2 a scheduler) and a ring of 512 rows":
        (("#define BU_CPB 16", "#define BU_CPB 32"),
         ("constexpr int BU_SHIFT = 5;", "constexpr int BU_SHIFT = 4;")),
    "chunks freed 4 behind the slowest channel": (("#define BU_FREE 8 ", "#define BU_FREE 4 "),),
    "a ring of 512 rows": (("constexpr int BU_SHIFT = 5;", "constexpr int BU_SHIFT = 4;"),),
    "4-byte copies into the ring": (("    a.vec = bases % 16 == 0", "    a.vec = false"),),
}

# K1's slab kernel (`frontend_slab_kernel`, block_k 8): where its warps sit
# (as shipped the Costas warp has scheduler 3 to itself, the AGC and
# magnitude warps sit among the FIR warps), where the AGC prefix runs, the
# Costas walk's fast paths, and the FIR's cost.  Its channels a block (16)
# are timed against another source through `--baseline` (e.g. one with 32).
_FIR_OUT = (("for (int jb = 0; jb < blocks; ++jb) {", "for (int jb = 0; jb < 1; ++jb) {"),)
_COSTAS_FAST = {
    "Costas walk without its large-argument guard (cost probe)":
        (("    if (fabsf(phase) < SLAB_SMALL_PHASE && fabsf(freq) < SLAB_SMALL_REACH / K) {",
          "    if (true) {"),),
    "Costas wraps stepped in a loop": (("constexpr int WRAP_AHEAD = 4;",
                                        "constexpr int WRAP_AHEAD = 0;"),),
    "Costas quadrant by float -> int -> float":
        (("    if (SMALL || !(fabsf(x) >= SINCOS_SMALL)) sincos_reduced_fadd(x, sn, cs);",
          "    if (SMALL || !(fabsf(x) >= SINCOS_SMALL)) sincos_reduced(x, sn, cs);"),),
}
_K1_SLAB = {
    "as shipped": (),
    "1 magnitude warp":
        (("#define SLAB_MAG_WARPS 3", "#define SLAB_MAG_WARPS 1"),),
    "2 magnitude warps":
        (("#define SLAB_MAG_WARPS 3", "#define SLAB_MAG_WARPS 2"),),
    "gain chain among the FIR warps (Layout's AGC warp)":
        (("#define SLAB_AGC_WARP IDLE7", "#define SLAB_AGC_WARP L::AGC"),),
    "FIR products taken out (cost probe)": _FIR_OUT,
}
VARIANTS["frontend_bk8"] = {
    **_K1_SLAB,
    "AGC prefix on the gain chain (lanes 0-15), not in the magnitude warp":
        (("#define SLAB_PREFIX_IN_MAG 1", "#define SLAB_PREFIX_IN_MAG 0"),),
    **_COSTAS_FAST,
}
VARIANTS["frontend_bk8_bf16"] = dict(_K1_SLAB)
VARIANTS["frontend_bk8_agc"] = {
    **_K1_SLAB,
    "AGC prefix on the gain chain (lanes 0-15), not in the magnitude warp":
        (("#define SLAB_PREFIX_IN_MAG 1", "#define SLAB_PREFIX_IN_MAG 0"),),
}
VARIANTS["frontend_bk8_costas"] = {**_K1_SLAB, **_COSTAS_FAST}
# K6-bk8 (`costas_spread_kernel`): lanes a channel, channels a block, the
# walk's fast paths.
VARIANTS["costas_slab"] = {
    "as shipped": (),
    "1 lane a channel": (("#define SLAB_LPC 8 ", "#define SLAB_LPC 1 "),),
    "2 lanes a channel (1 chain warp)": (("#define SLAB_LPC 8 ", "#define SLAB_LPC 2 "),),
    "4 lanes a channel (2 chain warps)": (("#define SLAB_LPC 8 ", "#define SLAB_LPC 4 "),),
    "8 channels a block (2 chain warps)": (("#define CPB 16", "#define CPB 8"),),
    **_COSTAS_FAST,
}

# The many-windows instance of the shipped rule and the other candidate for
# it, built in its slot of the entry's dispatch (LPW 4 and 8 store decisions
# alike, so its bits are right).
_FEW = viterbi_cuda.LANES[0]
_ALT = 4 if _FEW == 8 else 8
_ALT_VARIANT = f"LPW {_ALT} in the LPW {_FEW} slot"
VARIANTS["viterbi"] = {
    "as shipped": (),
    _ALT_VARIANT: ((f"case {_FEW}: return launch<{_FEW}>(", f"case {_FEW}: return launch<{_ALT}>("),),
    "traceback chunk of 16 steps": (("#define TB 32 ", "#define TB 16 "),),
    "traceback chunk of 64 steps": (("#define TB 32 ", "#define TB 64 "),),
    "decisions not stored (cost probe: its bits are wrong)":
        (("                if (live) {", "                if (false) {"),
         ("            if (lane < steps)\n", "            if (false)\n")),
    "no traceback (cost probe: no bits written)":
        (("for (int c = ntb - 1; c >= 0; --c)", "for (int c = ntb - 1; c >= ntb; --c)"),),
}

# K4 (`ring_append_kernel`, `ring_extract_kernel`): the step of a sweep
# (vectors a thread, threads a block), the blocks of a channel's extract
# (as shipped a cluster of 4), the sources realigned in shared memory, the
# append's sources by one bulk copy.
VARIANTS["ring"] = {
    "as shipped": (),
    "2 vectors a thread a step": (("#define RING_VPT 4", "#define RING_VPT 2"),),
    "8 vectors a thread a step": (("#define RING_VPT 4", "#define RING_VPT 8"),),
    "128 threads a block": (("#define RING_THREADS 256", "#define RING_THREADS 128"),),
    "512 threads a block": (("#define RING_THREADS 256", "#define RING_THREADS 512"),),
    "extract on one block a channel": (("#define RING_CLUSTER 4", "#define RING_CLUSTER 1"),),
    "extract on a cluster of 2 blocks a channel":
        (("#define RING_CLUSTER 4", "#define RING_CLUSTER 2"),),
    "extract on a cluster of 8 blocks a channel":
        (("#define RING_CLUSTER 4", "#define RING_CLUSTER 8"),),
    "extract's sources staged in shared memory":
        (("#define RING_EXTRACT_STAGE 0", "#define RING_EXTRACT_STAGE 1"),),
    "append's sources by one bulk copy (TMA) into shared memory":
        (("#define RING_APPEND_TMA 0", "#define RING_APPEND_TMA 1"),),
}

# K8 (`rs_decode_kernel`): warps a block (the syndrome bytes a warp follow),
# blocks an SM of the persistent grid, the discrepancy's reduction, when the
# queue of errored rows is corrected.
VARIANTS["rs"] = {
    "as shipped": (),
    "8 warps a block": (("#define RS_WARPS 16 ", "#define RS_WARPS 8 "),),
    "one block an SM": (("#define RS_BLOCKS_PER_SM 2", "#define RS_BLOCKS_PER_SM 1"),),
    "Berlekamp-Massey's XOR by shuffles, not one reduction":
        (("    return (int)__reduce_xor_sync(0xffffffffu, (unsigned)v);",
          "#pragma unroll\n    for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);\n"
          "    return v;"),),
    "each tile's errored rows corrected with it (no queue across tiles)":
        (("#define RS_FLUSH 16", "#define RS_FLUSH 1"),),
    "no errored row corrected (cost probe: its rows are wrong)":
        (("        for (int q = warp; q < nq; q += RS_WARPS) {",
          "        for (int q = warp; q < 0; q += RS_WARPS) {"),),
}
# K9 (`acquire_kernel`): warps a block, channels a block, loads in flight.
VARIANTS["acquire"] = {
    "as shipped": (),
    "float32: 8 warps a block": (("#define ACQ_F32_WARPS 16", "#define ACQ_F32_WARPS 8"),),
    "float32: 4 channels a block": (("#define ACQ_F32_CPB 8", "#define ACQ_F32_CPB 4"),),
    "bf16: 16 warps a block": (("#define ACQ_BF16_WARPS 8", "#define ACQ_BF16_WARPS 16"),),
    "bf16: 4 channels a block": (("#define ACQ_BF16_CPB 2", "#define ACQ_BF16_CPB 4"),),
    "bf16 signs by integer compares of the halves":
        (("        s |= (uint32_t)(__uint_as_float(w[i] << 16) < 0.0f) << (2 * i)\n"
          "             | (uint32_t)(__uint_as_float(w[i] & 0xFFFF0000u) < 0.0f) << (2 * i + 1);",
          "        s |= (uint32_t)(((w[i] & 0xFFFFu) - 0x8001u) < 0x7F80u) << (2 * i)\n"
          "             | (uint32_t)(((w[i] >> 16) - 0x8001u) < 0x7F80u) << (2 * i + 1);"),),
    "5 loads in flight a thread": (("#define ACQ_INFLIGHT 9", "#define ACQ_INFLIGHT 5"),),
    "LRIT's second word by its own popcounts":
        (("    const bool comp = W == 2 &&", "    const bool comp = false &&"),),
    "lags not counted (cost probe: its positions are wrong)":
        (("        uint32_t best = comp   ? count_lags",
          "        uint32_t best = 0u;\n        if (false) best = comp ? count_lags"),),
    "symbols not loaded (cost probe: its positions are wrong)":
        (("x[i] = v < nvec ? reinterpret_cast", "x[i] = false ? reinterpret_cast"),),
}

# The library (`csrc/<name>.cu`) that holds each kernel.
LIBRARY = {"frontend": "frontend", "frontend_bk8": "frontend", "frontend_bk8_bf16": "frontend",
           "frontend_bk8_agc": "frontend", "frontend_bk8_costas": "frontend",
           "clock": "clock", "clock_sinc": "clock", "clock_bu": "clock", "clock_bu_sinc": "clock",
           "agc_block": "stream", "costas_block": "stream", "costas_slab": "stream",
           "viterbi": "viterbi", "ring": "ring", "rs": "rs", "acquire": "acquire"}
# The entry that marks a baseline source as that library's.
_ENTRY = {"clock": "xrit_clock_sinc", "frontend": "xrit_frontend_form",
          "stream": "xrit_costas_slab", "ring": "xrit_ring_append", "rs": "xrit_rs_decode",
          "acquire": "xrit_acquire"}
# The probes that take their own inputs and their own baseline's entry.
OWN_PROBES = ("viterbi", "ring", "rs", "acquire")

# K2's instances: (interpolator, chunk K); timed at C = CHANNELS and at one
# channel (the serial path's and the apps' count); the mmse block update
# also through its `(C, T)` entry, and at C = 512 with K = 16 and K = 64.
CLOCKS = {"clock": ("mmse", 0), "clock_sinc": ("sinc", 0), "clock_bu": ("mmse", 16),
          "clock_bu_sinc": ("sinc", 16)}
BU_WIDE_C = 512


# Frames per `CaduDecoder` call whose Viterbi windows the sweep times.
SWEEP_FRAMES = (1, 8, 64, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def decoder_windows(frames: int, dev, seed: int = 7) -> torch.Tensor:
    """The `(NW, 2*Lw)` soft windows `CaduDecoder` hands K3 for `frames`
    frames of random soft symbols (S from its rule, overlap 128; past 4096
    frames the rule gives S = 1: one window a frame)."""
    dec = CaduDecoder(DecoderConfig(mode="lrit"), device=dev)
    n = K.CODED_FRAME_SIZE + K.LAST_FRAME_DATA_BITS   # a frame and its history
    gen = torch.Generator(device=dev).manual_seed(seed)
    soft = torch.randn((frames, n), generator=gen, device=dev)
    segs = dec._segments(frames)
    return viterbi_cuda.segment_windows(soft, segs, 128)[0] if segs >= 2 else soft


def _baseline(path: str):
    """`decode(soft)` through the Viterbi source at `path` (six-argument entry)."""
    lib = _build.build_dir() / "variants" / "viterbi_baseline.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(lib), path], check=True)
    fn = ctypes.CDLL(str(lib)).xrit_viterbi
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def decode(soft):
        NW, T = soft.shape[0], soft.shape[1] // 2
        dec = torch.empty((NW, T, 2), dtype=torch.int32, device=soft.device)
        bits = torch.empty((NW, T), dtype=torch.uint8, device=soft.device)
        with _build.launch_on(soft) as stream:
            err = fn(soft.data_ptr(), dec.data_ptr(), bits.data_ptr(), NW, T, stream)
        _build.check(err, "baseline xrit_viterbi")
        return bits
    return decode


def _library_baseline(path: str, library: str) -> ctypes.CDLL:
    """The library of another source of `csrc/<library>.cu` (the same
    entries and arguments): headers beside it first, then this tree's;
    `_build.using(library, lib)` times it through the same wrapper."""
    lib = _build.build_dir() / "variants" / f"{library}_baseline.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-I", str(_build._CSRC), "-o", str(lib),
                    path], check=True)
    return ctypes.CDLL(str(lib))


def _bits(out) -> list:
    """A kernel's result as a flat list of its tensors (outputs and state)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _bits(o)]
    return []


def _same_bits(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _build_variants(kernel: str, only: tuple | None = None) -> list:
    """(variant, library) for each of VARIANTS[kernel] (with `only`, the one
    as shipped and those whose names start with one of `only`), the builds
    in parallel."""
    library = LIBRARY[kernel]
    variants = [(what, edits) for what, edits in VARIANTS[kernel].items()
                if only is None or what == "as shipped" or what.startswith(only)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futs = [(what, pool.submit(_build.build_variant, library, f"{kernel}_{i}", (), edits))
                for i, (what, edits) in enumerate(variants)]
        return [(what, f.result()) for what, f in futs]


def _spread(kernel: str, times: dict, card: str) -> None:
    for key, ms in times.items():
        ms = sorted(ms)
        print(json.dumps(dict(kernel=kernel, spread=key, rounds=len(ms),
                              median_ms=ms[len(ms) // 2], least_ms=ms[0], most_ms=ms[-1],
                              card=card)), flush=True)


def viterbi_probe(card: str, dev, baseline: str | None, rounds: int = 1) -> None:
    """K3's variants at the fused step's and a stream block's windows,
    every instance; then the
    shipped kernel, the other many-windows candidate (and `baseline`) over
    the decoder's window counts; `rounds` times, then the spread of each."""
    libs = {what: _build.build_variant("viterbi", f"viterbi_{i}", edits=edits)
            for i, (what, edits) in enumerate(VARIANTS["viterbi"].items())}
    sweep = {frames: decoder_windows(frames, dev) for frames in SWEEP_FRAMES}
    shapes = (decoder_windows(2048, dev), sweep[8])
    old = _baseline(baseline) if baseline else None
    times: dict[str, list[float]] = {}

    def timed(key: str, fn, reps: int) -> float:
        ms = _time_ms(fn, reps)
        times.setdefault(key, []).append(ms)
        return ms

    for r in range(rounds):
        for what, lib in libs.items():
            with _build.using("viterbi", lib):
                for wins, lanes in itertools.product(shapes, viterbi_cuda.LANES):
                    shape = [wins.shape[0], wins.shape[1] // 2]
                    ms = timed(f"{what} | LPW {lanes} | {shape}",
                               lambda: viterbi_cuda.decode_bits(wins, lanes=lanes), 5)
                    print(json.dumps(dict(kernel="viterbi", round=r, variant=what, lanes=lanes,
                                          ms=ms, card=card, shape=shape)), flush=True)
        for frames, wins in sweep.items():
            nw, steps = wins.shape[0], wins.shape[1] // 2
            row = dict(kernel="viterbi", round=r, sweep="as shipped", frames=frames,
                       windows=nw, steps=steps, rule=viterbi_cuda.lanes_per_window(nw), card=card)
            row["ms_by_lanes"] = {str(lanes): timed(
                f"LPW {lanes} | {[nw, steps]}",
                lambda: viterbi_cuda.decode_bits(wins, lanes=lanes), 10)
                for lanes in viterbi_cuda.LANES}
            want = viterbi_cuda.decode_bits(wins)
            with _build.using("viterbi", libs[_ALT_VARIANT]):
                row["ms_by_lanes"][str(_ALT)] = timed(
                    f"LPW {_ALT} | {[nw, steps]}",
                    lambda: viterbi_cuda.decode_bits(wins, lanes=_FEW), 10)
                row[f"lpw_{_ALT}_bits_equal"] = bool(
                    torch.equal(viterbi_cuda.decode_bits(wins, lanes=_FEW), want))
            if old is not None:
                row["baseline"] = baseline
                row["baseline_ms"] = timed(f"baseline | {[nw, steps]}", lambda: old(wins), 10)
                row["baseline_bits_equal"] = bool(torch.equal(old(wins), want))
            print(json.dumps(row), flush=True)
    _spread("viterbi", times, card)


def steady_fills(C: int, n: int, E: int, k: int, blocks: int, gen) -> torch.Tensor:
    """The fills a locked receive's ring holds after `blocks` blocks of `n`
    symbols, `k` pops a block: the first at an acquisition lag uniform in
    [0, E), then at pos 0 wherever a whole frame is there."""
    fill = torch.zeros(C, dtype=torch.int64)
    pos = torch.randint(0, E, (C,), generator=gen)
    for _ in range(blocks):
        fill += n
        for _ in range(k):
            ok = fill >= pos + E
            fill = torch.where(ok, fill - pos - E, fill)
            pos = torch.where(ok, 0, pos)
    return fill.to(torch.int32)


def ring_probe(card: str, dev, baseline: str | None, rounds: int = 1) -> None:
    """K4a and K4b on float32 and bf16 rings at `chip_smoke.py`'s inputs and
    at a steady state, every variant (and `baseline`), `rounds` times."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    rx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=CHANNELS, block_len=BLOCK_LEN,
                       device=dev)
    C, L, S, E = CHANNELS, rx.ring_len, rx._demod.num_slots, K.CODED_FRAME_SIZE
    n = int(BLOCK_LEN / cfg.decimation / cfg.sps)          # the clock's symbols a block
    gen = torch.Generator().manual_seed(7)
    lane = torch.arange(L, device=dev)[None, :]
    new = torch.randn((C, S), generator=gen).to(dev)
    n_new = (n + torch.randint(0, 2, (C,), generator=gen)).to(torch.int32).to(dev)
    fill = torch.randint(0, L - S, (C,), generator=gen).to(torch.int32)
    fill[::97] = L - 100
    fill = fill.to(dev)
    steady = steady_fills(C, n, E, rx.k, 4, gen).to(dev)
    runs = {}                       # (kernel, inputs) -> (args, bound bytes)
    for dtype, width in ((torch.float32, 4), (torch.bfloat16, 2)):
        name = "" if dtype == torch.float32 else "_bf16"
        vals = torch.randn((C, L), generator=gen).to(dev).to(dtype)
        for inputs, f0 in (("check", fill), ("steady", steady)):
            ring = torch.where(lane < f0[:, None], vals, 0).to(dtype)
            ok = f0 + n_new <= L
            moved = int(n_new[ok].sum())
            runs[("ring_append" + name, inputs)] = (
                (ring, f0, new, n_new), (4 + width) * moved + 16 * C)
            ring2, f2, _ = ring_cuda.ring_append_plain(ring.clone(), f0, new, n_new)
            if inputs == "check":
                f2[1::61] = E // 2
                ring2[1::61, E // 2:] = 0
                pos = torch.randint(0, E, (C,), generator=gen).to(torch.int32).to(dev)
            else:
                pos = torch.zeros_like(f2)
            pok = f2 >= pos + E
            kept = int((f2 - pos - E)[pok].sum())
            runs[("ring_extract" + name, inputs)] = (
                (ring2, f2, pos, E), width * (kept + int(f2[pok].sum())) + (width + 4) * C * E
                + 16 * C)
            del ring
    want = {}
    for (kernel, inputs), (args, _) in runs.items():
        plain = ring_cuda.ring_append_plain if "append" in kernel else ring_cuda.ring_extract_plain
        want[(kernel, inputs)] = _bits(plain(args[0].clone(), *args[1:]))
    libs = _build_variants("ring")
    if baseline:
        libs.append((f"baseline {baseline}", _library_baseline(baseline, "ring")))
    # A yardstick, not a kernel of the port: the share of the peak rate one
    # `Tensor.copy_` of a float32 ring reaches on this card.
    src = runs[("ring_extract", "check")][0][0]
    dst = torch.empty_like(src)
    times: dict[str, list[float]] = {}
    for r in range(rounds):
        ms = _time_ms(lambda: dst.copy_(src), 20)
        bms = 2 * src.numel() * 4 / 3.35e12 * 1e3
        times.setdefault("Tensor.copy_ of a float32 ring", []).append(ms)
        print(json.dumps(dict(kernel="Tensor.copy_ of a float32 ring", round=r, ms=ms,
                              bound_ms=bms, share_of_bound=bms / ms, card=card)), flush=True)
        for what, lib in libs if r % 2 == 0 else libs[::-1]:
            old = what.startswith("baseline")
            for (kernel, inputs), (args, nbytes) in runs.items():
                ring = args[0].clone()
                if old and "extract" in kernel:
                    fn = _old_extract(lib, ring, *args[1:])
                elif "append" in kernel:
                    fn = lambda: ring_cuda.ring_append(ring, *args[1:])
                else:
                    fn = lambda: ring_cuda.ring_extract(ring, *args[1:])
                row = dict(kernel=kernel, round=r, variant=what, inputs=inputs, card=card)
                with _build.using("ring", lib):
                    if r == 0:
                        # What one call allocates beyond its inputs: `out`,
                        # and a second ring where the extract is out of place.
                        torch.cuda.synchronize(dev)
                        torch.cuda.reset_peak_memory_stats(dev)
                        m0 = torch.cuda.memory_allocated(dev)
                        got = _bits(fn())
                        row["allocated_bytes"] = torch.cuda.max_memory_allocated(dev) - m0
                        row["bits_equal"] = _same_bits(got, want[(kernel, inputs)])
                        del got
                        ring.copy_(args[0])
                    # The traffic of a call depends only on fill, pos and
                    # n_new, so the calls can reuse one ring.
                    row["ms"] = _time_ms(fn, 20)
                row["bound_ms"] = nbytes / 3.35e12 * 1e3
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                times.setdefault(f"{what} | {kernel} | {inputs}", []).append(row["ms"])
                print(json.dumps(row), flush=True)
                del ring, fn
    if rounds > 1:
        _spread("ring", times, card)


PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12     # H100 SXM: HBM3 bytes/s, float32 FLOP/s


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rs_inputs(dev, seed: int = 11) -> dict:
    """`{case: (entry, words)}`: `(B, 255)` codewords or `(F, 1020)` frames
    (the same codewords interleaved) of the fused step's and of a
    `decode_block`'s sizes."""
    rng = np.random.default_rng(seed)
    u8 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
    clean = lambda n: reed_solomon.rs_encode_np(
        rng.integers(0, 256, (n, 223), dtype=np.int64).astype(np.uint8))

    def hit(words: np.ndarray, rows) -> np.ndarray:
        out = words.copy()
        for r in rows:
            pos = rng.choice(255, size=int(rng.integers(1, 17)), replace=False)
            out[r, pos] ^= rng.integers(1, 256, pos.size).astype(np.uint8)
        return out

    big = 4 * 2048
    words = {
        "noise": rng.integers(0, 256, (big, 255), dtype=np.int64).astype(np.uint8),
        "clean": clean(big),
        "1% errored": hit(clean(big), rng.choice(big, size=big // 100, replace=False)),
        "small noise": rng.integers(0, 256, (32, 255), dtype=np.int64).astype(np.uint8),
        "small clean": clean(32),
        "small 4 errored": hit(clean(32), (0, 9, 17, 31)),
    }
    out = {}
    for name, w in words.items():
        out[f"{name} {w.shape[0]} codewords"] = ("codewords", u8(w))
        f = w.reshape(-1, 4, 255).transpose(0, 2, 1).reshape(-1, 1020)
        out[f"{name} {f.shape[0]} frames"] = ("frames", u8(f))
    return out


def _rs_plain(entry: str, x: torch.Tensor):
    if entry == "codewords":
        return reed_solomon.rs_decode_plain(x, 0)
    B = x.shape[0]
    corr, nerr = reed_solomon.rs_decode_plain(
        reed_solomon.deinterleave(x).reshape(B * 4, 255), 0)
    return reed_solomon.interleave(corr.reshape(B, 4, 255)), nerr.reshape(B, 4)


def _old_rs(lib, dev) -> dict:
    """The entries of an earlier one-warp `rs.cu` (`xrit_rs_decode`, the 1280-byte
    tables), called as that wrapper did: `{entry: fn}`."""
    fn = lib.xrit_rs_decode
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bexp, blog, tal, tal1, _ = reed_solomon._gf_tables()
    tb = torch.from_numpy(np.concatenate([bexp, blog, tal, tal1]).astype(np.uint8)).to(dev)

    def codewords(x):
        x = x.contiguous()
        B = x.shape[0]
        out, nerr = torch.empty_like(x), torch.empty((B,), dtype=torch.int32, device=x.device)
        with _build.launch_on(x) as stream:
            err = fn(x.data_ptr(), out.data_ptr(), nerr.data_ptr(), tb.data_ptr(), B, stream)
        _build.check(err, "baseline xrit_rs_decode")
        return out, nerr

    def frames(f):
        B = f.shape[0]
        corr, nerr = codewords(reed_solomon.deinterleave(f).reshape(B * 4, 255))
        return reed_solomon.interleave(corr.reshape(B, 4, 255)), nerr.reshape(B, 4)
    return dict(codewords=codewords, frames=frames)


def rs_probe(card: str, dev, baseline: str | None, rounds: int = 1) -> None:
    """K8 through both entries on `rs_inputs`, beside `baseline`."""
    inputs = rs_inputs(dev)
    shipped = dict(codewords=rs_cuda.rs_decode_kernel, frames=reed_solomon.rs_decode_frame)
    libs = [(what, lib, shipped) for what, lib in _build_variants("rs")]
    if baseline:
        libs.append((f"baseline {baseline}", None,
                     _old_rs(_library_baseline(baseline, "rs"), dev)))
    want = {case: _bits(_rs_plain(entry, x)) for case, (entry, x) in inputs.items()}
    times: dict[str, list[float]] = {}
    for r in range(rounds):
        for what, lib, fns in libs if r % 2 == 0 else libs[::-1]:
            for case, (entry, x) in inputs.items():
                fn = lambda: fns[entry](x)
                row = dict(kernel="rs", round=r, variant=what, case=case, card=card)
                nerr = want[case][1]
                row["bound_ms"], row["bound_by"] = _bound(*rs_cuda.bound_work(nerr))
                row["table_bound_ms"], row["table_bound_by"] = _bound(*rs_cuda.table_work(
                    nerr.numel(), int((nerr != 0).sum())))
                with _build.using("rs", lib or _build.load("rs")):
                    if r == 0:
                        row["bits_equal"] = _same_bits(_bits(fn()), want[case])
                        _, ks = timing.device_kernels(fn)
                        row["kernels_per_call"] = sum(c for _, _, c in ks)
                        row["kernels"] = sorted({k.split("(")[0] for k, _, _ in ks})
                    row["device_ms"] = timing.graph_ms(fn)
                    row["eager_ms"] = _time_ms(fn, 20)
                row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
                times.setdefault(f"{what} | {case} | device", []).append(row["device_ms"])
                times.setdefault(f"{what} | {case} | eager", []).append(row["eager_ms"])
                print(json.dumps(row), flush=True)
    if rounds > 1:
        _spread("rs", times, card)


def _old_acquire(lib):
    """An earlier one-warp `xrit_acquire` (its templates tensor), called as that wrapper
    did."""
    def call(ring, locked, templates, window, thresh):
        name = "xrit_acquire_bf16" if ring.dtype == torch.bfloat16 else "xrit_acquire"
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        C, L = ring.shape
        pos = torch.empty((C,), dtype=torch.int32, device=ring.device)
        with _build.launch_on(ring) as stream:
            err = fn(ring.data_ptr(), locked.data_ptr(), templates.data_ptr(), pos.data_ptr(),
                     C, L, int(window) - correlator.UW_BITS + 1, templates.shape[0],
                     int(thresh), stream)
        _build.check(err, "baseline xrit_acquire")
        return pos
    return call


def acquire_probe(card: str, dev, baseline: str | None, rounds: int = 1) -> None:
    """K9 on the fused receive's rings (float32, bf16; all, half, no
    channels unlocked), beside `baseline`."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    rx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=CHANNELS, block_len=BLOCK_LEN,
                       device=dev)
    C, L, window = CHANNELS, rx.ring_len, rx._acq
    thresh = rx.decoder_config.min_correlation_bits
    lags = window - correlator.UW_BITS + 1
    soft = torch.from_numpy(edge_cases.acquire_ring(C, rx.decoder_config.uws, lags, 7)).to(dev)
    ring = torch.zeros((C, L), device=dev)
    ring[:, : soft.shape[1]] = soft
    del soft
    lockings = dict(all_unlocked=torch.zeros(C, dtype=torch.bool, device=dev),
                    half_unlocked=torch.arange(C, device=dev) % 2 == 1,
                    none_unlocked=torch.ones(C, dtype=torch.bool, device=dev))
    tpl = acquire_cuda.unpack_masks(rx._acq_words, dev)
    libs = [(what, lib, acquire_cuda.acquire_positions)
            for what, lib in _build_variants("acquire")]
    if baseline:
        libs.append((f"baseline {baseline}", None,
                     _old_acquire(_library_baseline(baseline, "acquire"))))
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        r_ = ring.to(dt)
        for name, locked in lockings.items():
            case = f"{name} {str(dt).replace('torch.', '')} C = {C}"
            unlocked = int((~locked).sum())
            runs[case] = ((r_, locked, window, thresh), _bound(*acquire_cuda.bound_work(
                C, unlocked, window, tpl.shape[0], r_.element_size())),
                correlator.acquire_positions_plain(r_, locked, tpl, window, thresh))
    times: dict[str, list[float]] = {}
    for r in range(rounds):
        for what, lib, call in libs if r % 2 == 0 else libs[::-1]:
            for case, ((rg, locked, win, th), (bms, by), want) in runs.items():
                words = rx._acq_words if lib else tpl
                fn = lambda: call(rg, locked, words, win, th)
                row = dict(kernel="acquire", round=r, variant=what, case=case, card=card,
                           bound_ms=bms, bound_by=by)
                with _build.using("acquire", lib or _build.load("acquire")):
                    if r == 0:
                        row["bits_equal"] = bool(torch.equal(fn(), want))
                    row["device_ms"] = timing.graph_ms(fn)
                    row["eager_ms"] = _time_ms(fn, 20)
                row["share_of_bound"] = bms / row["device_ms"]
                times.setdefault(f"{what} | {case} | device", []).append(row["device_ms"])
                times.setdefault(f"{what} | {case} | eager", []).append(row["eager_ms"])
                print(json.dumps(row), flush=True)
    if rounds > 1:
        _spread("acquire", times, card)


def _old_extract(lib, ring, fill, pos, E):
    """A call of an out-of-place `xrit_ring_extract` (its own `ring_out`),
    returning what the in-place wrapper returns."""
    fn = lib.xrit_ring_extract_bf16 if ring.dtype == torch.bfloat16 else lib.xrit_ring_extract
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    C, L = ring.shape

    def call():                  # allocates as that source's wrapper did
        ring_out = torch.empty_like(ring)
        out = torch.empty((C, E), dtype=torch.float32, device=ring.device)
        fill_out, ok = torch.empty_like(fill), torch.empty_like(fill)
        with _build.launch_on(ring) as stream:
            err = fn(ring.data_ptr(), fill.data_ptr(), pos.data_ptr(), ring_out.data_ptr(),
                     out.data_ptr(), fill_out.data_ptr(), ok.data_ptr(), C, L, E, stream)
        _build.check(err, "baseline xrit_ring_extract")
        return ring_out, fill_out, out, ok.bool()
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device; this probe runs on a GPU only")
    args = sys.argv[1:]
    baselines, rounds = [], 1
    while "--baseline" in args:
        i = args.index("--baseline")
        baselines.append(args[i + 1])
        del args[i : i + 2]
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i : i + 2]
    only = None
    while "--variant" in args:
        i = args.index("--variant")
        only = (only or ()) + (args[i + 1],)
        del args[i : i + 2]
    kernels = args or list(VARIANTS)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    # A baseline source is the clock's, the front end's, the stream
    # kernels', the ring's or (with none of their entries) the Viterbi
    # kernel's; one of each library at most.
    kinds = {}
    for path in baselines:
        text = open(path).read()
        kinds[next((lib for lib, entry in _ENTRY.items() if entry in text), "viterbi")] = path
    if "viterbi" in kernels:
        viterbi_probe(card, dev, kinds.get("viterbi"), rounds)
    if "ring" in kernels:
        ring_probe(card, dev, kinds.get("ring"), rounds)
    if "rs" in kernels:
        rs_probe(card, dev, kinds.get("rs"), rounds)
    if "acquire" in kernels:
        acquire_probe(card, dev, kinds.get("acquire"), rounds)
    kernels = [k for k in kernels if k not in OWN_PROBES]
    if not kernels:
        return
    demod = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), BLOCK_LEN)
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = lambda: 0.05 * torch.randn((BLOCK_LEN, CHANNELS), generator=gen, device=dev)
    n = torch.arange(BLOCK_LEN, device=dev)[:, None]
    x = CF32(0.5 * torch.sign(torch.sin(1.4771 * n + torch.arange(CHANNELS, device=dev)))
             + noise(), noise())
    st = demod.init_state_batch(CHANNELS)
    front = lambda **form: lambda: frontend_cuda.demod_frontend(
        x, st.agc_gain, st.rrc_hist, st.costas, demod._agc, demod._rrc_taps, demod._costas,
        **form)
    y = front()()[0]
    # K2 on the front end's output, at C = CHANNELS and at its first channel.
    y1 = CF32(y.re[:, :1].contiguous(), y.im[:, :1].contiguous())
    st1 = demod.init_state_batch(1)
    clock = lambda interp, chunk=0, one=False: lambda: (
        clock_cuda.clock_recovery_block_kernel_batch_cl(
            y1 if one else y, (st1 if one else st).clock, demod._clock, demod.num_slots,
            interp, chunk))
    clock_shapes = {(CHANNELS, BLOCK_LEN): False, (1, BLOCK_LEN): True}
    # The mmse block update's other runs: the `(C, T)` entry on the same
    # block, and C = BU_WIDE_C at K 16 and 64.
    yc = CF32(y.re.t().contiguous(), y.im.t().contiguous())
    yw = CF32(y.re[:, :BU_WIDE_C].contiguous(), y.im[:, :BU_WIDE_C].contiguous())
    stw = demod.init_state_batch(BU_WIDE_C)
    bu = lambda x_, st_, K: lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(
        x_, st_.clock, demod._clock, demod.num_slots, "mmse", K)
    ct_key = f"(C, T) entry, C = {CHANNELS}"
    bu_runs = {
        ct_key: lambda: clock_cuda.clock_recovery_block_kernel_batch(
            yc, st.clock, demod._clock, demod.num_slots, "mmse", 16),
        f"C = {BU_WIDE_C}, K = 16": bu(yw, stw, 16),
        f"C = {BU_WIDE_C}, K = 64": bu(yw, stw, 64),
    }
    # The `(C, T)` run of a clock library without that entry, as the older
    # wrapper made it: two transposes, then the `(T, C)` entry.
    older_ct = lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(
        CF32(yc.re.t().contiguous(), yc.im.t().contiguous()), st.clock, demod._clock,
        demod.num_slots, "mmse", 16)
    xc = CF32(x.re.t().contiguous(), x.im.t().contiguous())      # (C, T)
    launches = dict(
        frontend=front(), **{k: clock(*v) for k, v in CLOCKS.items()},
        frontend_bk8=front(block_k=8), frontend_bk8_bf16=front(block_k=8, precision="bf16"),
        frontend_bk8_agc=front(block_k=8, block_stages="agc"),
        frontend_bk8_costas=front(block_k=8, block_stages="costas"),
        agc_block=lambda: stream_cuda.agc_block_kernel(xc, st.agc_gain, demod._agc),
        costas_block=lambda: stream_cuda.costas_block_kernel(xc, st.costas, demod._costas),
        costas_slab=lambda: stream_cuda.costas_block_kernel(xc, st.costas, demod._costas, 8),
    )
    others = {lib: _library_baseline(path, lib) for lib, path in kinds.items()
              if lib in _ENTRY and lib not in OWN_PROBES}
    for kernel in kernels:
        library = LIBRARY[kernel]
        libs = _build_variants(kernel, only)
        if library in others:
            libs.append((f"baseline {kinds[library]}", others[library]))
        shapes = clock_shapes if kernel in CLOCKS else {(CHANNELS, BLOCK_LEN): False}
        runs = {str(list(shape)): clock(*CLOCKS[kernel], one=True) if one else launches[kernel]
                for shape, one in shapes.items()}
        if kernel == "clock_bu":
            runs.update(bu_runs)
        want = {key: _bits(run()) for key, run in runs.items()}
        times: dict[str, list[float]] = {}
        for r in range(rounds):
            for what, lib in libs if r % 2 == 0 else libs[::-1]:
                for key, run in runs.items():
                    if key == ct_key and not hasattr(lib, "xrit_clock_bu_ct"):
                        run = older_ct
                    row = dict(kernel=kernel, round=r, variant=what, card=card, shape=key)
                    with _build.using(library, lib):
                        row["ms"] = _time_ms(run)
                        if r == 0:
                            row["bits_equal"] = _same_bits(_bits(run()), want[key])
                    times.setdefault(f"{what} | {key}", []).append(row["ms"])
                    print(json.dumps(row), flush=True)
        if rounds > 1:
            _spread(kernel, times, card)

    exe = _build.build_dir() / "variants" / "sched_probe"
    subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
         str(_build._CSRC / "sched_probe.cu")], check=True)
    for line in subprocess.run([str(exe)], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        print(json.dumps(dict(probe="two busy warps of one block", card=card,
                              **json.loads(line))), flush=True)


if __name__ == "__main__":
    main()
