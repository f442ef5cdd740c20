"""Probe: what sets the time of the warp-specialised kernels: the front end
(K1), the clock (K2), the standalone AGC (K5) and Costas loop (K6).

    python -m xritdemod_tpu_torch.tools.kernel_probe            # needs a GPU and nvcc
    python -m xritdemod_tpu_torch.tools.kernel_probe agc_block costas_block

Times the kernels named on the command line (all four by default) at the
shipped LRIT shape (2048 channels x 131072 samples, a synthetic BPSK-like
block) as they are, and then variants of their sources that change one
thing each (`VARIANTS`: a stage's work taken out, a loop unrolled further or
less, a sleep in the barrier wait, channels per block, tile stages, warps
of a stage), built by `_build.build_variant` from edited copies of `csrc/`.
A variant that removes work computes something else: its time says what
that work costs beside the kernel's dependent chain, nothing more.  Last, it
builds and runs `csrc/sched_probe.cu`, which shows which warps of a block
share a scheduler.  One JSON line per measurement, the card's name and power
limit on each.

This is how the kernels' layouts were found (PERF.md has the figures); run
it again when a kernel, or the card, changes.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import clock_cuda, frontend_cuda, stream_cuda
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

# The library (`csrc/<name>.cu`) that holds each kernel.
LIBRARY = {"frontend": "frontend", "clock": "clock", "agc_block": "stream",
           "costas_block": "stream"}


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device; this probe runs on a GPU only")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    demod = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), BLOCK_LEN)
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = lambda: 0.05 * torch.randn((BLOCK_LEN, CHANNELS), generator=gen, device=dev)
    n = torch.arange(BLOCK_LEN, device=dev)[:, None]
    x = CF32(0.5 * torch.sign(torch.sin(1.4771 * n + torch.arange(CHANNELS, device=dev)))
             + noise(), noise())
    st = demod.init_state_batch(CHANNELS)
    front = lambda: frontend_cuda.demod_frontend(
        x, st.agc_gain, st.rrc_hist, st.costas, demod._agc, demod._rrc_taps, demod._costas)
    y = front()[0]
    clock = lambda: clock_cuda.clock_recovery_block_kernel_batch_cl(
        y, st.clock, demod._clock, demod.num_slots)
    xc = CF32(x.re.t().contiguous(), x.im.t().contiguous())      # (C, T)
    launches = dict(
        frontend=front, clock=clock,
        agc_block=lambda: stream_cuda.agc_block_kernel(xc, st.agc_gain, demod._agc),
        costas_block=lambda: stream_cuda.costas_block_kernel(xc, st.costas, demod._costas),
    )
    for kernel in sys.argv[1:] or list(VARIANTS):
        library = LIBRARY[kernel]
        for i, (what, edits) in enumerate(VARIANTS[kernel].items()):
            lib = _build.build_variant(library, f"{kernel}_{i}", edits=edits)
            with _build.using(library, lib):
                ms = _time_ms(launches[kernel])
            print(json.dumps(dict(kernel=kernel, variant=what, ms=ms, card=card,
                                  shape=[CHANNELS, BLOCK_LEN])), flush=True)

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
