"""Probe: what sets the time of the front-end (K1) and clock (K2) kernels.

    python -m xritdemod_tpu_torch.tools.kernel_probe            # needs a GPU and nvcc

Times the two kernels at the shipped LRIT shape (2048 channels x 131072
samples, a synthetic BPSK-like block) as they are, and then variants of
their sources that change one thing each (`VARIANTS`: a stage's work taken
out, a loop unrolled further or less, a sleep in the barrier wait), built by
`_build.build_variant` from edited copies of `csrc/`.  A variant that removes
work computes something else: its time says what that work costs beside the
kernel's dependent chain, nothing more.  Last, it builds and runs
`csrc/sched_probe.cu`, which shows which warps of a block share a scheduler.
One JSON line per measurement, the card's name and power limit on each.

This is how the two kernels' layouts were found (PERF.md has the figures);
run it again when either kernel, or the card, changes.
"""

from __future__ import annotations

import json
import subprocess

import torch

from xritdemod_tpu_torch import _build
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.ops import clock_cuda, frontend_cuda
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["VARIANTS", "main"]

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
}


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
    for kernel, launch in (("frontend", front), ("clock", clock)):
        for i, (what, edits) in enumerate(VARIANTS[kernel].items()):
            lib = _build.build_variant(kernel, f"{kernel}_{i}", edits=edits)
            with _build.using(kernel, lib):
                ms = _time_ms(launch)
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
