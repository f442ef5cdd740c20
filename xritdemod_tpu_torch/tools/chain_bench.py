"""Per-stage timing of the split demod chain at the bench operating point.

    python -m xritdemod_tpu_torch.tools.chain_bench [C] [T] [--iters 5]
        [--decimation 1] [--device cuda]

The port's counterpart of `tools/chain_bench.py` (C = 512 channels, T =
131072 samples, LRIT at 1.25 Msps, numpy seed 0).  Each stage of the split
path (`DemodConfig(frontend_kernel="split")`) is timed alone, threaded
through its own state (each call's carried state goes into the next), under
`tools/timing.py`'s rule, on the previous stage's output:

  - the decimating FIR (`ops/fir.fir_block`), with `--decimation D` > 1
    only: LRIT at D x 1.25 Msps, T input samples, T / D after it;
  - the AGC (K5, `stream_cuda.agc_block_kernel`);
  - the RRC matched filter (`ops/fir.fir_block`: cuDNN, float32);
  - the Costas loop (K6, `stream_cuda.costas_block_kernel`);
  - the clock (K2's `(C, T)` entry, `clock_cuda.clock_recovery_block_kernel_batch`);

then the whole `Demodulator.block_batch` of the split path, beside the sum
of its stages.  The last line is one JSON object: the card, each stage's ms,
Msamples/s and kernel launches a call, and the sum beside the whole.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from xritdemod_tpu_torch.tools.timing import card, noise_block, require_device, timed


def bench(C: int = 512, T: int = 1 << 17, iters: int = 5, decimation: int = 1,
          device="cuda", log=None) -> dict:
    from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
    from xritdemod_tpu_torch.ops import fir
    from xritdemod_tpu_torch.ops.clock_cuda import clock_recovery_block_kernel_batch
    from xritdemod_tpu_torch.ops.stream_cuda import agc_block_kernel, costas_block_kernel

    cfg = DemodConfig.lrit(sample_rate=1_250_000 * decimation, decimation=decimation,
                           frontend_kernel="split")
    demod = Demodulator(cfg, block_len=T, device=device)
    x = noise_block(C, T, device)
    state = demod.init_state_batch(C)
    ms, launches = {}, {}

    def stage(name, fn, carry, samples):
        launches[name] = {}
        ms[name], out = timed(fn, carry, iters, device, launches[name])
        if log is not None:
            print(f"{name:28s} {ms[name]:8.2f} ms  {samples / ms[name] / 1e3:9.1f} Msamp/s",
                  file=log, flush=True)
        return out

    xd = x
    if decimation > 1:
        xd, _ = stage("decimating_fir", lambda o: fir.fir_block(x, demod._dec_taps, o[1],
                                                                decimation),
                      (None, state.dec_hist), C * T)
    xa, _ = stage("agc", lambda o: agc_block_kernel(xd, o[1], demod._agc),
                  (None, state.agc_gain), C * T)
    xf, _ = stage("rrc_fir", lambda o: fir.fir_block(xa, demod._rrc_taps, o[1]),
                  (None, state.rrc_hist), C * T)
    xc, _ = stage("costas", lambda o: costas_block_kernel(xf, o[1], demod._costas),
                  (None, state.costas), C * T)
    soft, valid, _ = stage(
        "clock", lambda o: clock_recovery_block_kernel_batch(
            xc, o[2], demod._clock, demod.num_slots, cfg.clock_interp),
        (None, None, state.clock), C * T)
    stages = list(ms)
    soft, _, _ = stage("block_batch", lambda o: demod.block_batch(x, o[2]),
                       (None, None, state), C * T)
    total = sum(ms[s] for s in stages)
    if log is not None:
        print(f"{'sum of stages':28s} {total:8.2f} ms  ({C * T / total / 1e3:.0f} Msamp/s)",
              file=log, flush=True)
    return {"C": C, "T": T, "decimation": decimation, "iters": iters, "ms": ms,
            "launches": launches, "stages_of_whole": stages, "stage_sum_ms": total,
            "whole": "block_batch", "whole_ms": ms["block_batch"],
            "msamples_per_s": {k: C * T / v / 1e3 for k, v in ms.items()},
            "all_finite": bool(torch.isfinite(soft).all())
            and all(math.isfinite(v) and v > 0 for v in ms.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chain_bench")
    p.add_argument("C", nargs="?", type=int, default=512)
    p.add_argument("T", nargs="?", type=int, default=1 << 17)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--decimation", type=int, default=1,
                   help="D > 1: LRIT at D x 1.25 Msps with the decimating FIR in front")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "chain_bench")
    smi = card(dev)
    print(f"card={smi} device={dev} C={args.C} T={args.T}", flush=True)
    res = bench(args.C, args.T, args.iters, args.decimation, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
