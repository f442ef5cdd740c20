"""Per-stage timing of the fused demod chain (`Demodulator.block_batch`).

    python -m xritdemod_tpu_torch.tools.stage_profile [C] [T] [iters] [--device cuda]
    BENCH_CLOCK_INTERP=mmse python -m xritdemod_tpu_torch.tools.stage_profile ...

The port's counterpart of `tools/stage_profile.py` (C = 512 channels, T =
131072 samples, 8 calls, LRIT at 1.25 Msps, the clock's interpolator from
`BENCH_CLOCK_INTERP`, "sinc" when unset, numpy seed 0).  Each stage is timed
alone, threaded through its own state, under `tools/timing.py`'s rule:

  - the front end: the `(C, T)` -> `(T, C)` transpose and the fused
    AGC + RRC + Costas kernel (K1, `frontend_cuda.demod_frontend`, in the
    forms the `Demodulator` runs);
  - the clock's channels-last entry (K2,
    `clock_cuda.clock_recovery_block_kernel_batch_cl`) on the front end's
    output;
  - the whole `block_batch`, beside the sum of the two.

The last line is one JSON object: the card, each stage's ms and kernel
launches a call, and the sum beside the whole.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from xritdemod_tpu_torch.tools.timing import card, noise_block, require_device, timed


def profile(C: int = 512, T: int = 1 << 17, iters: int = 8, interp: str = "sinc",
            device="cuda", log=None) -> dict:
    from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
    from xritdemod_tpu_torch.ops.clock_cuda import clock_recovery_block_kernel_batch_cl
    from xritdemod_tpu_torch.ops.frontend_cuda import demod_frontend
    from xritdemod_tpu_torch.utils.cplx import CF32

    cfg = DemodConfig.lrit(sample_rate=1_250_000, clock_interp=interp)
    dm = Demodulator(cfg, block_len=T, device=device)
    x = noise_block(C, T, device)
    st = dm.init_state_batch(C)
    ms, launches = {}, {}

    def stage(name, fn, carry):
        launches[name] = {}
        ms[name], out = timed(fn, carry, iters, device, launches[name])
        if log is not None:
            print(f"{name:36s} {ms[name]:8.2f} ms/block", file=log, flush=True)
        return out

    def frontend(o):
        xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
        return demod_frontend(xT, o[1], o[2], o[3], dm._agc, dm._rrc_taps, dm._costas,
                              block_k=dm.block_k, precision=dm.precision)

    yT, _, _, _ = stage("frontend (transpose+fused kernel)", frontend,
                        (None, st.agc_gain, st.rrc_hist, st.costas))
    stage("clock (channels-last kernel)",
          lambda o: clock_recovery_block_kernel_batch_cl(
              yT, o[2], dm._clock, dm.num_slots, interp, cfg.clock_block_update,
              dm.clock_segments),
          (None, None, st.clock))
    stages = list(ms)
    soft, _, _ = stage("full chain (block_batch)", lambda o: dm.block_batch(x, o[2]),
                       (None, None, st))
    total = sum(ms[s] for s in stages)
    if log is not None:
        print(f"{'sum of stages':36s} {total:8.2f} ms/block", file=log, flush=True)
    return {"C": C, "T": T, "iters": iters, "clock_interp": interp,
            "block_k": dm.block_k, "precision": dm.precision, "ms": ms, "launches": launches,
            "stages_of_whole": stages, "stage_sum_ms": total,
            "whole": "full chain (block_batch)", "whole_ms": ms["full chain (block_batch)"],
            "all_finite": bool(torch.isfinite(soft).all())
            and all(math.isfinite(v) and v > 0 for v in ms.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stage_profile")
    p.add_argument("C", nargs="?", type=int, default=512)
    p.add_argument("T", nargs="?", type=int, default=1 << 17)
    p.add_argument("iters", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "stage_profile")
    interp = os.environ.get("BENCH_CLOCK_INTERP", "sinc")
    smi = card(dev)
    print(f"card={smi} device={dev} C={args.C} T={args.T} iters={args.iters}", flush=True)
    res = profile(args.C, args.T, args.iters, interp, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
