"""Timing of the front-end kernel's forms, the channels-last clock, and the
split path's stages, each alone.

    python -m xritdemod_tpu_torch.tools.frontend_bench [frontend|clock|both|split]
        [--device cuda]
    env: BENCH_CHANNELS (512), BENCH_BLOCK (131072), BENCH_ITERS (6)

The port's counterpart of `tools/frontend_bench.py`, on `(T, C)` (or, for
`split`, `(C, T)`) blocks of N(0, 0.3) noise from numpy seed 0, LRIT at
1.25 Msps, each from the initial state, under `tools/timing.py`'s rule:

  frontend  the fused front end (K1, `frontend_cuda.demod_frontend`): the
            exact form, the K = 8 slab form, the bf16 matched filter and
            both (the forms `DemodConfig` selects with
            `frontend_block_update` and `frontend_precision`)
  clock     the clock's channels-last entry (K2, mmse)
  both      frontend and clock (the default)
  split     the split path's stages: the AGC (K5), the RRC (cuDNN), the
            Costas loop (K6) and the `(C, T)` -> `(T, C)` transpose

`BENCH_FRONTEND_ROWS` (the TPU kernel's row tile) and the TPU's VMEM modes
have no counterpart on the card, whose K1 has one tile per form: the tool
says so and exits when `BENCH_FRONTEND_ROWS` is set.  `kernel_probe` stays
the tool for one-change variants of a kernel's source.  The last line is
one JSON object with the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from xritdemod_tpu_torch.tools.timing import (
    FRONTEND_FORMS, card, noise_block, require_device, timed,
)

# (block_k, block_stages, precision) of each of K1's forms.
FORMS = {"frontend": (0, "both", "highest"), **FRONTEND_FORMS}


def bench(which: str = "both", C: int = 512, T: int = 1 << 17, iters: int = 6,
          device="cuda", log=None) -> dict:
    from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
    from xritdemod_tpu_torch.ops import fir
    from xritdemod_tpu_torch.ops.clock_cuda import clock_recovery_block_kernel_batch_cl
    from xritdemod_tpu_torch.ops.frontend_cuda import demod_frontend
    from xritdemod_tpu_torch.ops.stream_cuda import agc_block_kernel, costas_block_kernel
    from xritdemod_tpu_torch.utils.cplx import CF32

    dm = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), block_len=T, device=device)
    st = dm.init_state_batch(C)
    x = noise_block(C, T, device)
    xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    rows = {}

    def run(name, fn, out_of):
        launches: dict = {}
        ms, out = timed(lambda _: fn(), None, iters, device, launches)
        rows[name] = {"ms": ms, "msamples_per_s": C * T / ms / 1e3, "launches": launches,
                      "finite": bool(torch.isfinite(out_of(out)).all())}
        if log is not None:
            print(f"{name}: {ms:.2f} ms  {rows[name]['msamples_per_s']:.0f} Msamp/s",
                  file=log, flush=True)

    if which in ("frontend", "both"):
        for name, (bk, stages, prec) in FORMS.items():
            run(name, lambda bk=bk, stages=stages, prec=prec: demod_frontend(
                xT, st.agc_gain, st.rrc_hist, st.costas, dm._agc, dm._rrc_taps, dm._costas,
                block_k=bk, precision=prec, block_stages=stages), lambda o: o[0].re)
    if which in ("clock", "both"):
        run("clock_cl", lambda: clock_recovery_block_kernel_batch_cl(
            xT, st.clock, dm._clock, dm.num_slots), lambda o: o[0].re)
    if which == "split":
        run("agc", lambda: agc_block_kernel(x, st.agc_gain, dm._agc), lambda o: o[0].re)
        run("rrc_fir", lambda: fir.fir_block(x, dm._rrc_taps, st.rrc_hist), lambda o: o[0].re)
        run("costas", lambda: costas_block_kernel(x, st.costas, dm._costas), lambda o: o[0].re)
        run("transpose", lambda: CF32(x.re.t().contiguous(), x.im.t().contiguous()),
            lambda o: o.re)
    return {"which": which, "C": C, "T": T, "iters": iters, "rows": rows,
            "all_finite": all(r["finite"] and math.isfinite(r["ms"]) for r in rows.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="frontend_bench")
    p.add_argument("which", nargs="?", default="both",
                   choices=["frontend", "clock", "both", "split"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if os.environ.get("BENCH_FRONTEND_ROWS"):
        raise SystemExit("frontend_bench: BENCH_FRONTEND_ROWS (the TPU kernel's row tile) has "
                         "no counterpart on the card: each of K1's forms has one tile")
    dev = require_device(args.device, "frontend_bench")
    C = int(os.environ.get("BENCH_CHANNELS", "512"))
    T = int(os.environ.get("BENCH_BLOCK", str(1 << 17)))
    iters = int(os.environ.get("BENCH_ITERS", "6"))
    smi = card(dev)
    print(f"card={smi} device={dev} C={C} T={T}", flush=True)
    res = bench(args.which, C, T, iters, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
