"""Timing of the M&M clock kernel's shipped instances (K2).

    python -m xritdemod_tpu_torch.tools.clock_bench [spec ...] [--iters 5]
        [--channels 512] [--block 131072] [--device cuda]

The port's counterpart of `tools/clock_bench.py`, at its operating point:
C = 512 channels x T = 131072 samples of N(0, 0.3) noise (numpy seed 0),
LRIT at 1.25 Msps, the state threaded from each call into the next, under
`tools/timing.py`'s rule.  Each spec times one instance through its wrapper
(`clock_cuda.clock_recovery_block_kernel_batch_cl` on a channels-last block,
the layout the fused path hands it):

  exact             the exact per-symbol recursion, mmse taps (the default)
  sinc              the same with the windowed-sinc taps
  k{K}[x{M}]        the block update with K symbols a chunk
                    (`DemodConfig.clock_block_update=K`), mmse; `-sinc` after
                    it for the sinc taps (`k16-sinc`)

Default: exact sinc k4 k16 k64.  The JAX tool's `k{chunk}x{superchunks}`
maps to `clock_block_update=chunk`: the card's kernel has no super-chunk
staging, so M has no counterpart, and the tool says so on that spec's line.
The TPU-only specs (`gather`, `gather_ta`, `gather_taT`: the vmap'd row
gather; `pallas`, `p{K}x{M}[c{ct}]`: Pallas tilings) have no counterpart
either: the tool names them and runs nothing in their place.  The last line
is one JSON object with the card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys

import torch

from xritdemod_tpu_torch.tools.timing import card, noise_block, require_device, timed

C_BENCH, T_BENCH = 512, 1 << 17
DEFAULT = ("exact", "sinc", "k4", "k16", "k64")
TPU_ONLY = {
    "gather": "the vmap'd per-channel row gather (an XLA gather that serialises rows "
              "on the TPU); the card's kernel indexes each channel's window itself",
    "gather_ta": "a take_along_axis form of the TPU's staging gather",
    "gather_taT": "a channels-last take_along_axis form of the TPU's staging gather",
    "pallas": "the Pallas kernel's TPU tiling (the card's kernel is K2 itself: `exact`)",
}
_SPEC = re.compile(r"^k(\d+)(?:x(\d+))?(-sinc)?$")


def parse(spec: str):
    """-> (interp, chunk, note) of a spec, or (None, None, why) when it has
    no counterpart on the card."""
    if spec in ("exact", "sinc"):
        return ("mmse" if spec == "exact" else "sinc"), 0, None
    m = _SPEC.match(spec)
    if m:
        note = (f"superchunks={m.group(2)} has no counterpart (the card's block update has "
                f"no super-chunk staging): timed as clock_block_update={m.group(1)}"
                if m.group(2) else None)
        return ("sinc" if m.group(3) else "mmse"), int(m.group(1)), note
    if spec in TPU_ONLY:
        return None, None, TPU_ONLY[spec]
    if re.match(r"^p\d+x\d+(c\d+)?$", spec):
        return None, None, "a Pallas tiling of the TPU kernel (chunk x superchunks, tile)"
    raise SystemExit(f"clock_bench: unknown spec {spec!r}")


def bench(specs=DEFAULT, C: int = C_BENCH, T: int = T_BENCH, iters: int = 5, device="cuda",
          log=None) -> dict:
    from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
    from xritdemod_tpu_torch.ops.clock_cuda import clock_recovery_block_kernel_batch_cl
    from xritdemod_tpu_torch.utils.cplx import CF32

    dm = Demodulator(DemodConfig.lrit(sample_rate=1_250_000), block_len=T, device=device)
    x = noise_block(C, T, device)
    xT = CF32(x.re.t().contiguous(), x.im.t().contiguous())
    del x
    state = dm.init_state_batch(C).clock
    rows, skipped = [], {}
    for spec in specs:
        interp, chunk, note = parse(spec)
        if interp is None:
            skipped[spec] = note
            if log is not None:
                print(f"{spec}: no counterpart on the card: {note}", file=log, flush=True)
            continue
        launches: dict = {}
        ms, out = timed(lambda o: clock_recovery_block_kernel_batch_cl(
            xT, o[2], dm._clock, dm.num_slots, interp, chunk, dm.clock_segments),
            (None, None, state), iters, device, launches)
        row = {"spec": spec, "interp": interp, "clock_block_update": chunk, "ms": ms,
               "msamples_per_s": C * T / ms / 1e3, "launches": launches,
               "finite": bool(torch.isfinite(out[0].re).all())}
        if note:
            row["note"] = note
        rows.append(row)
        if log is not None:
            print(f"{spec}: {ms:.2f} ms  ({row['msamples_per_s']:.0f} Msamp/s clock only)"
                  + (f"  [{note}]" if note else ""), file=log, flush=True)
    return {"C": C, "T": T, "slots": dm.num_slots, "iters": iters, "rows": rows,
            "no_counterpart": skipped,
            "all_finite": all(r["finite"] and math.isfinite(r["ms"]) for r in rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="clock_bench")
    p.add_argument("specs", nargs="*", default=list(DEFAULT))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--channels", type=int, default=C_BENCH)
    p.add_argument("--block", type=int, default=T_BENCH)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for s in args.specs:
        parse(s)                # unknown specs fail before anything runs
    dev = require_device(args.device, "clock_bench")
    smi = card(dev)
    print(f"card={smi} device={dev} C={args.channels} T={args.block}", flush=True)
    res = bench(args.specs, args.channels, args.block, args.iters, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
