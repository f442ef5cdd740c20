"""Per-component timing of the fused receive (`FusedReceiver.step`).

    python -m xritdemod_tpu_torch.tools.rx_profile [C] [T] [iters] [--device cuda]
    RX_PROFILE_MODE=hrit python -m xritdemod_tpu_torch.tools.rx_profile ...

The port's counterpart of `tools/rx_profile.py` (C = 1024 channels, T =
131072 samples, 6 calls; LRIT at 1.25 Msps, or HRIT at 3 Msps with
`RX_PROFILE_MODE=hrit`; numpy seed 0).  Where the time of a step goes, each
component timed alone under `tools/timing.py`'s rule, threaded through its
own state:

  - the whole step on noise (no channel ever locks, so every extraction
    runs the acquisition: the worst case);
  - the demod half, `Demodulator.block_batch` (K1, K2);
  - `ring_append` (K4a) of 30000 symbols a channel and `ring_extract` (K4b)
    of one coded frame, alone;
  - the acquisition (K9) of every channel unlocked, over the ring's first
    frame of lags;
  - one `decode_frames` of C noise frames (K3); a step runs it k times.

Beside each: its kernel launches a call, by kernel, from the wrappers'
counts; on the card also every device kernel of one call (the port's and
PyTorch's) and their summed device time, from `torch.profiler`, and whether
its traces held at least the wrappers' launches (`device_readings_complete`:
a trace that lost events reads too little).  The sum of
the components a step runs (demod + append + k x (extract + acquisition +
decode_frames)) stands beside the whole step.  The last line is one JSON
object with the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import (
    card, device_kernels, noise_block, require_device, timed,
)

FRAME = 16384


def components(rx, x, st):
    """name -> (fn, carry) of every component of a step of `rx` on `x`."""
    from xritdemod_tpu_torch.ops.ring_cuda import ring_append, ring_extract

    C, L, dev = rx.channels, rx.ring_len, rx.device
    S = rx._demod.num_slots
    soft = torch.zeros((C, S), dtype=torch.float32, device=dev)
    n_new = torch.full((C,), min(30000, S), dtype=torch.int32, device=dev)
    zero = torch.zeros((C,), dtype=torch.int32, device=dev)
    frames = torch.from_numpy(
        np.random.default_rng(0).normal(0, 32, (C, FRAME)).astype(np.float32)).to(dev)

    def append(carry):
        ring, fill = carry
        ring, fill, _ = ring_append(ring, fill, soft, n_new)
        # keep the fill bounded so that the chain never overflows
        return ring, torch.where(fill > L - 2 * FRAME, zero, fill)

    def extract(carry):
        # In place: every call pops from, and shifts, the one carried ring.
        ring, fill = carry[:2]
        ring, f2, out, ok = ring_extract(ring, fill, zero, FRAME)
        return ring, torch.where(ok, f2, fill + 30000), out

    unlocked = torch.zeros((C,), dtype=torch.bool, device=dev)

    def acquire(carry):
        ring = carry[0]
        return ring, rx._acquire(ring, unlocked)

    return {
        "full rx step (unlocked: acq on)": (lambda s: rx.step(x, s)[3], st),
        "demod block_batch": (lambda s: rx._demod.block_batch(x, s)[2], st.demod),
        "ring_append": (append, (st.ring.clone(), st.fill)),
        "ring_extract": (extract, (st.ring.clone(), torch.full_like(st.fill, L - 100))),
        "acquisition correlate": (acquire, (st.ring.clone(), None)),
        "decode_frames (x1; step does k)": (lambda t: rx._dec.decode_frames(frames, t)[1],
                                            st.tails),
    }


def profile(C: int = 1024, T: int = 1 << 17, iters: int = 6, mode: str = "lrit",
            device="cuda", log=None) -> dict:
    from xritdemod_tpu_torch.models.decoder import DecoderConfig
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.models.receiver import FusedReceiver

    cfg = (DemodConfig.hrit(sample_rate=3_000_000) if mode == "hrit"
           else DemodConfig.lrit(sample_rate=1_250_000))
    rx = FusedReceiver(cfg, DecoderConfig(mode=mode), channels=C, block_len=T, device=device)
    x = noise_block(C, T, device)
    on_card = torch.device(device).type == "cuda"
    ms, launches, kernels, busy = {}, {}, {}, {}
    complete = True
    for name, (fn, carry) in components(rx, x, rx.init_state()).items():
        launches[name] = {}
        ms[name], out = timed(fn, carry, iters, device, launches[name])
        if on_card:
            busy[name], rows = device_kernels(lambda: fn(out))
            kernels[name] = sum(r[2] for r in rows)
            # The profiler's trace must hold at least the port's own launches.
            complete &= kernels[name] >= sum(launches[name].values())
        if log is not None:
            extra = (f"  device {busy[name]:7.2f} ms in {kernels[name]:5d} kernels"
                     if on_card else "")
            print(f"{name:38s} {ms[name]:8.2f} ms/block{extra}  launches {launches[name]}",
                  file=log, flush=True)
    per_extract = ("ring_extract", "acquisition correlate", "decode_frames (x1; step does k)")
    total = (ms["demod block_batch"] + ms["ring_append"]
             + rx.k * sum(ms[n] for n in per_extract))
    whole = ms["full rx step (unlocked: acq on)"]
    if log is not None:
        print(f"{'sum of components':38s} {total:8.2f} ms/block (k={rx.k} extractions a step;"
              f" whole step {whole:.2f})", file=log, flush=True)
    return {"C": C, "T": T, "iters": iters, "mode": mode, "k": rx.k, "ring_len": rx.ring_len,
            "ring_dtype": str(rx.ring_dtype).replace("torch.", ""), "ms": ms,
            "launches": launches, "device_kernels_per_call": kernels or None,
            "device_busy_ms_per_call": busy or None,
            "device_readings_complete": complete if on_card else None,
            "whole": "full rx step (unlocked: acq on)", "whole_ms": whole,
            "stage_sum_ms": total,
            "all_finite": all(math.isfinite(v) and v > 0 for v in ms.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rx_profile")
    p.add_argument("C", nargs="?", type=int, default=1024)
    p.add_argument("T", nargs="?", type=int, default=1 << 17)
    p.add_argument("iters", nargs="?", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "rx_profile")
    mode = os.environ.get("RX_PROFILE_MODE", "lrit")
    smi = card(dev)
    print(f"card={smi} device={dev} C={args.C} T={args.T} iters={args.iters} mode={mode}",
          flush=True)
    res = profile(args.C, args.T, args.iters, mode, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
