"""Where the host's share of a fold-parallel reprocess goes: each candidate alone.

    python -m xritdemod_tpu_torch.tools.host_budget_profile [--blocks 4]
        [--folds 128] [--block 131072] [--device cuda]

The port's counterpart of `tools/host_budget_profile.py` (F = 128 folds x
T = 131072 samples, numpy seed 0).  It measures, each by itself:

  1. TX synthesis (the port's `tx.py`: 4 frames, encoded and modulated);
  2. fold-block assembly (numpy copies into one `(F, T)` complex64 block);
  3. host -> device: the float32 pair against the interleaved int8 wire
     (`quantize_iq_s8`), each from pageable and from pinned memory;
  4. device -> host: one block's `(F, 1, 892)` uint8 VCDU field, one element
     (a 4-byte read), many small copies (`--blocks` x 8 fields of `(F,)`
     int32, one at a time), and one bulk copy (600 x F x 892 bytes);
  5. the device's demod, pipelined (`Demodulator.block_batch` at C = F,
     `tools/timing.py`'s rule).

Host steps are timed with the host clock; every copy ends in a
synchronisation, so its time is the copy's own (the card's, not a floor of
some other link).  The last line is one JSON object with the card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device, sync, timed


def host_s(fn, n: int = 3) -> float:
    """Seconds a call of `fn` (host clock, one warm-up call left out)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def profile(F: int = 128, T: int = 1 << 17, blocks: int = 4, device="cuda", log=None) -> dict:
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
    from xritdemod_tpu_torch.utils.cplx import CF32, quantize_iq_s8

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}

    def say(key, text, **vals):
        out[key] = vals
        if log is not None:
            print(text, file=log, flush=True)

    rng = np.random.default_rng(0)
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    t0 = time.perf_counter()
    vcdus = tx.make_vcdus(4, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, noise=0.02)
    dt = time.perf_counter() - t0
    say("tx_synth", f"1. tx synth: {len(sig) / dt / 1e6:.1f} Msamp/s "
        f"({len(sig)} samples in {dt:.2f}s)", msamples_per_s=len(sig) / dt / 1e6, s=dt)

    cap = (rng.normal(0, 0.3, F * T // 8) + 0j).astype(np.complex64)
    buf = np.zeros((F, T), np.complex64)

    def fold():
        for f in range(F):
            s0 = (f * 997) % (len(cap) - T)
            buf[f] = cap[s0:s0 + T]

    dt = host_s(fold)
    say("fold_assembly", f"2. fold assembly: {F * T / dt / 1e6:.0f} Msamp/s "
        f"({dt * 1e3:.0f} ms per ({F}, {T}) block)", msamples_per_s=F * T / dt / 1e6,
        ms=dt * 1e3)

    xr = np.ascontiguousarray(buf.real, np.float32)
    xi = np.ascontiguousarray(buf.imag, np.float32)
    q = quantize_iq_s8(buf)
    pinned = {}
    if on_card:
        pinned = {k: torch.from_numpy(a).pin_memory() for k, a in
                  (("re", xr), ("im", xi), ("q", q))}
    for kind, srcs in (("pageable", {"re": torch.from_numpy(xr), "im": torch.from_numpy(xi),
                                     "q": torch.from_numpy(q)}), ("pinned", pinned)):
        if not srcs:
            continue

        def h2d_f32():
            srcs["re"].to(dev, non_blocking=kind == "pinned")
            srcs["im"].to(dev, non_blocking=kind == "pinned")
            sync(dev)

        def h2d_i8():
            srcs["q"].to(dev, non_blocking=kind == "pinned")
            sync(dev)

        dt = host_s(h2d_f32)
        say(f"h2d_f32_{kind}", f"3. H2D f32 pair ({kind}): {2 * xr.nbytes / dt / 1e6:.0f} MB/s "
            f"-> {F * T / dt / 1e6:.0f} Msamp/s", mb_per_s=2 * xr.nbytes / dt / 1e6,
            msamples_per_s=F * T / dt / 1e6)
        dt = host_s(h2d_i8)
        say(f"h2d_int8_{kind}", f"3. H2D int8 interleaved ({kind}): "
            f"{q.nbytes / dt / 1e6:.0f} MB/s -> {F * T / dt / 1e6:.0f} Msamp/s",
            mb_per_s=q.nbytes / dt / 1e6, msamples_per_s=F * T / dt / 1e6)

    big = torch.full((F, 1, 892), 7, dtype=torch.uint8, device=dev)
    sync(dev)
    dt = host_s(lambda: big.cpu())
    say("d2h_field", f"4a. D2H one ({F},1,892) u8 field: {dt * 1e3:.3f} ms "
        f"({big.numel() / dt / 1e6:.1f} MB/s)", ms=dt * 1e3, mb_per_s=big.numel() / dt / 1e6)
    one = torch.ones((1,), dtype=torch.float32, device=dev)
    dt = host_s(lambda: float(one[0]), n=10)
    say("d2h_one", f"4b. D2H 4-byte read: {dt * 1e3:.3f} ms", ms=dt * 1e3)
    small = [torch.full((F,), i, dtype=torch.int32, device=dev) for i in range(8 * blocks)]
    sync(dev)
    dt = host_s(lambda: [s.cpu() for s in small])
    say("d2h_small", f"4c. D2H {len(small)} small ({F},) int32 copies one at a time: "
        f"{dt * 1e3:.3f} ms ({dt / len(small) * 1e6:.1f} us each)", ms=dt * 1e3,
        copies=len(small), us_each=dt / len(small) * 1e6)
    big2 = torch.ones((600, F, 892), dtype=torch.uint8, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    big2.cpu()
    dt = time.perf_counter() - t0
    say("d2h_bulk", f"4d. D2H bulk {big2.numel() / 1e6:.0f} MB: {dt * 1e3:.1f} ms "
        f"({big2.numel() / dt / 1e6:.1f} MB/s)", ms=dt * 1e3, mb_per_s=big2.numel() / dt / 1e6)
    del big2

    dm = Demodulator(cfg, block_len=T, device=dev)
    xc = CF32(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
    ms, o = timed(lambda o: dm.block_batch(xc, o[2]), (None, None, dm.init_state_batch(F)),
                  8, dev)
    say("device_demod", f"5. device demod pipelined: {F * T / ms / 1e3:.0f} Msamp/s "
        f"({ms:.2f} ms a block)", msamples_per_s=F * T / ms / 1e3, ms=ms)
    finite = bool(torch.isfinite(o[0]).all()) and all(
        math.isfinite(v) for r in out.values() for v in r.values())
    return {"F": F, "T": T, "blocks": blocks, "readings": out, "all_finite": finite}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="host_budget_profile")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--folds", type=int, default=128)
    p.add_argument("--block", type=int, default=1 << 17)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "host_budget_profile")
    smi = card(dev)
    print(f"card={smi} device={dev}", flush=True)
    res = profile(args.folds, args.block, args.blocks, dev, log=sys.stdout)
    print(json.dumps({"card": smi, "device": str(dev), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
