"""Long-capture soak: minutes of LRIT (or HRIT) with carrier and symbol-clock
drift through `FoldedCaptureReceiver`, every transmitted frame accounted for.

    python -m xritdemod_tpu_torch.tools.long_soak [seconds] [--folds 128]
        [--clock-ppm 100] [--freq-drift 2e-5] [--clock-interp mmse|sinc]
        [--mode lrit|hrit] [--wire s8|f32] [--json OUT] [--device cuda]

The port's counterpart of `tools/long_soak_tpu.py`, with the same flags and
capture: sinusoidal carrier drift (the Costas loop must track it),
sinusoidal symbol-clock drift (M&M omega must track it) and AWGN, made by
the port's `tx.modulate` from seed 11, then reprocessed fold-parallel (the
fused receive at C = folds on the card; `step_int8` on the s8 wire).  The
JSON names the card (`nvidia-smi` name and power limit) where the reference
names its backend.  Exits non-zero on a corrupted payload, on a frame that
was neither sent nor the exact complement of a sent one (a cold-start
acquisition at a fold head, ROADMAP §C), or on more than two lost frames
(the reference tool's allowance).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.tools.timing import card
from xritdemod_tpu_torch.utils.cplx import quantize_iq_s8

SCID, VCID = 13, 5


def soak_config(mode: str = "lrit", clock_interp: str = "mmse") -> DemodConfig:
    """LRIT at 1.25 Msps or HRIT at 3 Msps (the reference's Parameters.h)."""
    if mode == "hrit":
        return DemodConfig.hrit(sample_rate=3_000_000, clock_interp=clock_interp)
    return DemodConfig.lrit(sample_rate=1_250_000, clock_interp=clock_interp)


def make_capture(seconds: float, mode: str = "lrit", clock_ppm: float = 100.0,
                 freq_drift: float = 2e-5, clock_interp: str = "mmse", wire: str = "s8"):
    """-> (config, capture: `(2N,)` int8 on the s8 wire or `(N,)` complex64,
    the transmitted VCDUs `(frames, 892)` uint8)."""
    cfg = soak_config(mode, clock_interp)
    nframes = int(seconds * cfg.symbol_rate) // 16384 - 1
    rng = np.random.default_rng(11)
    vcdus = tx.make_vcdus(nframes, scid=SCID, vcid=VCID, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=mode == "lrit", amp=1.0, rng=rng)
    sig = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, clock_ppm=clock_ppm,
                      freq_drift=freq_drift, noise=0.02)
    return cfg, (quantize_iq_s8(sig) if wire == "s8" else sig), vcdus


def write_capture(path: str, seconds: float, mode: str = "lrit", **kw) -> np.ndarray:
    """`make_capture` into a file (raw samples, as `cli reprocess` reads
    them); returns the transmitted VCDUs."""
    _, capture, vcdus = make_capture(seconds, mode, **kw)
    capture.tofile(path)
    return vcdus


def account(frames, vcdus, vcid: int = VCID) -> dict:
    """Hold `(scid, vcid, counter, vcdu)` frames against the transmitted
    VCDUs (counters 0..n-1 on `vcid`)."""
    sent = {(vcid, i): bytes(v) for i, v in enumerate(vcdus)}
    complement = {bytes(255 - v) for v in vcdus}
    keys = [(v, c) for _, v, c, _ in frames]
    on_vcid = [c for v, c in keys if v == vcid]
    exact = {(v, c) for _, v, c, b in frames if sent.get((v, c)) == b}
    comp = sum(1 for _, v, c, b in frames if (v, c) not in sent and b in complement)
    wrong = sum(1 for _, v, c, b in frames if (v, c) in sent and sent[(v, c)] != b)
    odd = [(s, v, c) for s, v, c, b in frames if (v, c) not in sent and b not in complement]
    return dict(
        frames_sent=len(vcdus), frames_recovered=len(exact),
        frames_missing=len(set(sent) - set(keys)),
        missing_counters=sorted(c for _, c in set(sent) - set(keys))[:16],
        payload_mismatches=wrong, complements=comp,
        unexplained=len(odd), unexplained_frames=odd[:4],
        duplicates=len(keys) - len(set(keys)),
        counters_ascending=on_vcid == sorted(on_vcid),
    )


def run(cfg: DemodConfig, capture: np.ndarray, vcdus, folds: int = 128,
        block_len: int = 1 << 17, clock_ppm: float = 100.0, device: str = "cuda") -> dict:
    """The capture through `FoldedCaptureReceiver` (warmed up first):
    the accounting, wall and warm-up seconds, times real time and the
    receiver's `last_timings`; also the frames and the receiver itself."""
    from xritdemod_tpu_torch.parallel.timeblocks import FoldedCaptureReceiver

    wire = "s8" if capture.dtype == np.int8 else "f32"
    nsamples = len(capture) // 2 if wire == "s8" else len(capture)
    rx = FoldedCaptureReceiver(cfg, folds=folds, block_len=block_len,
                               max_clock_ppm=clock_ppm, device=device)
    t_warm = rx.warm_jit(wire)
    t0 = time.perf_counter()
    out = rx.process(capture)
    t_rx = time.perf_counter() - t0
    return dict(
        samples=nsamples, wire=wire, folds=folds, block_len=block_len,
        **account(out, vcdus),
        rx_wall_s=t_rx, jit_warmup_s=t_warm,
        # Wall excludes the warm-up; includes all host work (fold assembly,
        # host->device copies, the device, the stacked copies back).
        x_realtime_incl_host=nsamples / cfg.sample_rate / t_rx,
        timings=rx.last_timings, frames=out, receiver=rx,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="long_soak")
    p.add_argument("seconds", nargs="?", type=float, default=60.0)
    p.add_argument("--json", default=None)
    p.add_argument("--folds", type=int, default=128)
    p.add_argument("--clock-ppm", type=float, default=100.0)
    p.add_argument("--freq-drift", type=float, default=2e-5)
    p.add_argument("--clock-interp", choices=("sinc", "mmse"), default="mmse",
                   help="M&M fractional interpolator (DemodConfig.clock_interp)")
    p.add_argument("--mode", choices=("lrit", "hrit"), default="lrit",
                   help="operating point: LRIT 1.25 Msps / HRIT 3 Msps")
    p.add_argument("--wire", choices=("s8", "f32"), default="s8",
                   help="host->device sample format: s8 = interleaved int8 IQ "
                   "(a quarter of the bytes, dequantized on the device), f32 = complex64")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(f"long_soak: --device {args.device} but no CUDA device")
    t0 = time.perf_counter()
    cfg, capture, vcdus = make_capture(args.seconds, args.mode, args.clock_ppm,
                                       args.freq_drift, args.clock_interp, args.wire)
    print(f"capture {args.seconds:.0f}s ({len(vcdus)} frames) synthesised in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    res = run(cfg, capture, vcdus, args.folds, clock_ppm=args.clock_ppm, device=args.device)
    res.pop("frames")
    res.pop("receiver")
    result = dict(mode=args.mode, seconds=args.seconds, clock_ppm=args.clock_ppm,
                  freq_drift=args.freq_drift, clock_interp=args.clock_interp,
                  card=card(args.device), device=args.device, **res)
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    if res["payload_mismatches"] or res["unexplained"]:
        raise SystemExit(f"long_soak: corrupted or unexplained frames: {result}")
    if res["frames_missing"] > 2:
        raise SystemExit(f"long_soak: {res['frames_missing']} frames lost")
    print("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
