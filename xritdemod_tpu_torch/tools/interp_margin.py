"""The demod layer's lock and decode margin for each clock interpolator.

    python -m xritdemod_tpu_torch.tools.interp_margin [--sigmas 0.05,0.30,...]
        [--channels 128] [--blocks 4] [--json OUT] [--device cuda]

The port's counterpart of `tools/interp_margin.py`, with its arguments,
seeds and keys.  `ber_sweep` enters at the soft-symbol layer; this sweeps
noise at the raw IQ layer through the whole fused receive
(`FusedReceiver.step_int8`: the front end, the clock, the symbol ring, the
decoder) for both interpolators, the tabulated MMSE taps ("mmse", the
default) and the windowed sinc at the exact mu ("sinc"), and counts the
frames each channel recovers against what was sent.  Per (interpolator,
sigma): one clean coded LRIT capture (seed 23, `--blocks` blocks of 2^17
samples at 1.25 Msps), C independent AWGN draws of it as the channels (seed
77 anew at every point), on the int8 wire, then two blocks of zeros to
flush.  A channel counts as full when it recovers all but at most two of
the capture's frames (the pull-in at a cold start).

Gate (the JAX tool's own): at every sigma the full channels of the two
interpolators agree within max(4, C/10); the tool exits non-zero otherwise.
The noise is drawn on the host with numpy, as the JAX tool draws it (once a
sigma: both interpolators get the same draws, as in the JAX tool, which
draws them again), so each row gives the host's seconds (`host_s`: the
draws and the int8 quantisation) apart from the receiver's (`step_s`: the
copy to the card, the steps and the frames' copies back); `wall_s` is
their sum.  The card's name and power limit
are printed with the result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from xritdemod_tpu_torch.tools.timing import card, require_device

BLOCK_LEN = 1 << 17
SCID, VCID = 13, 5


def make_capture(blocks: int, block_len: int = BLOCK_LEN, cfg=None):
    """-> (clean `(blocks * block_len,)` complex64 capture, its frame count,
    the sent frames `{(vcid, counter): vcdu bytes}`, its signal power)."""
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.demodulator import DemodConfig

    cfg = cfg or DemodConfig.lrit(sample_rate=1_250_000)
    total = blocks * block_len
    nframes = int(total / cfg.sps) // 16384 - 1
    rng = np.random.default_rng(23)
    vcdus = tx.make_vcdus(nframes, scid=SCID, vcid=VCID, rng=rng)
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=rng)
    clean = tx.modulate(symbols, cfg, rng, freq_offset=1e-4, clock_ppm=30.0, noise=0.0)
    clean = np.concatenate(
        [clean, np.zeros(max(0, total - len(clean)), np.complex64)])[:total]
    ps = float(np.mean(np.abs(clean[np.abs(clean) > 0]) ** 2))
    want = {(VCID, i): bytes(vcdus[i]) for i in range(nframes)}
    return clean, nframes, want, ps


def noisy_block(clean, b: int, blocks: int, block_len: int, channels: int, sigma: float,
                rng) -> np.ndarray:
    """Block `b` of the point as the JAX tool draws it, on the int8 wire
    `(C, 2T)`: the clean block tiled over the channels plus complex AWGN,
    or zeros past the capture's end (the flush)."""
    from xritdemod_tpu_torch.utils.cplx import quantize_iq_s8

    C, T = channels, block_len
    if b < blocks:
        x = np.tile(clean[b * T:(b + 1) * T], (C, 1))
        x = x + sigma * (rng.standard_normal((C, T))
                         + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    else:
        x = np.zeros((C, T), np.complex64)
    return quantize_iq_s8(x).reshape(C, 2 * T)


def draw_blocks(clean, sigma: float, blocks: int, block_len: int, channels: int) -> list:
    """The point's `blocks` noisy int8 blocks and two of zeros, drawn as the
    JAX tool draws them (seed 77 anew at every point).  Both interpolators
    get the same draws at a sigma, so the sweep draws them once."""
    rng_n = np.random.default_rng(77)
    return [noisy_block(clean, b, blocks, block_len, channels, sigma, rng_n)
            for b in range(blocks + 2)]


def run_point(rx, wire_blocks, want: dict):
    """One (receiver, sigma) point: its int8 blocks through `rx.step_int8`;
    -> (per channel the set of `(vcid, counter)` recovered bit-exact,
    receiver seconds: the copies to the card, the steps and the frames'
    copies back)."""
    C = rx.channels
    st = rx.init_state()
    per_ch: list[set] = [set() for _ in range(C)]
    t0 = time.perf_counter()
    for q in wire_blocks:
        batch, ok, _, st = rx.step_int8(torch.from_numpy(q).to(rx.device), st)
        fok = (batch.frame_ok & ok).cpu().numpy()
        vcid, ctr, vc = (batch.vcid.cpu().numpy(), batch.counter.cpu().numpy(),
                         batch.vcdu.cpu().numpy())
        for c, j in zip(*np.nonzero(fok)):
            key = (int(vcid[c, j]), int(ctr[c, j]))
            if want.get(key) == bytes(vc[c, j]):
                per_ch[c].add(key)
    return per_ch, time.perf_counter() - t0


def sweep(sigmas, channels: int = 128, blocks: int = 4, block_len: int = BLOCK_LEN,
          device="cuda", log=None) -> dict:
    """Every (interpolator, sigma) point, rows in the JAX tool's order;
    -> {"capture_frames", "points"}."""
    from xritdemod_tpu_torch.models.decoder import DecoderConfig
    from xritdemod_tpu_torch.models.demodulator import DemodConfig
    from xritdemod_tpu_torch.models.receiver import FusedReceiver

    clean, nframes, want, ps = make_capture(blocks, block_len)
    C = channels
    interps = ("mmse", "sinc")
    rxs = {interp: FusedReceiver(DemodConfig.lrit(sample_rate=1_250_000, clock_interp=interp),
                                 DecoderConfig(mode="lrit"), channels=C, block_len=block_len,
                                 device=device)
           for interp in interps}
    rows = {}
    for sigma in sigmas:
        t0 = time.perf_counter()
        wire_blocks = draw_blocks(clean, sigma, blocks, block_len, C)
        host_s = time.perf_counter() - t0
        for interp in interps:
            t1 = time.perf_counter()
            per_ch, step_s = run_point(rxs[interp], wire_blocks, want)
            counts = np.asarray([len(s) for s in per_ch])
            # A channel at full margin recovers all but the pull-in frame(s).
            full = int(np.sum(counts >= nframes - 2))
            esn0 = 10.0 * np.log10(ps / (2.0 * sigma * sigma)) if sigma else None
            row = rows[interp, sigma] = {
                "interp": interp,
                "sigma": sigma,
                "esn0_db": round(esn0, 2) if esn0 is not None else None,
                "channels_full": full,
                "channels": C,
                "frames_recovered": int(counts.sum()),
                "frames_possible": C * nframes,
                "frame_rate": round(float(counts.sum()) / (C * nframes), 4),
                "wall_s": round(time.perf_counter() - t1 + host_s, 1),
                "host_s": round(host_s, 2),
                "step_s": round(step_s, 2),
            }
            if log is not None:
                print(json.dumps(row), file=log, flush=True)
    return {"capture_frames": nframes,
            "points": [rows[i, s] for i in interps for s in sigmas]}


def margin_failures(points, channels: int) -> list:
    """The JAX tool's gate: the sigmas where the full channels of the two
    interpolators differ by more than max(4, C/10)."""
    by_sigma: dict = {}
    for r in points:
        by_sigma.setdefault(r["sigma"], {})[r["interp"]] = r["channels_full"]
    return [(s, d) for s, d in by_sigma.items()
            if abs(d["mmse"] - d["sinc"]) > max(4, 0.1 * channels)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="interp_margin")
    p.add_argument("--json", default=None)
    p.add_argument("--sigmas", default="0.05,0.30,0.40,0.50,0.60,0.70")
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "interp_margin")
    smi = card(dev)
    print(f"card={smi} device={dev} capture={args.blocks * BLOCK_LEN} samples", flush=True)
    out = sweep([float(s) for s in args.sigmas.split(",")], args.channels, args.blocks,
                device=dev, log=sys.stdout)
    out = {"card": smi, "device": str(dev), **out}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    bad = margin_failures(out["points"], args.channels)
    if bad:
        raise SystemExit(f"interp_margin: the interpolators' full channels differ: {bad}")
    print("MARGIN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
