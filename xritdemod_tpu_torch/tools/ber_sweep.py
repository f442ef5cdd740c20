"""Decoded-frame BER and frame-success sweep against Es/N0.

    python -m xritdemod_tpu_torch.tools.ber_sweep [--mode lrit|hrit] [--frames N]
        [--snrs 0,1,2,3,4,6,8] [--fpb 4] [--segments -1] [--json] [--device cuda]

The port's counterpart of `tools/ber_sweep.py`, with its arguments, seed and
draw order: real CADU coded streams (the port's `tx.py`, one
`default_rng(seed)` drawn point by point), AWGN at each Es/N0, half-scale
int8 wire symbols, then `StreamDecoder` (sync, the Viterbi kernel, NRZ-M for
HRIT, derandomizer, RS).  Per Es/N0: frame success, post-FEC BER against the
sent VCDUs over the frames that claim success, and the mean Viterbi
corrections.  `--fpb` and `--segments` choose the decoder's batch and
windows per frame (`DecoderConfig.frames_per_block`, `viterbi_segments`; -1
picks the windows from the batch).  On the CPU the decoder takes the exact
plain Viterbi whatever `--segments` says.  The card's name and power limit
are printed with the result.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from xritdemod_tpu_torch.tools.timing import card, require_device


def run_sweep(mode: str, nframes: int, snrs_db, seed: int = 0,
              frames_per_block: int = 4, segments: int = -1, device="cuda"):
    """One row per Es/N0 (the JAX tool's keys)."""
    from xritdemod_tpu_torch import tx
    from xritdemod_tpu_torch.models.decoder import DecoderConfig, StreamDecoder

    rng = np.random.default_rng(seed)
    results = []
    for snr_db in snrs_db:
        # BPSK symbols at unit amplitude; AWGN sigma from Es/N0.
        sigma = float(10 ** (-snr_db / 20) / np.sqrt(2))
        vcdus = tx.make_vcdus(nframes, scid=13, vcid=5, rng=rng)
        soft = tx.encode_stream(vcdus, lrit=(mode == "lrit"), amp=1.0, noise=sigma, rng=rng)
        wire = tx.soft_to_int8(soft * 0.5)   # half scale, as the AGC's reference 0.5
        dec = StreamDecoder(DecoderConfig(
            mode=mode, frames_per_block=frames_per_block, viterbi_segments=segments,
        ), device=device)
        batches = dec.push(wire.astype(np.float32)) + dec.flush()

        def field(name, empty):
            if not batches:
                return empty
            return np.concatenate([getattr(b, name).cpu().numpy() for b in batches])

        ok = field("frame_ok", np.zeros(0, bool))
        got = field("vcdu", np.zeros((0, 892), np.uint8))
        vit = field("vit_errors", np.zeros(0))
        # post-FEC BER over the frames that claim success
        nbits = errs = 0
        for k in range(len(got)):
            if k < len(vcdus) and ok[k]:
                errs += int(np.unpackbits(got[k] ^ vcdus[k]).sum())
                nbits += 892 * 8
        results.append({
            "snr_db": float(snr_db),
            "frames_sent": nframes,
            "frames_ok": int(ok.sum()),
            "frame_success": float(ok.sum() / max(len(ok), 1)),
            "post_fec_ber": (errs / nbits) if nbits else None,
            "avg_vit_corrections": float(vit.mean()) if len(vit) else None,
        })
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ber_sweep")
    p.add_argument("--mode", default="lrit", choices=["lrit", "hrit"])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--snrs", default="0,1,2,3,4,6,8")
    p.add_argument("--json", action="store_true")
    p.add_argument("--fpb", type=int, default=4, help="decode batch width (frames per block)")
    p.add_argument("--segments", type=int, default=-1,
                   help="viterbi_segments (-1 auto, 0 one window per frame)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, "ber_sweep")
    snrs = [float(s) for s in args.snrs.split(",")]
    res = run_sweep(args.mode, args.frames, snrs, frames_per_block=args.fpb,
                    segments=args.segments, device=dev)
    smi = card(dev)
    if args.json:
        print(json.dumps({"card": smi, "device": str(dev), "mode": args.mode,
                          "frames_per_point": args.frames, "fpb": args.fpb,
                          "segments": args.segments, "points": res}))
        return 0
    print(f"# card: {smi}  device: {dev}")
    print(f"{'Es/N0 dB':>9} {'ok':>5} {'success':>8} {'post-FEC BER':>13} {'vit corr':>9}")
    for r in res:
        ber = "0" if r["post_fec_ber"] == 0 else (
            f"{r['post_fec_ber']:.2e}" if r["post_fec_ber"] else "-")
        vit = f"{r['avg_vit_corrections']:.0f}" if r["avg_vit_corrections"] else "-"
        print(f"{r['snr_db']:>9.1f} {r['frames_ok']:>5} "
              f"{r['frame_success']:>8.2f} {ber:>13} {vit:>9}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
